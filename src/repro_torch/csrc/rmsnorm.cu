// Fused RMSNorm: y = x * rsqrt(mean(x^2) + eps) * scale, fp32 reduction.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py
// (_rmsnorm_kernel :17, pallas_call :36). The TPU kernel tiled rows into
// VMEM; here one block owns one row. Each thread reads 16-byte vectors
// (4 fp32 or 8 bf16 values) when the row allows it, the sum of squares is
// reduced with warp shuffles and one shared-memory pass, and the row is
// read a second time (from L1/L2, where the first pass left it) to write
// the normalised output once. The scale is read in its own dtype (float32,
// or bfloat16 for bfloat16 parameters) and widened in registers, as the
// Pallas kernel's .astype(float32).
//
// What bounds it: two FLOPs per element against the element's read and
// write, so it is bound by bytes — one read of x and one write of y is the
// minimum, and the single-block-per-row design moves exactly that through
// device memory. At decode widths (a few rows) it is bound by launch cost.
#include <cstdint>

#include "common.cuh"

namespace {

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, typename S, int VEC>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                               T* __restrict__ y, int D, float eps) {
  __shared__ float partial[32];
  __shared__ float inv_rms;
  const long long row = blockIdx.x;
  const Pack<T, VEC>* xr = reinterpret_cast<const Pack<T, VEC>*>(x + row * D);
  Pack<T, VEC>* yr = reinterpret_cast<Pack<T, VEC>*>(y + row * D);
  const int npack = D / VEC;

  float ss = 0.f;
  for (int c = threadIdx.x; c < npack; c += blockDim.x) {
    const Pack<T, VEC> p = xr[c];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float f = rt::to_f(p.v[e]);
      ss = fmaf(f, f, ss);
    }
  }
  ss = rt::warp_sum(ss);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    float t = lane < nwarps ? partial[lane] : 0.f;
    t = rt::warp_sum(t);
    if (lane == 0) inv_rms = rsqrtf(t / D + eps);
  }
  __syncthreads();
  const float r = inv_rms;

  for (int c = threadIdx.x; c < npack; c += blockDim.x) {
    const Pack<T, VEC> p = xr[c];
    Pack<T, VEC> out;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      out.v[e] = rt::from_f<T>(rt::to_f(p.v[e]) * r * rt::to_f(scale[c * VEC + e]));
    yr[c] = out;
  }
}

template <typename T, typename S, int VEC>
int launch(const void* x, const void* scale, void* y, int rows, int D, float eps,
           cudaStream_t stream) {
  int threads = ((D / VEC + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  rmsnorm_kernel<T, S, VEC><<<rows, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<T*>(y), D, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename S>
int dispatch(const void* x, const void* scale, void* y, int rows, int D, float eps,
             cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (aligned && D % VEC == 0) return launch<T, S, VEC>(x, scale, y, rows, D, eps, stream);
  return launch<T, S, 1>(x, scale, y, rows, D, eps, stream);
}

template <typename T>
int dispatch_scale(const void* x, const void* scale, void* y, int rows, int D, float eps,
                   int scale_dtype, cudaStream_t stream) {
  if (scale_dtype == RT_F32) return dispatch<T, float>(x, scale, y, rows, D, eps, stream);
  if (scale_dtype == RT_BF16)
    return dispatch<T, __nv_bfloat16>(x, scale, y, rows, D, eps, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x, y (rows, D) contiguous in the same dtype; scale (D,) float32 or
// bfloat16, whatever x's dtype.
extern "C" int rt_rmsnorm(const void* x, const void* scale, void* y, int rows, int D, float eps,
                          int dtype, int scale_dtype, void* stream) {
  if (D < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == RT_F32) return dispatch_scale<float>(x, scale, y, rows, D, eps, scale_dtype, s);
  if (dtype == RT_BF16)
    return dispatch_scale<__nv_bfloat16>(x, scale, y, rows, D, eps, scale_dtype, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
