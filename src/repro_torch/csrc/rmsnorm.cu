// Fused RMSNorm: y = x * rsqrt(mean(x^2) + eps) * scale, fp32 reduction.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py
// (_rmsnorm_kernel :17, pallas_call :36). The TPU kernel tiled rows into
// VMEM; here the row lives in registers between the sum of squares and the
// write, so x is read from device memory once.
//
// Geometry (chosen by kernels/rmsnorm.py: launch_geometry, the one place it
// is decided): WPR warps own a row (one wherever the row fits 32 elements a
// lane; with fewer rows than SMs, as at decode, 8 a lane, so that one
// row's chain is short), RPB rows go to a block (threadIdx.y), and the
// blocks walk the row groups in a grid-stride loop. Each lane holds NV packs of VEC
// elements of its row: pack j*32*WPR + (lane of the row) — 16-byte vectors
// (4 fp32 or 8 bf16) when x, y and the scale are aligned and VEC divides D,
// single elements otherwise (the element path, any D). The lane's packs of
// the scale are loaded once, in vectors of up to 16 bytes, and stay in
// registers for every row the block takes. One warp a row reduces with
// shuffles alone; several warps add their sums through shared memory
// behind one barrier (double-buffered by the loop's parity, so one barrier
// an iteration suffices). NV == 0 is the rare row wider than a block's
// registers (more than 16 warps of 64 elements, 32 on the element path):
// it streams the row twice, the second read from L2.
//
// Arithmetic as the Pallas kernel: each x widened to fp32, the sum of
// squares by fmaf, rsqrtf(sum / D + eps), then (x * r) * scale, the scale
// widened from its own dtype (float32, or bfloat16 for bfloat16
// parameters).
//
// What bounds it: two FLOPs per element against the element's read and
// write, so bytes — one read of x and one write of y. At decode widths (a
// few rows) it is bound by launch cost and one load round trip.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int MAX_THREADS = 512;  // 16 warps a block

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC > 16 ? 16 : sizeof(T) * VEC) Pack {
  T v[VEC];
};

// A pack moved as raw 16-, 8- or 4-byte words, so a bf16 pack is one
// vector load or store and not VEC element copies.
template <typename T, int VEC>
__device__ __forceinline__ void copy_pack(Pack<T, VEC>& dst, const Pack<T, VEC>& src) {
  constexpr int B = sizeof(Pack<T, VEC>);
  if constexpr (B % 16 == 0) {
#pragma unroll
    for (int i = 0; i < B / 16; ++i)
      reinterpret_cast<uint4*>(&dst)[i] = reinterpret_cast<const uint4*>(&src)[i];
  } else if constexpr (B == 8) {
    *reinterpret_cast<uint2*>(&dst) = *reinterpret_cast<const uint2*>(&src);
  } else if constexpr (B == 4) {
    *reinterpret_cast<unsigned*>(&dst) = *reinterpret_cast<const unsigned*>(&src);
  } else {
    dst = src;
  }
}

template <typename T, typename S, int VEC, int NV>
__global__ void __launch_bounds__(MAX_THREADS)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ y,
               long long rows, int D, float eps) {
  __shared__ float red[2][MAX_THREADS / 32];  // [parity][warp of the block]
  const int wpr = blockDim.x >> 5;              // warps a row
  const int lane_r = threadIdx.x;               // the thread's place in its row
  const int row_threads = blockDim.x;
  const int npack = D / VEC;
  const long long groups = (rows + blockDim.y - 1) / blockDim.y;

  Pack<S, VEC> sc[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int p = j * row_threads + lane_r;
    if (p < npack) copy_pack(sc[j], reinterpret_cast<const Pack<S, VEC>*>(scale)[p]);
  }

  int parity = 0;
  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
    const long long row = g * blockDim.y + threadIdx.y;
    const bool live = row < rows;
    const Pack<T, VEC>* xr = reinterpret_cast<const Pack<T, VEC>*>(x + row * D);
    Pack<T, VEC>* yr = reinterpret_cast<Pack<T, VEC>*>(y + row * D);

    Pack<T, VEC> v[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int p = j * row_threads + lane_r;
      if (live && p < npack) copy_pack(v[j], xr[p]);
    }
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int p = j * row_threads + lane_r;
      if (live && p < npack) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float f = rt::to_f(v[j].v[e]);
          ss = fmaf(f, f, ss);
        }
      }
    }
    ss = rt::warp_sum(ss);
    if (wpr > 1) {  // uniform over the block: every thread reaches the barrier
      float* r = red[parity] + threadIdx.y * wpr;
      if ((lane_r & 31) == 0) r[lane_r >> 5] = ss;
      __syncthreads();
      ss = 0.f;
      for (int w = 0; w < wpr; ++w) ss += r[w];
      parity ^= 1;
    }
    const float inv = rsqrtf(ss / D + eps);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int p = j * row_threads + lane_r;
      if (live && p < npack) {
        Pack<T, VEC> out;
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          out.v[e] = rt::from_f<T>(rt::to_f(v[j].v[e]) * inv * rt::to_f(sc[j].v[e]));
        copy_pack(yr[p], out);
      }
    }
  }
}

// NV == 0: a row wider than the block's registers, read twice (the second
// time from L2), one row a block.
template <typename T, typename S>
__global__ void __launch_bounds__(MAX_THREADS)
rmsnorm_stream_kernel(const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ y,
                      long long rows, int D, float eps) {
  __shared__ float red[2][MAX_THREADS / 32];
  const int nw = blockDim.x >> 5;
  int parity = 0;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * D;
    T* yr = y + row * D;
    float ss = 0.f;
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      const float f = rt::to_f(xr[c]);
      ss = fmaf(f, f, ss);
    }
    ss = rt::warp_sum(ss);
    if ((threadIdx.x & 31) == 0) red[parity][threadIdx.x >> 5] = ss;
    __syncthreads();
    ss = 0.f;
    for (int w = 0; w < nw; ++w) ss += red[parity][w];
    parity ^= 1;
    const float inv = rsqrtf(ss / D + eps);
    for (int c = threadIdx.x; c < D; c += blockDim.x)
      yr[c] = rt::from_f<T>(rt::to_f(xr[c]) * inv * rt::to_f(scale[c]));
  }
}

template <typename T, typename S, int VEC, int NV, int MAX_NV>
void* pick_nv(int nv) {
  if constexpr (NV > MAX_NV) {
    return nullptr;
  } else {
    if (nv == NV) return reinterpret_cast<void*>(rmsnorm_kernel<T, S, VEC, NV>);
    return pick_nv<T, S, VEC, NV * 2, MAX_NV>(nv);
  }
}

// The kernel for (T, S, vec, nv), or null for a combination the geometry
// never gives: nv a power of two up to 32 elements a lane on the element
// path (vec 1), 64 on the vector path; nv 0 the streaming kernel.
template <typename T, typename S>
void* pick(int vec, int nv) {
  constexpr int V = 16 / sizeof(T);
  if (nv == 0) return reinterpret_cast<void*>(rmsnorm_stream_kernel<T, S>);
  if (vec == 1) return pick_nv<T, S, 1, 1, 32>(nv);
  if (vec == V) return pick_nv<T, S, V, 1, 64 / V>(nv);
  return nullptr;
}

void* kernel_for(int dtype, int scale_dtype, int vec, int nv) {
  if (dtype == RT_F32 && scale_dtype == RT_F32) return pick<float, float>(vec, nv);
  if (dtype == RT_F32 && scale_dtype == RT_BF16) return pick<float, __nv_bfloat16>(vec, nv);
  if (dtype == RT_BF16 && scale_dtype == RT_F32) return pick<__nv_bfloat16, float>(vec, nv);
  if (dtype == RT_BF16 && scale_dtype == RT_BF16)
    return pick<__nv_bfloat16, __nv_bfloat16>(vec, nv);
  return nullptr;
}

int elem_size(int dtype) { return dtype == RT_F32 ? 4 : 2; }

}  // namespace

// x, y (rows, D) contiguous in the same dtype; scale (D,) float32 or
// bfloat16, whatever x's dtype. vec, nv, wpr, rpb and grid come from
// kernels/rmsnorm.py's launch_geometry: vec elements a pack (16 bytes'
// worth, or 1), nv packs a lane (0: the streaming kernel), wpr warps a row,
// rpb rows a block, grid blocks.
extern "C" int rt_rmsnorm(const void* x, const void* scale, void* y, long long rows, int D,
                          float eps, int dtype, int scale_dtype, int vec, int nv, int wpr,
                          int rpb, int grid, void* stream) {
  if (D < 1 || rows < 0 || wpr < 1 || rpb < 1 || grid < 1 || wpr * rpb * 32 > MAX_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  void* k = kernel_for(dtype, scale_dtype, vec, nv);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (nv > 0) {
    const long long cover = static_cast<long long>(nv) * vec * 32 * wpr;
    const int ssize = elem_size(scale_dtype) * vec;
    const uintptr_t need = vec == 1 ? 1 : 16;
    const bool aligned = D % vec == 0 && reinterpret_cast<uintptr_t>(x) % need == 0 &&
                         reinterpret_cast<uintptr_t>(y) % need == 0 &&
                         reinterpret_cast<uintptr_t>(scale) % (ssize > 16 ? 16 : ssize) == 0;
    if (!aligned || cover < D) return static_cast<int>(cudaErrorInvalidValue);
  } else if (rpb != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 block(32 * wpr, rpb);
  void* args[] = {static_cast<void*>(&x), static_cast<void*>(&scale), static_cast<void*>(&y),
                  static_cast<void*>(&rows), static_cast<void*>(&D), static_cast<void*>(&eps)};
  const cudaError_t err = cudaLaunchKernel(k, dim3(grid), block, args, 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many blocks of `threads` threads of the (dtype, scale dtype, vec, nv)
// instantiation fit on one SM (for the build log).
extern "C" int rt_rmsnorm_info(int dtype, int scale_dtype, int vec, int nv, int threads,
                               int* blocks_per_sm) {
  void* k = kernel_for(dtype, scale_dtype, vec, nv);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, k, threads, 0));
}
