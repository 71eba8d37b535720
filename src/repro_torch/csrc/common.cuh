// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every kernel takes float32 or bfloat16 storage and computes in float32.
// The C entry points take a dtype code (RT_F32 / RT_BF16), launch on the
// caller's stream, allocate nothing, and return cudaGetLastError() so the
// Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

enum { RT_F32 = 0, RT_BF16 = 1 };
// Storage codes of the paged pools: kv_dtype RT_UNQUANTIZED for a pool in
// q's dtype, RT_I8 / RT_E4M3 for quantized ones (int8 / fp8).
enum { RT_UNQUANTIZED = -1, RT_I8 = 0, RT_E4M3 = 1 };

namespace rt {

// Masked score, as in the Pallas kernels (flash_attention.py / decode_attention.py
// NEG_INF): finite, so exp(m_prev - m_cur) stays 1 on fully masked tiles.
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Four consecutive elements of T in shared memory (16-byte aligned for
// float, 8 for bfloat16), widened to fp32 in one load.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);  // element 0 in the low half
  return make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
}

// Two consecutive elements (8-byte aligned for float, 4 for bfloat16).
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  const unsigned raw = *reinterpret_cast<const unsigned*>(p);
  return make_float2(__uint_as_float(raw << 16), __uint_as_float(raw & 0xffff0000u));
}

// N consecutive elements (N 1, 2 or a multiple of 4; aligned to N
// elements up to 16 bytes) widened into out[0 .. N).
template <int N, typename T>
__device__ __forceinline__ void load_n(const T* p, float (&out)[N]) {
  if constexpr (N == 1) {
    out[0] = to_f(*p);
  } else if constexpr (N == 2) {
    const float2 f = load2(p);
    out[0] = f.x, out[1] = f.y;
  } else {
#pragma unroll
    for (int q = 0; q < N; q += 4) {
      const float4 f = load4(p + q);
      out[q] = f.x, out[q + 1] = f.y, out[q + 2] = f.z, out[q + 3] = f.w;
    }
  }
}

// 2^x on the special-function unit (ftz: 0 below 2^-126).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum each of V values over the N lanes of a group (N a power of two up to
// 32; the groups aligned runs of adjacent lanes), scattering while a lane
// holds more than one: at offset O = 1, 2, 4, ... a lane keeps half of its
// values (the upper half when bit O of `lane`, its place in the group, is
// set) and adds its partner's copy of that half; once one value is left,
// it adds its partner's. Each value's sum is the balanced xor tree over
// the N lanes (offsets 1, 2, 4, ...), whichever lane ends with it: 16
// values over 16 lanes take 15 shuffles where an all-reduce takes 64, in
// chains 4 long, with no branch. Call with first = 0. On return the lane
// holds the sums of values first .. first + max(1, V / N) - 1 in v[0 ..];
// lanes with lane >= V hold copies of other lanes'.
template <int N, int V, int C = V, int O = 1>
__device__ __forceinline__ void scatter_sum(float (&v)[V], int lane, int& first) {
  if constexpr (O < N) {
    if constexpr (C > 1) {
      constexpr int H = C / 2;
      const bool hi = lane & O;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = hi ? v[i] : v[i + H];
        const float keep = hi ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      first += hi ? H : 0;
      scatter_sum<N, V, H, O * 2>(v, lane, first);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      scatter_sum<N, V, 1, O * 2>(v, lane, first);
    }
  }
}

// Row stride of a (rows, dh) float tile in shared memory: odd, so the 32
// lanes of a warp that each read a different row at the same column hit 32
// different banks.
__host__ __device__ __forceinline__ int tile_ld(int dh) { return dh | 1; }

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace rt
