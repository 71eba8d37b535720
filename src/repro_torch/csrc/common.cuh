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
