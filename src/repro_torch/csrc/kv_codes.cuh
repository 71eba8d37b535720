// The quantized paged pools' 1-byte codes (int8 or e4m3, with one f32 scale
// per (block, KV head): kernels/kv_quant.py) as numbers, for the kernels
// that stage them raw and decode them on chip (paged_prefill.cu,
// decode_attention.cu). Every decode here is exact for both formats.
#pragma once

#include <cuda_fp8.h>

#include <cstdint>
#include <type_traits>

#include "register_tiles.cuh"

namespace rt {

// A pool element as raw bits, for copies that must not round.
template <typename KV>
using Bits = typename std::conditional<
    sizeof(KV) == 1, uint8_t,
    typename std::conditional<sizeof(KV) == 2, uint16_t, uint32_t>::type>::type;

// Four 1-byte codes (the low byte first) as floats, exactly. int8: the byte
// (sign bit flipped) as the low mantissa bits of 2^23, less 2^23 + 128;
// e4m3: pairs through the hardware's e4m3x2 -> f16x2 conversion.
template <typename KV>
__device__ __forceinline__ void decode4(uint32_t w, float* f) {
  if constexpr (std::is_same<KV, int8_t>::value) {
    const uint32_t u = w ^ 0x80808080u;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      f[k] = __uint_as_float(__byte_perm(u, 0x4B00u, 0x5440u + k)) - 8388736.f;
  } else {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>(w >> (16 * k)), __NV_E4M3);
      const float2 v = __half22float2(__half2(h));
      f[2 * k] = v.x;
      f[2 * k + 1] = v.y;
    }
  }
}

// Sixteen codes as floats.
template <typename KV>
__device__ __forceinline__ void decode16(uint4 w, float (&f)[16]) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) decode4<KV>(words[q], f + 4 * q);
}

// A staged tile of 1-byte codes (row stride LR bytes) into the compute
// type (row stride LD), sixteen codes a thread at a time over NT threads:
// with SCALE each code times its key's scale in fp32 (bit for bit the plain
// version's decode), else the code itself (exact in bf16). Codes past dh
// are the zero padding.
template <int NT, bool SCALE, int BK, int DP, int LD, int LR, typename CT, typename KV>
__device__ __forceinline__ void convert(CT* dst, const KV* src, const float* sc) {
  constexpr int PER_ROW = DP / 16;
  for (int idx = threadIdx.x; idx < BK * PER_ROW; idx += NT) {
    const int j = idx / PER_ROW, d = (idx % PER_ROW) * 16;
    float f[16];
    decode16<KV>(*reinterpret_cast<const uint4*>(reinterpret_cast<const uint8_t*>(src) +
                                                  j * LR + d),
                 f);
    if constexpr (SCALE) {
      const float c = sc[j];
#pragma unroll
      for (int e = 0; e < 16; ++e) f[e] *= c;
    }
    if constexpr (std::is_same<CT, float>::value) {
      float4* o = reinterpret_cast<float4*>(dst + j * LD + d);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[e] = make_float4(f[4 * e], f[4 * e + 1], f[4 * e + 2], f[4 * e + 3]);
    } else {
      uint4* o = reinterpret_cast<uint4*>(dst + j * LD + d);
#pragma unroll
      for (int e = 0; e < 2; ++e)
        o[e] = make_uint4(pack_bf16(f[8 * e], f[8 * e + 1]), pack_bf16(f[8 * e + 2], f[8 * e + 3]),
                          pack_bf16(f[8 * e + 4], f[8 * e + 5]),
                          pack_bf16(f[8 * e + 6], f[8 * e + 7]));
    }
  }
}

}  // namespace rt
