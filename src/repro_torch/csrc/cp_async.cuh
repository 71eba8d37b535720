// Asynchronous global -> shared copies (cp.async), shared by the kernels
// that stage key/value rows into a ring of shared-memory tiles
// (paged_prefill.cu, flash_attention.cu, decode_attention.cu).
#pragma once

#include <cstdint>

#include "common.cuh"

namespace rt {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One cp.async of V bytes (16, 8 or 4); valid = false zero-fills the
// destination and reads nothing.
template <int V>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const uint32_t d = smem_u32(dst);
  const int n = valid ? V : 0;
  if constexpr (V == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src), "n"(V),
                 "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The widest copy (16, 8 or 4 bytes) that `addr_bits` (the OR of every
// row start's byte address and byte stride) and the row's byte length
// allow, or 0 for element copies.
inline int vec_width(unsigned long long addr_bits, long long row_bytes) {
  const unsigned long long g = addr_bits | static_cast<unsigned long long>(row_bytes);
  return g % 16 == 0 ? 16 : g % 8 == 0 ? 8 : g % 4 == 0 ? 4 : 0;
}

}  // namespace rt
