// Asynchronous global -> shared copies (cp.async), shared by the kernels
// that stage key/value rows into a ring of shared-memory tiles
// (paged_prefill.cu, flash_attention.cu, decode_attention.cu) and by the
// scans, which stage runs of tokens (rwkv_scan.cu, mamba_scan.cu).
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

// Stage `rows` rows of `len` elements of T into shared memory at `dst`
// (row stride `ld` elements): row t is read from src + t * stride, and its
// elements from `valid` on are zero-filled. All `nthreads` threads of the
// block take part, `vbytes` bytes a copy: cp.async of 16, 8 or 4 bytes
// (src, `stride` and `valid` aligned to it, `len` and `ld` whole copies),
// or with vbytes 0 element by element through registers, for rows no
// copy width divides. `len` is a power of two. The caller commits and
// waits.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src, long long stride,
                                           int rows, int len, int valid, int vbytes, int tid,
                                           int nthreads) {
  const int ve = vbytes == 0 ? 1 : vbytes / static_cast<int>(sizeof(T));
  const int per = len / ve, sh = __ffs(per) - 1;  // copies a row, a power of two
  for (int e = tid; e < rows * per; e += nthreads) {
    const int t = e >> sh, c = (e & (per - 1)) * ve;
    const bool ok = c < valid;
    const T* s = ok ? src + t * stride + c : src;
    T* d = dst + t * ld + c;
    if (vbytes == 16)
      cp_async<16>(d, s, ok);
    else if (vbytes == 8)
      cp_async<8>(d, s, ok);
    else if (vbytes == 4)
      cp_async<4>(d, s, ok);
    else
      *d = ok ? *s : from_f<T>(0.f);
  }
}

// The widest copy (16, 8 or 4 bytes) that `addr_bits` (the OR of every
// row start's byte address and byte stride) and the row's byte length
// allow, or 0 for element copies.
inline int vec_width(unsigned long long addr_bits, long long row_bytes) {
  const unsigned long long g = addr_bits | static_cast<unsigned long long>(row_bytes);
  return g % 16 == 0 ? 16 : g % 8 == 0 ? 8 : g % 4 == 0 ? 4 : 0;
}

}  // namespace rt
