// One online-softmax step of flash attention, for the paged decode kernels
// (paged_attention.cu), its one remaining user.
//
// `rows` query rows (a prefill q-tile, or the G query heads of one KV head
// at decode) sit in shared memory beside one BK-key tile of K and V. The
// step is the body of the Pallas kernels' inner grid step
// (flash_attention.py:_flash_kernel :58-80, decode_attention.py:_decode_kernel
// :32-46): scores, running max m, running denominator l and the fp32
// accumulator, with masked scores at NEG_INF and their probabilities forced
// to 0.
#pragma once

#include "common.cuh"

namespace rt {

constexpr int BK = 32;  // keys per tile: one lane of a warp per key

// Qs: rows x ld, Ks/Vs: BK x ld, S: rows x BK, acc: rows x dh, m/l/corr: rows.
// live(i, j): query row i may see key j of this tile. Ends with a barrier,
// so the caller may overwrite Ks/Vs for the next tile.
template <typename Live>
__device__ __forceinline__ void tile_update(const float* Qs, const float* Ks, const float* Vs,
                                            float* S, float* acc, float* m, float* l, float* corr,
                                            int rows, int dh, int ld, float scale, Live live) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  // scores: a warp covers one query row (broadcast reads of Qs) and 32 keys
  // (one odd-strided K row per lane: no bank conflicts)
  for (int idx = tid; idx < rows * BK; idx += nthr) {
    const int i = idx / BK, j = idx % BK;
    float s = NEG_INF;
    if (live(i, j)) {
      const float* qi = Qs + i * ld;
      const float* kj = Ks + j * ld;
      float dot = 0.f;
      for (int d = 0; d < dh; ++d) dot = fmaf(qi[d], kj[d], dot);
      s = dot * scale;
    }
    S[i * BK + j] = s;
  }
  __syncthreads();
  // online softmax: one warp per row, one lane per key
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthr >> 5;
  for (int i = warp; i < rows; i += nwarps) {
    const float s = S[i * BK + lane];
    const float m_prev = m[i];
    const float m_cur = fmaxf(m_prev, warp_max(s));
    const float p = live(i, lane) ? expf(s - m_cur) : 0.f;
    const float psum = warp_sum(p);
    S[i * BK + lane] = p;
    if (lane == 0) {
      const float c = expf(m_prev - m_cur);
      corr[i] = c;
      l[i] = l[i] * c + psum;
      m[i] = m_cur;
    }
  }
  __syncthreads();
  // acc = acc * corr + P @ V: consecutive threads own consecutive columns
  for (int idx = tid; idx < rows * dh; idx += nthr) {
    const int i = idx / dh, d = idx % dh;
    const float* pi = S + i * BK;
    float a = acc[idx] * corr[i];
    for (int j = 0; j < BK; ++j) a = fmaf(pi[j], Vs[j * ld + d], a);
    acc[idx] = a;
  }
  __syncthreads();
}

// Shared-memory floats for `rows` query rows against one BK tile.
__host__ __device__ __forceinline__ size_t tile_smem_floats(int rows, int dh) {
  const int ld = tile_ld(dh);
  return static_cast<size_t>(rows) * ld + 2 * static_cast<size_t>(BK) * ld +
         static_cast<size_t>(rows) * BK + static_cast<size_t>(rows) * dh + 3 * rows;
}

}  // namespace rt
