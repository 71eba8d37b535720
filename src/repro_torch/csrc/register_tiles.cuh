// Register-resident attention tiles for Hopper: one online-softmax step of
// a 64-row query block against a key tile staged in shared memory, with
// the scores S and the output accumulator O held in registers.
//
// The paged prefill kernel (paged_prefill.cu) runs them over keys staged
// through a block table, the flash kernel (flash_attention.cu) over a
// contiguous K/V; they know nothing of either. A block has four warps;
// warp w owns query rows 16w..16w+15 of the block's 64 and computes their
// S, softmax and O alone, so the only barriers are the caller's, around the
// staging of each key tile.
//
//   TcTile<DP>  bf16 queries and K/V on the tensor cores: S = Q K^T and
//               O += P V with mma.sync m16n8k16 (bf16 in, fp32 sums),
//               fragments loaded with ldmatrix (V with .trans), P turned
//               from the S accumulators into bf16 A fragments in registers.
//               Optional per-key scales fold a quantized pool's block
//               scales out of the tiles: the K scale multiplies score
//               column j, the V scale multiplies probability column j
//               before P is rounded to bf16 (the row sum l takes the
//               unscaled p).
//   FmaTile<DP> fp32 on the CUDA cores: each thread holds a 4-row by
//               BK/8-key micro-tile of S and a 4-row by DP/8-column one of
//               O, loads Q, K and V from shared memory as float4 (a
//               thread's keys are 8 apart, so the eight lanes of a
//               quarter-warp read eight consecutive K rows, on eight
//               different bank groups) and exchanges P through a per-warp
//               strip of shared memory. No TF32: it keeps fp32's digits.
//
// DP is the head dim padded to 64, 128 or 256, so the register arrays have
// static sizes and the loops over it are straight-line code; the caller
// zero-fills the padding columns of Q, K and V, which then add zeros.
// The mask is a range of each row's keys: set_limits takes, once, the end
// of the keys each block row may see and, with the compile-time option
// START (a sliding window), their start; a tile's per-score test is then
// one or two compares. Masked scores are NEG_INF and their probabilities
// are forced to 0, as in decode_attention.cu; the final normalizer is
// max(l, 1e-30). row_lse gives the rows' log-sum-exp after the last step
// (the flash forward's, for its backward); the paged kernels never call it.
#pragma once

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "cp_async.cuh"

namespace rt {

constexpr int TILE_ROWS = 64;      // query rows of a block
constexpr int TILE_THREADS = 128;  // four warps, 16 rows each

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and receives, of each matrix, row l / 4, elements 2(l % 4), +1.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// The same, transposed: of each matrix lane l receives column l / 4,
// elements of rows 2(l % 4), +1.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16, `lo` in the low half (the lower k index).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int DP, bool START = false>
struct TcTile {
  static_assert(DP % 16 == 0, "the head dim is padded to whole k-steps");
  using elem = __nv_bfloat16;
  static constexpr int BK = 64;         // keys per tile
  static constexpr int LD = DP + 8;     // row stride (elements): rows 16 bytes apart
                                        // modulo 128, so ldmatrix is conflict-free
  static constexpr int P_FLOATS = 0;    // P stays in registers
  static constexpr float LOG2E = 1.4426950408889634f;

  static constexpr bool QREG = DP <= 128;  // Q's A fragments held in registers

  float o[DP / 8][4];  // O: rows g, g + 8 of the warp's 16; columns 8n + 2(lane % 4), +1
  float m[2], l[2];    // running max of the (K-scaled) scores, this thread's share of the row sum
  int lim[2];          // the rows' key limits (exclusive)
  int beg[2];          // with START: the rows' first keys
  uint32_t qf[QREG ? DP / 16 : 1][4];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    m[0] = m[1] = NEG_INF;
    l[0] = l[1] = 0.f;
  }

  // Block row i sees keys below row_limit(i).
  template <typename RowLimit>
  __device__ __forceinline__ void set_limits(RowLimit row_limit) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    lim[0] = row_limit(warp * 16 + (lane >> 2));
    lim[1] = row_limit(warp * 16 + (lane >> 2) + 8);
  }

  // With START: block row i sees keys row_start(i) <= t < row_limit(i).
  template <typename RowLimit, typename RowStart>
  __device__ __forceinline__ void set_limits(RowLimit row_limit, RowStart row_start) {
    static_assert(START, "a row start needs the START tile");
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    set_limits(row_limit);
    beg[0] = row_start(warp * 16 + (lane >> 2));
    beg[1] = row_start(warp * 16 + (lane >> 2) + 8);
  }

  // With DP <= 128, Q's A fragments go to registers once, after the
  // caller has staged Qs (the block's 64 rows, stride LD).
  __device__ __forceinline__ void load_q(const elem* Qs) {
    if constexpr (QREG) {
      const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
      const elem* qa = Qs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) ldmatrix_x4(qf[kk], qa + kk * 16);
    }
  }

  // One key tile, keys k0..k0+BK-1: Qs the block's 64 rows, Ks/Vs the
  // tile, all of stride LD. ksc/vsc: the keys' scales (read only when
  // KS/VS).
  template <bool KS, bool VS>
  __device__ __forceinline__ void step(const elem* Qs, const elem* Ks, const elem* Vs,
                                       const float* ksc, const float* vsc, float scale, int k0) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int end[2] = {lim[0] - k0, lim[1] - k0};
    const int st[2] = {START ? beg[0] - k0 : 0, START ? beg[1] - k0 : 0};
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;

    // S = Q K^T: A from Q rows, B from K rows (ldmatrix without .trans)
    const elem* kb = Ks + (((lane >> 4) << 3) + (lane & 7)) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4];
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldmatrix_x4(a, Qs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8 + kk * 16);
      }
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, kb + np * 16 * LD + kk * 16);
        mma_bf16(s[2 * np], a, b[0], b[1]);
        mma_bf16(s[2 * np + 1], a, b[2], b[3]);
      }
    }

    // a tile every row of the warp sees whole takes no per-score mask
    if (__all_sync(0xffffffffu, end[0] >= BK && end[1] >= BK && st[0] <= 0 && st[1] <= 0))
      softmax<KS, VS, false>(s, end, st, ksc, vsc, scale);
    else
      softmax<KS, VS, true>(s, end, st, ksc, vsc, scale);

    // O += P V: P's A fragment for keys 16kk.. is the S accumulators of
    // column blocks 2kk and 2kk + 1; B from V rows with ldmatrix .trans
    const elem* vb = Vs + (((lane >> 3) & 1) * 8 + (lane & 7)) * LD + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vb + kk * 16 * LD + dp * 16);
        mma_bf16(o[2 * dp], a, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
      }
    }
  }

  // The online softmax over one tile's scores, rows g (h = 0) and g + 8
  // (h = 1): a row's values of each 8-key column block sit in one quad. The
  // max is taken before the softmax scale (a positive factor), which then
  // rides the exponent's FMA. S becomes P (times the V scales), O and l
  // are rescaled.
  template <bool KS, bool VS, bool MASK>
  __device__ __forceinline__ void softmax(float (&s)[BK / 8][4], const int (&end)[2],
                                          const int (&st)[2], const float* ksc, const float* vsc,
                                          float scale) {
    const int tg = threadIdx.x & 3;
    const float sl = scale * LOG2E;
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = NEG_INF;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = n * 8 + tg * 2 + e;
          float v = KS ? s[n][2 * h + e] * ksc[j] : s[n][2 * h + e];
          if (MASK && (j >= end[h] || (START && j < st[h]))) v = NEG_INF;
          s[n][2 * h + e] = v;
          mx = fmaxf(mx, v);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      corr[h] = ex2((m[h] - m_new) * sl);
      m[h] = m_new;
      const float msl = m_new * sl;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = n * 8 + tg * 2 + e;
          float p = ex2(fmaf(s[n][2 * h + e], sl, -msl));
          if (MASK && (j >= end[h] || (START && j < st[h]))) p = 0.f;
          sum += p;
          s[n][2 * h + e] = VS ? p * vsc[j] : p;
        }
      l[h] = l[h] * corr[h] + sum;
    }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
  }

  // O / max(l, 1e-30) into columns d < dh of out(i), the output row of
  // block row i (nullptr: a padding row, not stored).
  template <typename Out>
  __device__ __forceinline__ void finish(Out out, int dh) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, tg = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = l[h];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float den = fmaxf(sum, 1e-30f);
      auto* row = out(warp * 16 + g + 8 * h);
      using T = typename std::remove_pointer<decltype(row)>::type;
      if (row == nullptr) continue;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = n * 8 + tg * 2 + e;
          if (d < dh) row[d] = from_f<T>(o[n][2 * h + e] / den);
        }
    }
  }

  // The rows' log-sum-exp of the scaled scores, scale * m + log(l) in
  // natural-log units (m is kept unscaled), to dst(i, value) for block row
  // i; +inf for a row that saw no key. Called after the last step, outside
  // the key loop; O is untouched.
  template <typename Dst>
  __device__ __forceinline__ void row_lse(Dst dst, float scale) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = l[h];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if ((lane & 3) == 0)
        dst(warp * 16 + (lane >> 2) + 8 * h,
            sum > 0.f ? fmaf(m[h], scale, logf(sum)) : __int_as_float(0x7f800000));
    }
  }
};

template <int DP, bool START = false>
struct FmaTile {
  static_assert(DP % 32 == 0, "a thread's O columns are DP/32 float4 groups");
  using elem = float;
  static constexpr int BK = DP > 128 ? 32 : 64;  // keys per tile (dh 256: shared memory)
  static constexpr int KPT = BK / 8;             // keys per thread: lane % 8 + 8j
  static constexpr int LD = DP + 4;  // row stride (floats): eight rows 16 bytes apart
                                     // modulo 128, so eight float4 loads hit all banks
  static constexpr int LP = BK + 4;  // row stride of the P strip
  static constexpr int P_FLOATS = TILE_ROWS * LP;

  float o[4][DP / 32][4];  // O: rows 4(lane / 8) + i; columns 4(lane % 8) + 32c + e
  float m[4], l[4];        // running max and this thread's share of the row sum
  int lim[4];              // the rows' key limits (exclusive)
  int beg[4];              // with START: the rows' first keys

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < DP / 32; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][c][e] = 0.f;
      m[i] = NEG_INF;
      l[i] = 0.f;
    }
  }

  // Block row i sees keys below row_limit(i).
  template <typename RowLimit>
  __device__ __forceinline__ void set_limits(RowLimit row_limit) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int i = 0; i < 4; ++i) lim[i] = row_limit(warp * 16 + (lane >> 3) * 4 + i);
  }

  // With START: block row i sees keys row_start(i) <= t < row_limit(i).
  template <typename RowLimit, typename RowStart>
  __device__ __forceinline__ void set_limits(RowLimit row_limit, RowStart row_start) {
    static_assert(START, "a row start needs the START tile");
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    set_limits(row_limit);
#pragma unroll
    for (int i = 0; i < 4; ++i) beg[i] = row_start(warp * 16 + (lane >> 3) * 4 + i);
  }

  // One key tile, keys k0..k0+BK-1: Qs the block's 64 rows, Ks/Vs the
  // tile, all of stride LD; Ps the block's P (TILE_ROWS x LP), of which the
  // warp uses its 16 rows.
  __device__ __forceinline__ void step(const float* Qs, const float* Ks, const float* Vs,
                                       float* Ps, float scale, int dh, int k0) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int cg = lane & 7;
    const int i0 = warp * 16 + (lane >> 3) * 4;  // the thread's first row
    float s[4][KPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;

    const int nd4 = (dh + 3) >> 2;
#pragma unroll 2
    for (int d4 = 0; d4 < nd4; ++d4) {
      float4 q[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        q[i] = *reinterpret_cast<const float4*>(Qs + (i0 + i) * LD + d4 * 4);
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float4 k = *reinterpret_cast<const float4*>(Ks + (cg + 8 * j) * LD + d4 * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float a = s[i][j];
          a = fmaf(q[i].x, k.x, a);
          a = fmaf(q[i].y, k.y, a);
          a = fmaf(q[i].z, k.z, a);
          s[i][j] = fmaf(q[i].w, k.w, a);
        }
      }
    }

    // online softmax: a row's keys are spread over the eight lanes of its
    // quarter-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int end = lim[i] - k0, st = START ? beg[i] - k0 : 0;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const bool in = cg + 8 * j < end && (!START || cg + 8 * j >= st);
        const float v = in ? s[i][j] * scale : NEG_INF;
        s[i][j] = v;
        mx = fmaxf(mx, v);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const bool in = cg + 8 * j < end && (!START || cg + 8 * j >= st);
        const float p = in ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        Ps[(i0 + i) * LP + cg + 8 * j] = p;
      }
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int c = 0; c < DP / 32; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][c][e] *= corr;
    }
    __syncwarp();

    // O += P V, keys in order
#pragma unroll 2
    for (int j4 = 0; j4 < BK / 4; ++j4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = *reinterpret_cast<const float4*>(Ps + (i0 + i) * LP + j4 * 4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vr = Vs + (j4 * 4 + e) * LD + cg * 4;
#pragma unroll
        for (int c = 0; c < DP / 32; ++c) {
          const float4 v = *reinterpret_cast<const float4*>(vr + c * 32);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pi = e == 0 ? p[i].x : e == 1 ? p[i].y : e == 2 ? p[i].z : p[i].w;
            o[i][c][0] = fmaf(pi, v.x, o[i][c][0]);
            o[i][c][1] = fmaf(pi, v.y, o[i][c][1]);
            o[i][c][2] = fmaf(pi, v.z, o[i][c][2]);
            o[i][c][3] = fmaf(pi, v.w, o[i][c][3]);
          }
        }
      }
    }
  }

  template <typename Out>
  __device__ __forceinline__ void finish(Out out, int dh) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int cg = lane & 7;
    const int i0 = warp * 16 + (lane >> 3) * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float sum = l[i];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      const float den = fmaxf(sum, 1e-30f);
      auto* row = out(i0 + i);
      using T = typename std::remove_pointer<decltype(row)>::type;
      if (row == nullptr) continue;
#pragma unroll
      for (int c = 0; c < DP / 32; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = c * 32 + cg * 4 + e;
          if (d < dh) row[d] = from_f<T>(o[i][c][e] / den);
        }
    }
  }

  // As TcTile::row_lse; m is kept scaled here.
  template <typename Dst>
  __device__ __forceinline__ void row_lse(Dst dst, float) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int i0 = warp * 16 + (lane >> 3) * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float sum = l[i];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      if ((lane & 7) == 0) dst(i0 + i, sum > 0.f ? m[i] + logf(sum) : __int_as_float(0x7f800000));
    }
  }
};

}  // namespace rt
