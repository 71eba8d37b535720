// Causal / sliding-window GQA flash attention backward: dQ, dK, dV.
//
// Replaces the backward of src/repro/kernels/flash_attention.py's
// custom_vjp (_flash_bwd :110-128). That one is no pallas_call: it
// recomputes attention blockwise through the chunked jnp reference
// (_sdpa_chunked) and differentiates it, so on the TPU the backward is
// XLA's. Here it is written by hand, FA2-style, in two or three launches
// on the caller's stream. It takes the forward's output O and its row
// log-sum-exp (flash_attention.cu writes it, natural log, (B, HQ, S), +inf
// for a row that sees no key), so no launch recomputes the softmax
// statistics:
//
//   1. dq kernel, a block per (batch, query head, 64-query tile), heaviest
//      tiles first: delta = rowsum(dO * O) for its rows (kept in the
//      workspace for the dkdv kernel), then over the key tiles the rows see
//      S = Q K^T, P = exp(S scale - lse), dP = dO V^T, dS = P (dP - delta),
//      dQ += dS K: three products of dh a live (query, key) pair.
//   2. dkdv kernel. A key tile of 64 keys is seen, for each of the G query
//      heads of its group, by the query tiles from its own on (causal) or
//      inside the window: a list of (head, query tile) steps whose length
//      falls with the tile's index. The list is cut into chunks of at most
//      `chunk` steps (kernels/flash_attention.py: bwd_geometry picks the
//      chunk whose simulated dispatch over the card's resident blocks ends
//      first), and a block runs one chunk: recompute S^T = K Q^T, P,
//      dP^T = V dO^T and dS, accumulate dV += P^T dO and dK += dS^T Q
//      (four products). The GQA sum over the group runs inside the chunk.
//      A key tile of one chunk is written by its block directly; in a tile
//      of several, each block writes its fp32 partial of dK and dV to the
//      workspace.
//   3. reduce kernel, only when some key tile has several chunks: a block
//      per 16 keys of such a tile sums its chunks' partials in chunk order
//      and writes dK and dV. (The last-arriving chunk summing its tile by
//      an arrival ticket, as moe_route.cu does, saved the launch but was
//      slower on the H100 where a tile has many chunks: one block reads
//      them all, and the merge spilled registers.)
//
// Deterministic: no atomics; every output element is summed in a fixed
// order, whichever block ends first, so two runs are bit-identical (the training driver's recovery
// replays steps bit for bit). Masks are the forward's row limits: query p
// sees keys lo(p) <= t < hi(p), hi = min(S, p + 1) when causal (else S),
// lo = max(0, p - window + 1) with a window (else 0); masked pairs give
// P = 0 exactly, so a key no query sees gets exact zeros. A step whose
// every pair is live takes the mask-free path.
//
// What bounds it: 5 products of dh a live pair (S, dP, dV, dK, dQ) is the
// work; this design does 7 (S and dP in both launches), so operations. So
// the math runs from registers, four warps a block, 16 query rows (dq) or
// 16 keys (dkdv) a warp:
//   - bf16 on the tensor cores (DqTc, DkvTc): every product mma.sync
//     m16n8k16 with fp32 sums, fragments by ldmatrix and ldmatrix.trans
//     from rows 16 bytes apart modulo 128 (conflict-free), the S and dP
//     accumulators turned into P and dS A-fragments in registers, rounded
//     to bf16 before they multiply (as FA2 and the forward's P V do).
//     wgmma with TMA-fed rings and warp specialisation are later work.
//   - fp32 on the CUDA cores (DqFma, DkvFma): register micro-tiles, 32 keys
//     (dq) or queries (dkdv) a step, reading float4s (float2s at dh 80 and
//     112) from rows padded by 4 floats, a thread's rows 4 apart so a warp's
//     loads hit distinct banks; P and dS go through strips of shared
//     memory. dq: 4 rows x 4 keys a thread for S and dP, 4 rows x dh/8
//     columns of dQ. dkdv: warps 0-1 take S^T, P and dV, warps 2-3 dP^T, dS
//     and dK, 8 keys x 4 queries a thread, then 8 keys x dh/8 columns.
//     No TF32: fp32 keeps its digits. The shared-memory loads, about one
//     for 10 FMAs, hold these tiles near 45 % of the FMA rate on the H100.
// K/V tiles (dq) and Q/dO tiles with their lse and delta (dkdv) stream
// through a two-stage cp.async ring, the next tile's copy under this
// tile's math, at the widest copy the pointers allow (element copies
// otherwise). The head dim is instantiated at 64, 80, 112 and 128 (every
// config's); others pad to the next with zero columns.
#include "cp_async.cuh"
#include "register_tiles.cuh"

namespace {

constexpr int THREADS = rt::TILE_THREADS;  // four warps
constexpr int BQ = rt::TILE_ROWS;          // query rows of a dq block
constexpr int BKV = rt::TILE_ROWS;         // keys of a dkdv block
constexpr int RED_THREADS = 256, RED_ROWS = 16;  // a reduce block's threads, keys
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, HQ, S), natural log
  void* dq;
  void* dk;
  void* dv;
  float* delta;  // (B, HQ, S) workspace
  float* part;   // (2, slots, BKV, DP) workspace: the chunks' dK, then dV
  int B, S, HQ, HKV, dh, causal, window;
  int chunk;  // (head, query tile) steps of a dkdv block, at most
  int slots;  // dkdv blocks: the key tiles' chunks x B x HKV
  int vec;    // bytes a cp.async of a Q, K, V or dO row (16, 8, 4), or 0
  float scale;
};

struct Mask {
  int S, causal, window;
  __device__ __forceinline__ int hi(int p) const { return causal ? min(S, p + 1) : S; }
  __device__ __forceinline__ int lo(int p) const { return window > 0 ? max(0, p - window + 1) : 0; }
  __device__ __forceinline__ bool ok(int p, int t) const {
    return p < S && t < S && t >= lo(p) && t < hi(p);
  }
};

// The query tiles (of bqs rows) that see key tile kt: [x, y). Both row
// limits grow with the query, so they are one range.
__host__ __device__ __forceinline__ int2 query_tiles(int kt, int S, int causal, int window,
                                                     int bqs) {
  const int k0 = kt * BKV, k_last = (k0 + BKV < S ? k0 + BKV : S) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? (k_last + window < S ? k_last + window : S) : S;
  const int x = q_lo / bqs;
  return make_int2(x, q_lo < q_hi ? (q_hi + bqs - 1) / bqs : x);
}

// Chunks of a key tile with `items` steps: at least one, which writes zeros
// for a tile no query sees.
__host__ __device__ __forceinline__ int chunks_of(int items, int chunk) {
  return items > 0 ? (items + chunk - 1) / chunk : 1;
}

// ---------------------------------------------------------------------------
// staging

// Rows [0, rows) of a (rows, dh) tile into dst (row stride ld elements)
// from src + j * stride; rows j >= valid are zero-filled. V-byte cp.asyncs,
// or element copies through registers when V is 0. Columns dh.. are not
// written. The caller commits.
template <int V, typename T>
__device__ __forceinline__ void stage_v(T* dst, int ld, const T* src, long long stride, int rows,
                                        int valid, int dh) {
  if constexpr (V > 0) {
    const int cpr = dh * static_cast<int>(sizeof(T)) / V;
    for (int idx = threadIdx.x; idx < rows * cpr; idx += THREADS) {
      const int j = idx / cpr, c = idx - j * cpr;
      const bool ok = j < valid;
      const char* s = reinterpret_cast<const char*>(src + (ok ? j : 0) * stride) + c * V;
      rt::cp_async<V>(reinterpret_cast<char*>(dst + j * ld) + c * V, s, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * dh; idx += THREADS) {
      const int j = idx / dh, d = idx - j * dh;
      dst[j * ld + d] = j < valid ? src[j * stride + d] : rt::from_f<T>(0.f);
    }
  }
}

template <typename T>
__device__ __forceinline__ void stage_tile(T* dst, int ld, const T* src, long long stride,
                                           int rows, int valid, int dh, int vec) {
  switch (vec) {
    case 16: stage_v<16>(dst, ld, src, stride, rows, valid, dh); break;
    case 8: stage_v<8>(dst, ld, src, stride, rows, valid, dh); break;
    case 4: stage_v<4>(dst, ld, src, stride, rows, valid, dh); break;
    default: stage_v<0>(dst, ld, src, stride, rows, valid, dh);
  }
}

__device__ __forceinline__ void zero_smem(void* p, size_t bytes) {
  uint4* z = reinterpret_cast<uint4*>(p);
  for (int i = threadIdx.x; i < static_cast<int>(bytes / 16); i += THREADS)
    z[i] = make_uint4(0, 0, 0, 0);
}

// ---------------------------------------------------------------------------
// bf16 tiles on the tensor cores. A thread of warp w holds rows 16w + g and
// 16w + g + 8 (g = lane / 4) of an accumulator, columns 8n + 2(lane % 4),
// +1, as mma.sync leaves them.

// A: rows 16w.. of a row-major tile (ldmatrix, no .trans). B, non-trans:
// rows of the tile are the product's n (Q K^T's keys). B, .trans: rows are
// the product's k (P V's keys).
template <int LD>
__device__ __forceinline__ int a_off() {
  const int lane = threadIdx.x & 31;
  return ((threadIdx.x >> 5) * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
}
template <int LD>
__device__ __forceinline__ int b_off() {
  const int lane = threadIdx.x & 31;
  return (((lane >> 4) << 3) + (lane & 7)) * LD + ((lane >> 3) & 1) * 8;
}
template <int LD>
__device__ __forceinline__ int bt_off() {
  const int lane = threadIdx.x & 31;
  return (((lane >> 3) & 1) * 8 + (lane & 7)) * LD + (lane >> 4) * 8;
}

// acc (the warp's 16 rows x DP) += A x B: A the 16 x 16 tile of the
// accumulators s0, s1 (16 keys or queries, as bf16), B their 16 rows of Bs
// (ldmatrix .trans) over DP columns.
template <int DP>
__device__ __forceinline__ void mma_rows(float (&acc)[DP / 8][4], const float (&s0)[4],
                                         const float (&s1)[4], const __nv_bfloat16* Bs) {
  uint32_t a[4];
  a[0] = rt::pack_bf16(s0[0], s0[1]);
  a[1] = rt::pack_bf16(s0[2], s0[3]);
  a[2] = rt::pack_bf16(s1[0], s1[1]);
  a[3] = rt::pack_bf16(s1[2], s1[3]);
#pragma unroll
  for (int d2 = 0; d2 < DP / 16; ++d2) {
    uint32_t b[4];
    rt::ldmatrix_x4_trans(b, Bs + d2 * 16);
    rt::mma_bf16(acc[2 * d2], a, b[0], b[1]);
    rt::mma_bf16(acc[2 * d2 + 1], a, b[2], b[3]);
  }
}

template <int DP>
struct DqTc {
  using elem = __nv_bfloat16;
  static constexpr int BK = 64;         // keys a step
  static constexpr int LD = DP + 8;     // rows 16 bytes apart modulo 128
  static constexpr int STRIP = 0;
  static constexpr bool REG = DP <= 80;  // Q's and dO's A fragments in registers

  float acc[DP / 8][4];
  float l2[2], dl[2];  // the rows' lse (log2 units) and delta
  uint32_t qf[REG ? DP / 16 : 1][4], of[REG ? DP / 16 : 1][4];

  __device__ __forceinline__ void init(const elem* Qs, const elem* dOs, const float* lse2_s,
                                       const float* del_s) {
    const int lane = threadIdx.x & 31, r = (threadIdx.x >> 5) * 16 + (lane >> 2);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) l2[h] = lse2_s[r + 8 * h], dl[h] = del_s[r + 8 * h];
    if constexpr (REG) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        rt::ldmatrix_x4(qf[kk], Qs + a_off<LD>() + kk * 16);
        rt::ldmatrix_x4(of[kk], dOs + a_off<LD>() + kk * 16);
      }
    }
  }

  template <bool MASK>
  __device__ __forceinline__ void step(const elem* Qs, const elem* dOs, const elem* Ks,
                                       const elem* Vs, float*, float sl, const Mask& mk, int q0,
                                       int k0) {
    const int lane = threadIdx.x & 31, tg = lane & 3;
    const int r0 = (threadIdx.x >> 5) * 16 + (lane >> 2);
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f, dp[n][e] = 0.f;
    // S = Q K^T and dP = dO V^T
    const int bo = b_off<LD>();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t aq[4], ao[4];
      if constexpr (REG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) aq[e] = qf[kk][e], ao[e] = of[kk][e];
      } else {
        rt::ldmatrix_x4(aq, Qs + a_off<LD>() + kk * 16);
        rt::ldmatrix_x4(ao, dOs + a_off<LD>() + kk * 16);
      }
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t b[4];
        rt::ldmatrix_x4(b, Ks + bo + np * 16 * LD + kk * 16);
        rt::mma_bf16(s[2 * np], aq, b[0], b[1]);
        rt::mma_bf16(s[2 * np + 1], aq, b[2], b[3]);
        rt::ldmatrix_x4(b, Vs + bo + np * 16 * LD + kk * 16);
        rt::mma_bf16(dp[2 * np], ao, b[0], b[1]);
        rt::mma_bf16(dp[2 * np + 1], ao, b[2], b[3]);
      }
    }
    // dS = P (dP - delta), P = 2^(S sl - lse2): row r0 + 8h, key 8n + 2tg + e
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p = rt::ex2(fmaf(s[n][2 * h + e], sl, -l2[h]));
          if (MASK && !mk.ok(q0 + r0 + 8 * h, k0 + 8 * n + 2 * tg + e)) p = 0.f;
          s[n][2 * h + e] = p * (dp[n][2 * h + e] - dl[h]);
        }
    // dQ += dS K
    const int bt = bt_off<LD>();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      mma_rows<DP>(acc, s[2 * kk], s[2 * kk + 1], Ks + bt + kk * 16 * LD);
  }

  // acc * mul into columns d < dh of out(r), block row r (nullptr: not stored)
  template <typename Out>
  __device__ __forceinline__ void store(Out out, float mul, int dh) const {
    const int lane = threadIdx.x & 31, tg = lane & 3;
    const int r0 = (threadIdx.x >> 5) * 16 + (lane >> 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      auto* row = out(r0 + 8 * h);
      using T = typename std::remove_pointer<decltype(row)>::type;
      if (row == nullptr) continue;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = 8 * n + 2 * tg + e;
          if (d < dh) row[d] = rt::from_f<T>(acc[n][2 * h + e] * mul);
        }
    }
  }
};

template <int DP>
struct DkvTc {
  using elem = __nv_bfloat16;
  static constexpr int BQS = DP <= 80 ? 64 : 32;  // queries a step (registers at dh 112, 128)
  static constexpr int LD = DP + 8;
  static constexpr int STRIP = 0;
  static constexpr bool REG = DP <= 64;  // K's and V's A fragments in registers

  float dk[DP / 8][4], dv[DP / 8][4];
  uint32_t kf[REG ? DP / 16 : 1][4], vf[REG ? DP / 16 : 1][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[n][e] = 0.f, dv[n][e] = 0.f;
  }

  __device__ __forceinline__ void load_kv(const elem* Ks, const elem* Vs) {
    if constexpr (REG) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        rt::ldmatrix_x4(kf[kk], Ks + a_off<LD>() + kk * 16);
        rt::ldmatrix_x4(vf[kk], Vs + a_off<LD>() + kk * 16);
      }
    }
  }

  template <bool MASK>
  __device__ __forceinline__ void step(const elem* Ks, const elem* Vs, const elem* Qs,
                                       const elem* dOs, const float* lse_s, const float* del_s,
                                       float*, float sl, const Mask& mk, int q0, int k0) {
    const int lane = threadIdx.x & 31, tg = lane & 3;
    const int r0 = (threadIdx.x >> 5) * 16 + (lane >> 2);
    float s[BQS / 8][4], dp[BQS / 8][4];
#pragma unroll
    for (int n = 0; n < BQS / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f, dp[n][e] = 0.f;
    // S^T = K Q^T and dP^T = V dO^T: keys are the rows
    const int bo = b_off<LD>();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t ak[4], av[4];
      if constexpr (REG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) ak[e] = kf[kk][e], av[e] = vf[kk][e];
      } else {
        rt::ldmatrix_x4(ak, Ks + a_off<LD>() + kk * 16);
        rt::ldmatrix_x4(av, Vs + a_off<LD>() + kk * 16);
      }
#pragma unroll
      for (int np = 0; np < BQS / 16; ++np) {
        uint32_t b[4];
        rt::ldmatrix_x4(b, Qs + bo + np * 16 * LD + kk * 16);
        rt::mma_bf16(s[2 * np], ak, b[0], b[1]);
        rt::mma_bf16(s[2 * np + 1], ak, b[2], b[3]);
        rt::ldmatrix_x4(b, dOs + bo + np * 16 * LD + kk * 16);
        rt::mma_bf16(dp[2 * np], av, b[0], b[1]);
        rt::mma_bf16(dp[2 * np + 1], av, b[2], b[3]);
      }
    }
    // P^T and dS^T: key r0 + 8h, query c = 8n + 2tg + e
#pragma unroll
    for (int n = 0; n < BQS / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * n + 2 * tg + e;
        const float l2 = lse_s[c] * LOG2E, dl = del_s[c];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float p = rt::ex2(fmaf(s[n][2 * h + e], sl, -l2));
          if (MASK && !mk.ok(q0 + c, k0 + r0 + 8 * h)) p = 0.f;
          s[n][2 * h + e] = p;
          dp[n][2 * h + e] = p * (dp[n][2 * h + e] - dl);
        }
      }
    // dV += P^T dO, dK += dS^T Q
    const int bt = bt_off<LD>();
#pragma unroll
    for (int kk = 0; kk < BQS / 16; ++kk) {
      mma_rows<DP>(dv, s[2 * kk], s[2 * kk + 1], dOs + bt + kk * 16 * LD);
      mma_rows<DP>(dk, dp[2 * kk], dp[2 * kk + 1], Qs + bt + kk * 16 * LD);
    }
  }

  // dK * mul_k and dV into columns d < dh of out_k(r), out_v(r), key r
  template <typename OutK, typename OutV>
  __device__ __forceinline__ void store(OutK out_k, OutV out_v, float mul_k, int dh) const {
    const int lane = threadIdx.x & 31, tg = lane & 3;
    const int r0 = (threadIdx.x >> 5) * 16 + (lane >> 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      auto* rk = out_k(r0 + 8 * h);
      auto* rv = out_v(r0 + 8 * h);
      using T = typename std::remove_pointer<decltype(rk)>::type;
      if (rk == nullptr) continue;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = 8 * n + 2 * tg + e;
          if (d < dh) {
            rk[d] = rt::from_f<T>(dk[n][2 * h + e] * mul_k);
            rv[d] = rt::from_f<T>(dv[n][2 * h + e]);
          }
        }
    }
  }
};

// ---------------------------------------------------------------------------
// fp32 tiles on the CUDA cores. A thread holds rows lane / 8 + 4i of its
// warp's 16 (i < 4: the four quarter-warps read four consecutive rows, on
// four bank groups); S and dP columns lane % 8 + 8j; gradient columns in
// groups of VW: VW (lane % 8) + 8 VW c + v.

template <int DP>
struct Cols {
  static constexpr int VW = DP % 32 == 0 ? 4 : 2;  // float4s at dh 64, 128; float2s at 80, 112
  static constexpr int NG = DP / (8 * VW);
};

template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&o)[N]) {
  if constexpr (N == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    o[0] = f.x, o[1] = f.y, o[2] = f.z, o[3] = f.w;
  } else {
    const float2 f = *reinterpret_cast<const float2*>(p);
    o[0] = f.x, o[1] = f.y;
  }
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float part(const float4& f, int e) {
  return e == 0 ? f.x : e == 1 ? f.y : e == 2 ? f.z : f.w;
}

__device__ __forceinline__ float4 f4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// acc[i][c][v] += sum_e a[i][e] * B[row e][cols] for the thread's R rows:
// the gradient product over 4 keys (dq) or 4 queries (dkdv), the 4 rows of
// B from Brow (stride LD).
template <int DP, int LD, int R>
__device__ __forceinline__ void fma_rows(float (&acc)[R][Cols<DP>::NG][Cols<DP>::VW],
                                         const float4 (&a)[R], const float* Brow, int cg) {
  using C = Cols<DP>;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float* br = Brow + e * LD + C::VW * cg;
#pragma unroll
    for (int c = 0; c < C::NG; ++c) {
      float bv[C::VW];
      load_vec<C::VW>(br + 8 * C::VW * c, bv);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float x = part(a[i], e);
#pragma unroll
        for (int w = 0; w < C::VW; ++w) acc[i][c][w] = fmaf(x, bv[w], acc[i][c][w]);
      }
    }
  }
}

// acc * mul into columns d < dh of out(i0 + 4 i), the thread's R rows
template <int DP, int R, typename Out>
__device__ __forceinline__ void fma_store(const float (&acc)[R][Cols<DP>::NG][Cols<DP>::VW],
                                          Out out, float mul, int dh, int i0) {
  using C = Cols<DP>;
  const int cg = threadIdx.x & 7;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    auto* row = out(i0 + 4 * i);
    using T = typename std::remove_pointer<decltype(row)>::type;
    if (row == nullptr) continue;
#pragma unroll
    for (int c = 0; c < C::NG; ++c)
#pragma unroll
      for (int w = 0; w < C::VW; ++w) {
        const int d = C::VW * cg + 8 * C::VW * c + w;
        if (d < dh) row[d] = rt::from_f<T>(acc[i][c][w] * mul);
      }
  }
}

template <int DP>
struct DqFma {
  using elem = float;
  using C = Cols<DP>;
  static constexpr int BK = 32, KPT = BK / 8;  // keys a step, a thread
  static constexpr int LD = DP + 4;            // eight rows 16 bytes apart modulo 128
  static constexpr int LP = BK + 8;  // quarter-warps write on 8 banks each
  static constexpr int STRIP = rt::TILE_ROWS * LP;  // dS, a warp's 16 rows each

  float acc[4][C::NG][C::VW];
  float l2[4], dl[4];

  __device__ __forceinline__ void init(const float*, const float*, const float* lse2_s,
                                       const float* del_s) {
    const int i0 = (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 3);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      l2[i] = lse2_s[i0 + 4 * i], dl[i] = del_s[i0 + 4 * i];
#pragma unroll
      for (int c = 0; c < C::NG; ++c)
#pragma unroll
        for (int w = 0; w < C::VW; ++w) acc[i][c][w] = 0.f;
    }
  }

  template <bool MASK>
  __device__ __forceinline__ void step(const float* Qs, const float* dOs, const float* Ks,
                                       const float* Vs, float* Ps, float sl, const Mask& mk,
                                       int q0, int k0) {
    const int lane = threadIdx.x & 31, cg = lane & 7;
    const int i0 = (threadIdx.x >> 5) * 16 + (lane >> 3);
    float s[4][KPT], dp[4][KPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f, dp[i][j] = 0.f;
#pragma unroll 2
    for (int d4 = 0; d4 < DP / 4; ++d4) {
      float4 qv[4], ov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = f4(Qs + (i0 + 4 * i) * LD + d4 * 4);
        ov[i] = f4(dOs + (i0 + 4 * i) * LD + d4 * 4);
      }
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float4 kv = f4(Ks + (cg + 8 * j) * LD + d4 * 4);
        const float4 vv = f4(Vs + (cg + 8 * j) * LD + d4 * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = dot4(qv[i], kv, s[i][j]);
          dp[i][j] = dot4(ov[i], vv, dp[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        float p = exp2f(fmaf(s[i][j], sl, -l2[i]));
        if (MASK && !mk.ok(q0 + i0 + 4 * i, k0 + cg + 8 * j)) p = 0.f;
        Ps[(i0 + 4 * i) * LP + cg + 8 * j] = p * (dp[i][j] - dl[i]);
      }
    __syncwarp();
    // dQ += dS K, keys in order
#pragma unroll 2
    for (int j4 = 0; j4 < BK / 4; ++j4) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = f4(Ps + (i0 + 4 * i) * LP + j4 * 4);
      fma_rows<DP, LD, 4>(acc, a, Ks + j4 * 4 * LD, cg);
    }
  }

  template <typename Out>
  __device__ __forceinline__ void store(Out out, float mul, int dh) const {
    fma_store<DP, 4>(acc, out, mul, dh, (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 3));
  }
};

// Warps 0 and 1 take S^T, P and dV, warps 2 and 3 dP^T, dS and dK, each
// warp 32 of the 64 keys, a thread rows lane / 8 + 4i (i < 8) of them: 8
// rows a thread load each query row once for twice the FMAs of 4, and the
// two sides meet at one barrier a step (P to the dS side).
template <int DP>
struct DkvFma {
  using elem = float;
  using C = Cols<DP>;
  static constexpr int BQS = 32, QPT = BQS / 8;  // queries a step, a thread
  static constexpr int LD = DP + 4;
  static constexpr int LP = BQS + 8;
  static constexpr int STRIP = 2 * rt::TILE_ROWS * LP;  // P^T, then dS^T

  float acc[8][C::NG][C::VW];  // dV (warps 0, 1) or dK (warps 2, 3)

  __device__ __forceinline__ static bool ds_side() { return threadIdx.x >= 64; }
  __device__ __forceinline__ static int first_row() {
    return ((threadIdx.x >> 5) & 1) * 32 + ((threadIdx.x & 31) >> 3);
  }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < C::NG; ++c)
#pragma unroll
        for (int w = 0; w < C::VW; ++w) acc[i][c][w] = 0.f;
  }
  __device__ __forceinline__ void load_kv(const float*, const float*) {}

  template <bool MASK>
  __device__ __forceinline__ void step(const float* Ks, const float* Vs, const float* Qs,
                                       const float* dOs, const float* lse_s, const float* del_s,
                                       float* Ps, float sl, const Mask& mk, int q0, int k0) {
    const int cg = threadIdx.x & 7, i0 = first_row();
    const bool dside = ds_side();  // warp-uniform
    // S^T = K Q^T (P side) or dP^T = V dO^T (dS side): keys are the rows
    const float* A = dside ? Vs : Ks;
    const float* Bm = dside ? dOs : Qs;
    float s[8][QPT];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < QPT; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d4 = 0; d4 < DP / 4; ++d4) {
      float4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = f4(A + (i0 + 4 * i) * LD + d4 * 4);
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        const float4 bv = f4(Bm + (cg + 8 * j) * LD + d4 * 4);
#pragma unroll
        for (int i = 0; i < 8; ++i) s[i][j] = dot4(av[i], bv, s[i][j]);
      }
    }
    float* Pp = Ps;
    float* Pd = Ps + rt::TILE_ROWS * LP;
    if (!dside) {
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        const int c = cg + 8 * j;
        const float l2 = lse_s[c] * LOG2E;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float p = exp2f(fmaf(s[i][j], sl, -l2));
          if (MASK && !mk.ok(q0 + c, k0 + i0 + 4 * i)) p = 0.f;
          Pp[(i0 + 4 * i) * LP + c] = p;
        }
      }
    }
    __syncthreads();  // P in for the dS side, which wrote its rows' dP
    if (dside) {
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        const int c = cg + 8 * j;
        const float dl = del_s[c];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          Pd[(i0 + 4 * i) * LP + c] = Pp[(i0 + 4 * i) * LP + c] * (s[i][j] - dl);
      }
      __syncwarp();
    }
    // dV += P^T dO or dK += dS^T Q, queries in order
    const float* St = dside ? Pd : Pp;
    const float* Rows = dside ? Qs : dOs;
#pragma unroll 2
    for (int q4 = 0; q4 < BQS / 4; ++q4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = f4(St + (i0 + 4 * i) * LP + q4 * 4);
      fma_rows<DP, LD, 8>(acc, a, Rows + q4 * 4 * LD, cg);
    }
  }

  template <typename OutK, typename OutV>
  __device__ __forceinline__ void store(OutK out_k, OutV out_v, float mul_k, int dh) const {
    if (ds_side())
      fma_store<DP, 8>(acc, out_k, mul_k, dh, first_row());
    else
      fma_store<DP, 8>(acc, out_v, 1.f, dh, first_row());
  }
};

template <typename T, int DP>
struct Tiles {
  using Dq = DqFma<DP>;
  using Dkv = DkvFma<DP>;
};
template <int DP>
struct Tiles<__nv_bfloat16, DP> {
  using Dq = DqTc<DP>;
  using Dkv = DkvTc<DP>;
};

// Shared memory, every part a multiple of 16 bytes.
template <typename T, int DP>
struct DqLayout {
  using Tile = typename Tiles<T, DP>::Dq;
  static constexpr int BK = Tile::BK, LD = Tile::LD;
  static constexpr size_t ROWS = sizeof(T) * BQ * LD;  // Q or dO
  static constexpr size_t KV = sizeof(T) * BK * LD;    // a K or V tile of the ring
  static constexpr size_t TILES = 2 * ROWS + 4 * KV;   // Q, dO, two stages of {K, V}
  static constexpr size_t BYTES = TILES + sizeof(float) * (Tile::STRIP + 2 * BQ);
  // the blocks an SM holds by shared memory, so ptxas spends what registers
  // that leaves (bf16 at dh 64: three, at 168 registers; fp32 past dh 80:
  // one)
  static constexpr int MIN_BLOCKS = BYTES <= 60 * 1024 ? 3 : BYTES <= 110 * 1024 ? 2 : 1;
};

template <typename T, int DP>
struct DkvLayout {
  using Tile = typename Tiles<T, DP>::Dkv;
  static constexpr int BQS = Tile::BQS, LD = Tile::LD;
  static constexpr size_t KV = sizeof(T) * BKV * LD;    // K or V
  static constexpr size_t ROWS = sizeof(T) * BQS * LD;  // a Q or dO tile of the ring
  static constexpr size_t TILES = 2 * KV + 4 * ROWS;    // K, V, two stages of {Q, dO}
  static constexpr size_t BYTES = TILES + sizeof(float) * (Tile::STRIP + 4 * BQS);
  static constexpr int MIN_BLOCKS = BYTES <= 110 * 1024 ? 2 : 1;  // as DqLayout's
};

__device__ __forceinline__ long long row_off(int b, int s, int h, int H, int S, int dh) {
  return ((static_cast<long long>(b) * S + s) * H + h) * dh;
}

// ---------------------------------------------------------------------------
// kernels

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS, (DqLayout<T, DP>::MIN_BLOCKS))
    flash_bwd_dq_kernel(const Args a) {
  using L = DqLayout<T, DP>;
  using Tile = typename L::Tile;
  constexpr int BK = L::BK, LD = L::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + BQ * LD;
  T* ring = dOs + BQ * LD;
  float* strip = reinterpret_cast<float*>(smem + L::TILES);
  float* lse2_s = strip + Tile::STRIP;
  float* del_s = lse2_s + BQ;

  // heaviest query tiles first: under the causal mask the last see most keys
  const int S = a.S, G = a.HQ / a.HKV, dh = a.dh, tid = threadIdx.x, lane = tid & 31;
  const int nqt = (S + BQ - 1) / BQ, per = a.HQ * a.B;
  const int qt = nqt - 1 - static_cast<int>(blockIdx.x / per);
  const int h = static_cast<int>(blockIdx.x % per) % a.HQ;
  const int b = static_cast<int>(blockIdx.x % per) / a.HQ;
  const int hk = h / G, q0 = qt * BQ, valid = min(BQ, S - q0), q_last = q0 + valid - 1;
  const Mask mk{S, a.causal, a.window};
  const long long qs = static_cast<long long>(a.HQ) * dh, ks = static_cast<long long>(a.HKV) * dh;
  const T* dout = static_cast<const T*>(a.dout);
  const T* o = static_cast<const T*>(a.o);
  const T* kb = static_cast<const T*>(a.k) + row_off(b, 0, hk, a.HKV, S, dh);
  const T* vb = static_cast<const T*>(a.v) + row_off(b, 0, hk, a.HKV, S, dh);

  if (dh < DP) {  // the padding columns stay zero: nothing writes them
    zero_smem(smem, L::TILES);
    __syncthreads();
  }
  stage_tile(Qs, LD, static_cast<const T*>(a.q) + row_off(b, q0, h, a.HQ, S, dh), qs, BQ, valid,
             dh, a.vec);
  stage_tile(dOs, LD, dout + row_off(b, q0, h, a.HQ, S, dh), qs, BQ, valid, dh, a.vec);
  rt::cp_async_commit();
  // the rows' lse in log2 units
  const float* lse_g = a.lse + (static_cast<long long>(b) * a.HQ + h) * S;
  for (int j = tid; j < BQ; j += THREADS) lse2_s[j] = j < valid ? lse_g[q0 + j] * LOG2E : inf();

  // the key tiles any row of the tile sees: both limits grow with p
  const int k_lo = mk.lo(q0), k_hi = mk.hi(q_last);
  const int t_begin = k_lo / BK, t_end = k_lo < k_hi ? (k_hi + BK - 1) / BK : t_begin;
  auto stage = [&](int t) {
    T* Kd = ring + (t & 1) * 2 * BK * LD;
    const long long k0 = static_cast<long long>(t) * BK;
    const int n = min(BK, k_hi - t * BK);
    stage_tile(Kd, LD, kb + k0 * ks, ks, BK, n, dh, a.vec);
    stage_tile(Kd + BK * LD, LD, vb + k0 * ks, ks, BK, n, dh, a.vec);
    rt::cp_async_commit();
  };
  rt::cp_async_wait_all();
  __syncthreads();  // Q, dO and lse in
  // delta = rowsum(dO * O) of the warp's 16 rows (the rows its tile
  // holds): dO from shared memory, the loads of O for all 16 rows in flight
  // together, then 16 warp sums
  {
    constexpr int NC = (DP + 31) / 32;
    const int r0 = (tid >> 5) * 16;
    float part[16];
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
      const int j = r0 + rr;
      const T* orow = o + row_off(b, q0 + min(j, valid - 1), h, a.HQ, S, dh);
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        if (j < valid && d < dh) acc = fmaf(rt::to_f(dOs[j * LD + d]), rt::to_f(orow[d]), acc);
      }
      part[rr] = acc;
    }
    float* del_g = a.delta + (static_cast<long long>(b) * a.HQ + h) * S;
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
      const float x = rt::warp_sum(part[rr]);
      if (lane == 0) {
        del_s[r0 + rr] = x;
        if (r0 + rr < valid) del_g[q0 + r0 + rr] = x;
      }
    }
    __syncwarp();
  }
  Tile tile;
  tile.init(Qs, dOs, lse2_s, del_s);
  if (t_begin < t_end) stage(t_begin);
  const float sl = a.scale * LOG2E;
  for (int t = t_begin; t < t_end; ++t) {
    rt::cp_async_wait_all();
    __syncthreads();  // tile t landed; every thread is done with tile t - 1
    if (t + 1 < t_end) stage(t + 1);
    const T* Kt = ring + (t & 1) * 2 * BK * LD;
    const int k0 = t * BK;
    // every row sees every key of the tile: no per-score mask
    if (valid == BQ && k0 + BK <= mk.hi(q0) && k0 >= mk.lo(q_last))
      tile.template step<false>(Qs, dOs, Kt, Kt + BK * LD, strip, sl, mk, q0, k0);
    else
      tile.template step<true>(Qs, dOs, Kt, Kt + BK * LD, strip, sl, mk, q0, k0);
  }
  T* dq = static_cast<T*>(a.dq);
  tile.store(
      [&](int r) -> T* { return r < valid ? dq + row_off(b, q0 + r, h, a.HQ, S, dh) : nullptr; },
      a.scale, dh);
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS, (DkvLayout<T, DP>::MIN_BLOCKS))
    flash_bwd_dkdv_kernel(const Args a) {
  using L = DkvLayout<T, DP>;
  using Tile = typename L::Tile;
  constexpr int BQS = L::BQS, LD = L::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + BKV * LD;
  T* ring = Vs + BKV * LD;  // two stages of {Q, dO}
  float* strip = reinterpret_cast<float*>(smem + L::TILES);
  float* vecs = strip + Tile::STRIP;  // two stages of {lse, delta}

  const int S = a.S, G = a.HQ / a.HKV, dh = a.dh, BH = a.B * a.HKV;
  const int bh = static_cast<int>(blockIdx.x % BH), b = bh / a.HKV, hk = bh % a.HKV;
  // the (key tile, chunk) of this block: the tiles' chunks in order
  int idx = static_cast<int>(blockIdx.x / BH), kt = 0, q_lo = 0, nq = 0, nch = 1;
  const int nkt = (S + BKV - 1) / BKV;
  for (; kt < nkt; ++kt) {
    const int2 r = query_tiles(kt, S, a.causal, a.window, BQS);
    q_lo = r.x, nq = r.y - r.x, nch = chunks_of(G * nq, a.chunk);
    if (idx < nch) break;
    idx -= nch;
  }
  if (kt == nkt) return;
  const int i_begin = idx * a.chunk, i_end = min(G * nq, i_begin + a.chunk);
  const int k0 = kt * BKV, kvalid = min(BKV, S - k0);
  const Mask mk{S, a.causal, a.window};
  const long long qs = static_cast<long long>(a.HQ) * dh, ks = static_cast<long long>(a.HKV) * dh;

  if (dh < DP) {
    zero_smem(smem, L::TILES);
    __syncthreads();
  }
  stage_tile(Ks, LD, static_cast<const T*>(a.k) + row_off(b, k0, hk, a.HKV, S, dh), ks, BKV,
             kvalid, dh, a.vec);
  stage_tile(Vs, LD, static_cast<const T*>(a.v) + row_off(b, k0, hk, a.HKV, S, dh), ks, BKV,
             kvalid, dh, a.vec);
  rt::cp_async_commit();
  // step i: query tile q_lo + i % nq of head hk * G + i / nq, into stage i & 1
  auto stage = [&](int i) {
    const int h = hk * G + i / nq, q0 = (q_lo + i % nq) * BQS, n = min(BQS, S - q0);
    T* Qd = ring + (i & 1) * 2 * BQS * LD;
    stage_tile(Qd, LD, static_cast<const T*>(a.q) + row_off(b, q0, h, a.HQ, S, dh), qs, BQS, n,
               dh, a.vec);
    stage_tile(Qd + BQS * LD, LD, static_cast<const T*>(a.dout) + row_off(b, q0, h, a.HQ, S, dh),
               qs, BQS, n, dh, a.vec);
    float* lv = vecs + (i & 1) * 2 * BQS;
    const long long row = (static_cast<long long>(b) * a.HQ + h) * S;
    for (int j = threadIdx.x; j < BQS; j += THREADS) {
      const bool ok = j < n;
      rt::cp_async<4>(lv + j, a.lse + row + (ok ? q0 + j : 0), ok);
      rt::cp_async<4>(lv + BQS + j, a.delta + row + (ok ? q0 + j : 0), ok);
    }
    rt::cp_async_commit();
  };
  Tile tile;
  tile.zero();
  if (i_begin < i_end) stage(i_begin);
  const float sl = a.scale * LOG2E;
  for (int i = i_begin; i < i_end; ++i) {
    rt::cp_async_wait_all();
    __syncthreads();  // step i landed (K and V with the first); step i - 1 is done
    if (i == i_begin) tile.load_kv(Ks, Vs);
    if (i + 1 < i_end) stage(i + 1);
    const T* Qt = ring + (i & 1) * 2 * BQS * LD;
    const float* lv = vecs + (i & 1) * 2 * BQS;
    const int q0 = (q_lo + i % nq) * BQS;
    // every query of the step sees every key of the tile
    if (q0 + BQS <= S && k0 + BKV <= mk.hi(q0) && k0 >= mk.lo(q0 + BQS - 1))
      tile.template step<false>(Ks, Vs, Qt, Qt + BQS * LD, lv, lv + BQS, strip, sl, mk, q0, k0);
    else
      tile.template step<true>(Ks, Vs, Qt, Qt + BQS * LD, lv, lv + BQS, strip, sl, mk, q0, k0);
  }
  if (nch == 1) {  // the tile's only chunk: the gradients themselves
    T* dk = static_cast<T*>(a.dk);
    T* dv = static_cast<T*>(a.dv);
    auto row = [&](T* base, int r) -> T* {
      return r < kvalid ? base + row_off(b, k0 + r, hk, a.HKV, S, dh) : nullptr;
    };
    tile.store([&](int r) { return row(dk, r); }, [&](int r) { return row(dv, r); }, a.scale, dh);
  } else {  // a partial, unscaled, in this block's slot
    float* pk = a.part + static_cast<long long>(blockIdx.x) * BKV * DP;
    float* pv = pk + static_cast<long long>(a.slots) * BKV * DP;
    tile.store([&](int r) -> float* { return r < kvalid ? pk + r * DP : nullptr; },
               [&](int r) -> float* { return r < kvalid ? pv + r * DP : nullptr; }, 1.f, dh);
  }
}

// A block per RED_ROWS keys of a key tile and (batch, KV head): the
// tile's chunk partials summed in chunk order, dK scaled, both written in
// T; every thread's loads of its element's partials in flight together.
// Tiles of one chunk return at once.
template <typename T, int DP>
__global__ void __launch_bounds__(RED_THREADS) flash_bwd_reduce_kernel(const Args a) {
  constexpr int BQS = DkvLayout<T, DP>::BQS, SPLIT = BKV / RED_ROWS;
  const int S = a.S, G = a.HQ / a.HKV, dh = a.dh, BH = a.B * a.HKV;
  const int rg = static_cast<int>(blockIdx.x % SPLIT), tile = static_cast<int>(blockIdx.x / SPLIT);
  const int bh = tile % BH, kt = tile / BH;
  int first = 0, nch = 1;  // the tile's first chunk, its chunks
  for (int t = 0; t <= kt; ++t) {
    const int2 r = query_tiles(t, S, a.causal, a.window, BQS);
    nch = chunks_of(G * (r.y - r.x), a.chunk);
    if (t < kt) first += nch;
  }
  const int b = bh / a.HKV, hk = bh % a.HKV, k0 = kt * BKV + rg * RED_ROWS;
  if (nch == 1 || k0 >= S) return;
  const int rows = min(RED_ROWS, S - k0);
  // chunk c of the tile ran as dkdv block (first + c) * BH + bh
  const float* pk = a.part + (static_cast<long long>(first) * BH + bh) * BKV * DP +
                    rg * RED_ROWS * DP;
  const float* pv = pk + static_cast<long long>(a.slots) * BKV * DP;
  const long long stride = static_cast<long long>(BH) * BKV * DP;
  T* dk = static_cast<T*>(a.dk);
  T* dv = static_cast<T*>(a.dv);
  for (int e = threadIdx.x; e < rows * dh; e += RED_THREADS) {
    const int r = e / dh, d = e - r * dh;
    float sk = 0.f, sv = 0.f;
    for (int c = 0; c < nch; ++c) {
      sk += pk[c * stride + r * DP + d];
      sv += pv[c * stride + r * DP + d];
    }
    const long long out = row_off(b, k0 + r, hk, a.HKV, S, dh) + d;
    dk[out] = rt::from_f<T>(sk * a.scale);
    dv[out] = rt::from_f<T>(sv);
  }
}

template <typename Op>
int dispatch(int dtype, int dh, const Op& op) {
  if (dtype == RT_F32) {
    if (dh <= 64) return op.template run<float, 64>();
    if (dh <= 80) return op.template run<float, 80>();
    if (dh <= 112) return op.template run<float, 112>();
    return op.template run<float, 128>();
  }
  if (dtype == RT_BF16) {
    if (dh <= 64) return op.template run<__nv_bfloat16, 64>();
    if (dh <= 80) return op.template run<__nv_bfloat16, 80>();
    if (dh <= 112) return op.template run<__nv_bfloat16, 112>();
    return op.template run<__nv_bfloat16, 128>();
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

struct Launch {
  Args a;
  int chunks;  // the key tiles' chunks, summed, as the caller counted them
  cudaStream_t stream;
  template <typename T, int DP>
  int run() const {
    auto dq_kernel = flash_bwd_dq_kernel<T, DP>;
    auto dkdv_kernel = flash_bwd_dkdv_kernel<T, DP>;
    cudaError_t err = rt::allow_smem(dq_kernel, DqLayout<T, DP>::BYTES);
    if (err == cudaSuccess) err = rt::allow_smem(dkdv_kernel, DkvLayout<T, DP>::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    // the caller's chunk count must be this instantiation's
    const int G = a.HQ / a.HKV, nkt = (a.S + BKV - 1) / BKV;
    int total = 0, split_end = 0;  // the chunks; one past the last split tile
    for (int kt = 0; kt < nkt; ++kt) {
      const int2 r = query_tiles(kt, a.S, a.causal, a.window, DkvLayout<T, DP>::BQS);
      const int n = chunks_of(G * (r.y - r.x), a.chunk);
      total += n;
      if (n > 1) split_end = kt + 1;
    }
    if (total != chunks) return static_cast<int>(cudaErrorInvalidValue);
    Args args = a;
    args.slots = chunks * a.B * a.HKV;
    const long long e = sizeof(T);
    // every row starts a whole number of rows of dh elements past its base
    args.vec = rt::vec_width(reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                                 reinterpret_cast<uintptr_t>(a.v) |
                                 reinterpret_cast<uintptr_t>(a.dout),
                             a.dh * e);
    const long long q_blocks = static_cast<long long>((a.S + BQ - 1) / BQ) * a.HQ * a.B;
    dq_kernel<<<static_cast<unsigned>(q_blocks), THREADS, DqLayout<T, DP>::BYTES, stream>>>(args);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dkdv_kernel<<<static_cast<unsigned>(args.slots), THREADS, DkvLayout<T, DP>::BYTES, stream>>>(
        args);
    err = cudaGetLastError();
    if (err != cudaSuccess || split_end == 0) return static_cast<int>(err);
    // the key tiles up to the last split one (those of one chunk return)
    const unsigned red_blocks = static_cast<unsigned>(split_end * a.B * a.HKV * (BKV / RED_ROWS));
    flash_bwd_reduce_kernel<T, DP><<<red_blocks, RED_THREADS, 0, stream>>>(args);
    return static_cast<int>(cudaGetLastError());
  }
};

struct Info {
  int* smem_bytes;     // [dq, dkdv]
  int* blocks_per_sm;  // [dq, dkdv]
  template <typename T, int DP>
  int run() const {
    using LQ = DqLayout<T, DP>;
    using LK = DkvLayout<T, DP>;
    auto dq_kernel = flash_bwd_dq_kernel<T, DP>;
    auto dkdv_kernel = flash_bwd_dkdv_kernel<T, DP>;
    cudaError_t err = rt::allow_smem(dq_kernel, LQ::BYTES);
    if (err == cudaSuccess) err = rt::allow_smem(dkdv_kernel, LK::BYTES);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, dq_kernel, THREADS,
                                                          LQ::BYTES);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm + 1, dkdv_kernel,
                                                          THREADS, LK::BYTES);
    smem_bytes[0] = static_cast<int>(LQ::BYTES);
    smem_bytes[1] = static_cast<int>(LK::BYTES);
    return static_cast<int>(err);
  }
};

}  // namespace

// q, o, dout, dq (B,S,HQ,dh) and k, v, dk, dv (B,S,HKV,dh), all
// contiguous; lse (B,HQ,S) fp32, the forward's; ws an fp32 workspace of
// B*HQ*S rounded up to 4 (delta), then, when some key tile has more than
// one chunk, 2 * chunks * B * HKV * 64 * DP (the partials). `chunk` is the
// dkdv block's most steps and `chunks` the key tiles' chunks summed
// (kernels/flash_attention.py: bwd_geometry); a count that is not this
// instantiation's is refused. dq, dk and dv are written whole, in the
// inputs' dtype. Self-attention only (Sq == Sk), dh <= 128.
extern "C" int rt_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                      const void* dout, const void* lse, void* dq, void* dk,
                                      void* dv, void* ws, int B, int S, int HQ, int HKV, int dh,
                                      int causal, int window, float scale, int chunk, int chunks,
                                      int dtype, void* stream) {
  if (dh < 1 || dh > 128 || HKV < 1 || HQ % HKV != 0 || chunk < 1 || lse == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  float* delta = static_cast<float*>(ws);
  float* part = delta + (static_cast<long long>(B) * HQ * S + 3) / 4 * 4;
  Args a{q, k, v, o, dout, static_cast<const float*>(lse), dq, dk, dv, delta, part,
         B, S, HQ, HKV, dh, causal, window, chunk, /*slots=*/0, /*vec=*/0, scale};
  return dispatch(dtype, dh, Launch{a, chunks, static_cast<cudaStream_t>(stream)});
}

// The dq and dkdv kernels' dynamic shared memory and blocks per SM for
// dtype at head dim dh.
extern "C" int rt_flash_bwd_info(int dtype, int dh, int* smem_bytes, int* blocks_per_sm) {
  if (dh < 1 || dh > 128) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dtype, dh, Info{smem_bytes, blocks_per_sm});
}
