// Causal / sliding-window GQA flash attention backward: dQ, dK, dV.
//
// Replaces the backward of src/repro/kernels/flash_attention.py's
// custom_vjp (_flash_bwd :110-128). That one is no pallas_call: it
// recomputes attention blockwise through the chunked jnp reference
// (_sdpa_chunked) and differentiates it, so on the TPU the backward is
// XLA's. Here it is written by hand, FA2-style, in two launches on the
// caller's stream, and needs nothing saved from the forward but its
// output O:
//
//   1. dq kernel, a block per (batch, query head, 64-query tile): the
//      row log-sum-exp in a first pass over the key tiles the rows see
//      (online max and sum, recomputed rather than saved by the forward,
//      so the serving forward is untouched), delta = rowsum(dO * O), then
//      a second pass dQ = scale * sum_t dS_t K_t with P = exp(s - lse),
//      dP = dO V^T, dS = P * (dP - delta). lse and delta go to a (2, B,
//      HQ, S) fp32 workspace.
//   2. dkdv kernel, a block per (batch, KV head, 64-key tile): for each of
//      the G query heads of the group and each query tile that sees the
//      keys, recompute P and dS from lse and delta and accumulate
//      dV += P^T dO and dK += scale * dS^T Q in registers. GQA's sum over
//      the group happens inside the block.
//
// Deterministic: every output element is owned by one thread and summed
// in a fixed order (no atomics); row reductions are fixed shuffle trees.
// Masks are the forward's row limits: query p sees keys lo(p) <= t < hi(p)
// with hi = min(S, p + 1) when causal (else S) and lo = max(0, p - window
// + 1) with a window (else 0). Masked pairs give P = 0 exactly, so a key
// no query sees gets exact zeros, and a tile of padding rows writes
// nothing.
//
// What bounds it: the work is 4 products of dh per live (query, key)
// pair in the dkdv kernel and 4 in the dq kernel (one of them the lse
// pass), so operations. This first version runs them in fp32 on the CUDA
// cores from shared memory (4x4 micro-tiles a thread, the tiles widened to
// fp32 as they are staged, the head dim padded to 64 or 128 with zeros),
// for fp32 and bf16 storage alike: right first; wgmma and TMA are later
// work (ROADMAP §3).
#include "common.cuh"

namespace {

constexpr int BQ = 64, BK = 64, THREADS = 256;
constexpr int LDS = BK + 1;  // row stride of the (BQ, BK) P and dS tiles

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* lse;    // (B, HQ, S)
  float* delta;  // (B, HQ, S)
  int B, S, HQ, HKV, dh, causal, window;
  float scale;
};

template <int DP>
struct Layout {
  static constexpr int LD = DP + 1;  // odd: a warp reading a column hits 16 banks
  static constexpr size_t TILE = sizeof(float) * BQ * LD;
  static constexpr size_t SCORES = sizeof(float) * BQ * LDS;
  static constexpr size_t ROWS = sizeof(float) * BQ;
  // dq kernel: Q, dO, K, V, dS, lse, delta
  static constexpr size_t DQ_BYTES = 4 * TILE + SCORES + 2 * ROWS;
  // dkdv kernel: K, V, Q, dO, P, dS, lse, delta
  static constexpr size_t DKV_BYTES = 4 * TILE + 2 * SCORES + 2 * ROWS;
};

struct Mask {
  int S, causal, window;
  __device__ __forceinline__ int hi(int p) const { return causal ? min(S, p + 1) : S; }
  __device__ __forceinline__ int lo(int p) const { return window > 0 ? max(0, p - window + 1) : 0; }
  __device__ __forceinline__ bool ok(int p, int t) const {
    return p < S && t < S && t >= lo(p) && t < hi(p);
  }
};

__device__ __forceinline__ long long row_off(int b, int s, int h, int H, int S, int dh) {
  return ((static_cast<long long>(b) * S + s) * H + h) * dh;
}

// 64 rows s0 .. s0 + 63 of head h of a contiguous (B, S, H, dh) tensor,
// widened to fp32 into a (64, DP + 1) tile; rows past S and columns past
// dh are zero.
template <typename T, int DP>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int b, int s0, int h, int H,
                                          int S, int dh) {
  constexpr int LD = DP + 1;
  for (int idx = threadIdx.x; idx < BQ * DP; idx += THREADS) {
    const int j = idx / DP, d = idx % DP, s = s0 + j;
    dst[j * LD + d] = (s < S && d < dh) ? rt::to_f(src[row_off(b, s, h, H, S, dh) + d]) : 0.f;
  }
}

// acc[i][j] = sum_d A[r][d] * Bm[c][d], r = 4 tr + i, c = tc + 16 j: a
// (64, 64) product of two row-major tiles over the padded head dim.
template <int DP>
__device__ __forceinline__ void dot_tile(float (&acc)[4][4], const float* A, const float* Bm,
                                         int tr, int tc) {
  constexpr int LD = DP + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DP; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = A[(tr * 4 + i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = Bm[(tc + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// acc[i][j] += sum_q Pm[q][r] * Bm[q][c], r = 4 tr + i, c = tc + 16 j:
// (P^T B) for a (BQ, BK) score tile P and a (BQ, DP) row tile B.
template <int DP>
__device__ __forceinline__ void tn_accum(float (&acc)[4][DP / 16], const float* Pm,
                                         const float* Bm, int tr, int tc) {
  constexpr int LD = DP + 1;
#pragma unroll 4
  for (int q = 0; q < BQ; ++q) {
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = Pm[q * LDS + tr * 4 + i];
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) {
      const float y = Bm[q * LD + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(x[i], y, acc[i][j]);
    }
  }
}

// acc[i][j] += sum_t Pm[r][t] * Bm[t][c]: (P B) for a (BQ, BK) score tile
// and a (BK, DP) row tile.
template <int DP>
__device__ __forceinline__ void nn_accum(float (&acc)[4][DP / 16], const float* Pm,
                                         const float* Bm, int tr, int tc) {
  constexpr int LD = DP + 1;
#pragma unroll 4
  for (int t = 0; t < BK; ++t) {
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = Pm[(tr * 4 + i) * LDS + t];
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) {
      const float y = Bm[t * LD + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(x[i], y, acc[i][j]);
    }
  }
}

// Reductions over the 16 lanes that share a row (a half warp).
__device__ __forceinline__ float max16(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float sum16(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Write a (64, DP) register tile, rows r = 4 tr + i of rows s0 .., times
// `mul`, into a contiguous (B, S, H, dh) tensor.
template <typename T, int DP>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[4][DP / 16], float mul,
                                           int b, int s0, int h, int H, int S, int dh, int tr,
                                           int tc) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = s0 + tr * 4 + i;
    if (s >= S) continue;
    T* row = dst + row_off(b, s, h, H, S, dh);
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) {
      const int d = tc + 16 * j;
      if (d < dh) row[d] = rt::from_f<T>(acc[i][j] * mul);
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq_kernel(const Args a) {
  constexpr int LD = DP + 1, NJ = DP / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* dSs = Vs + BK * LD;
  float* lse_s = dSs + BQ * LDS;
  float* del_s = lse_s + BQ;

  // heaviest query tiles first: under the causal mask the last see most keys
  const int S = a.S, G = a.HQ / a.HKV, dh = a.dh;
  const int nqt = (S + BQ - 1) / BQ, per = a.HQ * a.B;
  const int qt = nqt - 1 - static_cast<int>(blockIdx.x / per);
  const int h = static_cast<int>(blockIdx.x % per) % a.HQ;
  const int b = static_cast<int>(blockIdx.x % per) / a.HQ;
  const int hk = h / G, q0 = qt * BQ;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15, lane = tid & 31;
  const Mask mk{S, a.causal, a.window};
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* o = static_cast<const T*>(a.o);
  const T* dout = static_cast<const T*>(a.dout);

  load_rows<T, DP>(Qs, q, b, q0, h, a.HQ, S, dh);
  load_rows<T, DP>(dOs, dout, b, q0, h, a.HQ, S, dh);
  // delta = rowsum(dO * O), a warp a row
  for (int j = tid >> 5; j < BQ; j += THREADS / 32) {
    const int s = q0 + j;
    float acc = 0.f;
    if (s < S) {
      const long long off = row_off(b, s, h, a.HQ, S, dh);
      for (int d = lane; d < dh; d += 32) acc = fmaf(rt::to_f(dout[off + d]), rt::to_f(o[off + d]), acc);
    }
    acc = rt::warp_sum(acc);
    if (lane == 0) del_s[j] = acc;
  }

  // the key tiles any row of the tile sees: both limits grow with p
  const int q_last = min(q0 + BQ, S) - 1;
  const int k_lo = mk.lo(q0), k_hi = mk.hi(q_last);
  const int t_begin = k_lo / BK, t_end = k_lo < k_hi ? (k_hi + BK - 1) / BK : t_begin;

  // pass 1: the row log-sum-exp, online over the key tiles
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -inf(), l[i] = 0.f;
  for (int t = t_begin; t < t_end; ++t) {
    __syncthreads();  // nobody reads the previous K tile any more
    load_rows<T, DP>(Ks, k, b, t * BK, hk, a.HKV, S, dh);
    __syncthreads();
    float s[4][4];
    dot_tile<DP>(s, Qs, Ks, tr, tc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = q0 + tr * 4 + i;
      float mx = -inf();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = mk.ok(p, t * BK + tc + 16 * j) ? s[i][j] * a.scale : -inf();
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      const float base = m_new == -inf() ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += expf(s[i][j] - base);
      l[i] = l[i] * expf(m[i] - base) + sum16(sum);
      m[i] = m_new;
    }
  }
  float* lse_g = a.lse + (static_cast<long long>(b) * a.HQ + h) * S;
  float* del_g = a.delta + (static_cast<long long>(b) * a.HQ + h) * S;
  if (tc == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr * 4 + i;
      // a row that sees no key: +inf, so every P of it is exactly 0
      lse_s[r] = l[i] > 0.f ? m[i] + logf(l[i]) : inf();
      if (q0 + r < S) lse_g[q0 + r] = lse_s[r];
    }
  }
  for (int j = tid; j < BQ; j += THREADS)
    if (q0 + j < S) del_g[q0 + j] = del_s[j];

  // pass 2: dQ = scale * sum_t dS_t K_t
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  for (int t = t_begin; t < t_end; ++t) {
    __syncthreads();  // K, V and dS of the previous tile are read
    load_rows<T, DP>(Ks, k, b, t * BK, hk, a.HKV, S, dh);
    load_rows<T, DP>(Vs, v, b, t * BK, hk, a.HKV, S, dh);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<DP>(s, Qs, Ks, tr, tc);
    dot_tile<DP>(dp, dOs, Vs, tr, tc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr * 4 + i, p = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tc + 16 * j;
        const float P = mk.ok(p, t * BK + c) ? expf(s[i][j] * a.scale - lse_s[r]) : 0.f;
        dSs[r * LDS + c] = P * (dp[i][j] - del_s[r]);
      }
    }
    __syncthreads();
    nn_accum<DP>(acc, dSs, Ks, tr, tc);
  }
  store_rows<T, DP>(static_cast<T*>(a.dq), acc, a.scale, b, q0, h, a.HQ, S, dh, tr, tc);
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dkdv_kernel(const Args a) {
  constexpr int LD = DP + 1, NJ = DP / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;
  float* dSs = Ps + BQ * LDS;
  float* lse_s = dSs + BQ * LDS;
  float* del_s = lse_s + BQ;

  // heaviest key tiles first: under the causal mask the first are seen most
  const int S = a.S, G = a.HQ / a.HKV, dh = a.dh;
  const int per = a.HKV * a.B;
  const int kt = static_cast<int>(blockIdx.x / per);
  const int hk = static_cast<int>(blockIdx.x % per) % a.HKV;
  const int b = static_cast<int>(blockIdx.x % per) / a.HKV;
  const int k0 = kt * BK, k_last = min(k0 + BK, S) - 1;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const Mask mk{S, a.causal, a.window};
  const T* q = static_cast<const T*>(a.q);
  const T* dout = static_cast<const T*>(a.dout);

  load_rows<T, DP>(Ks, static_cast<const T*>(a.k), b, k0, hk, a.HKV, S, dh);
  load_rows<T, DP>(Vs, static_cast<const T*>(a.v), b, k0, hk, a.HKV, S, dh);

  // the queries that see any key of the tile: hi(p) > k0 and lo(p) <= k_last
  const int q_lo = a.causal ? k0 : 0;
  const int q_hi = a.window > 0 ? min(S, k_last + a.window) : S;

  float dk[4][NJ], dv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = 0.f, dv[i][j] = 0.f;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const float* lse_g = a.lse + (static_cast<long long>(b) * a.HQ + h) * S;
    const float* del_g = a.delta + (static_cast<long long>(b) * a.HQ + h) * S;
    for (int q0 = q_lo / BQ * BQ; q0 < q_hi; q0 += BQ) {
      __syncthreads();  // the previous tile's Q, dO, P and dS are read
      load_rows<T, DP>(Qs, q, b, q0, h, a.HQ, S, dh);
      load_rows<T, DP>(dOs, dout, b, q0, h, a.HQ, S, dh);
      for (int j = tid; j < BQ; j += THREADS) {
        const bool in = q0 + j < S;
        lse_s[j] = in ? lse_g[q0 + j] : inf();
        del_s[j] = in ? del_g[q0 + j] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      dot_tile<DP>(s, Qs, Ks, tr, tc);
      dot_tile<DP>(dp, dOs, Vs, tr, tc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = tr * 4 + i, p = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tc + 16 * j;
          const float P = mk.ok(p, k0 + c) ? expf(s[i][j] * a.scale - lse_s[r]) : 0.f;
          Ps[r * LDS + c] = P;
          dSs[r * LDS + c] = P * (dp[i][j] - del_s[r]);
        }
      }
      __syncthreads();
      tn_accum<DP>(dv, Ps, dOs, tr, tc);
      tn_accum<DP>(dk, dSs, Qs, tr, tc);
    }
  }
  store_rows<T, DP>(static_cast<T*>(a.dk), dk, a.scale, b, k0, hk, a.HKV, S, dh, tr, tc);
  store_rows<T, DP>(static_cast<T*>(a.dv), dv, 1.f, b, k0, hk, a.HKV, S, dh, tr, tc);
}

template <typename Op>
int dispatch(int dtype, int dh, const Op& op) {
  if (dtype == RT_F32) return dh <= 64 ? op.template run<float, 64>() : op.template run<float, 128>();
  if (dtype == RT_BF16)
    return dh <= 64 ? op.template run<__nv_bfloat16, 64>() : op.template run<__nv_bfloat16, 128>();
  return static_cast<int>(cudaErrorInvalidValue);
}

struct Launch {
  Args a;
  cudaStream_t stream;
  template <typename T, int DP>
  int run() const {
    using L = Layout<DP>;
    auto dq_kernel = flash_bwd_dq_kernel<T, DP>;
    auto dkdv_kernel = flash_bwd_dkdv_kernel<T, DP>;
    cudaError_t err = rt::allow_smem(dq_kernel, L::DQ_BYTES);
    if (err == cudaSuccess) err = rt::allow_smem(dkdv_kernel, L::DKV_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long tiles = (a.S + BQ - 1) / BQ;
    dq_kernel<<<static_cast<unsigned>(tiles * a.HQ * a.B), THREADS, L::DQ_BYTES, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dkdv_kernel<<<static_cast<unsigned>(tiles * a.HKV * a.B), THREADS, L::DKV_BYTES, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
};

struct Info {
  int* smem_bytes;     // [dq, dkdv]
  int* blocks_per_sm;  // [dq, dkdv]
  template <typename T, int DP>
  int run() const {
    using L = Layout<DP>;
    auto dq_kernel = flash_bwd_dq_kernel<T, DP>;
    auto dkdv_kernel = flash_bwd_dkdv_kernel<T, DP>;
    cudaError_t err = rt::allow_smem(dq_kernel, L::DQ_BYTES);
    if (err == cudaSuccess) err = rt::allow_smem(dkdv_kernel, L::DKV_BYTES);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, dq_kernel, THREADS,
                                                          L::DQ_BYTES);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm + 1, dkdv_kernel,
                                                          THREADS, L::DKV_BYTES);
    smem_bytes[0] = static_cast<int>(L::DQ_BYTES);
    smem_bytes[1] = static_cast<int>(L::DKV_BYTES);
    return static_cast<int>(err);
  }
};

}  // namespace

// q, o, dout, dq (B,S,HQ,dh) and k, v, dk, dv (B,S,HKV,dh), all
// contiguous; ws a (2, B, HQ, S) fp32 workspace (lse, then delta). dq, dk
// and dv are written whole, in the inputs' dtype. Self-attention only
// (Sq == Sk), dh <= 128.
extern "C" int rt_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                      const void* dout, void* dq, void* dk, void* dv, void* ws,
                                      int B, int S, int HQ, int HKV, int dh, int causal,
                                      int window, float scale, int dtype, void* stream) {
  if (dh < 1 || dh > 128 || HKV < 1 || HQ % HKV != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return static_cast<int>(cudaGetLastError());
  float* lse = static_cast<float*>(ws);
  float* delta = lse + static_cast<long long>(B) * HQ * S;
  Args a{q, k, v, o, dout, dq, dk, dv, lse, delta, B, S, HQ, HKV, dh, causal, window, scale};
  return dispatch(dtype, dh, Launch{a, static_cast<cudaStream_t>(stream)});
}

// The two kernels' dynamic shared memory and blocks per SM (dq, then
// dkdv) for dtype at head dim dh.
extern "C" int rt_flash_bwd_info(int dtype, int dh, int* smem_bytes, int* blocks_per_sm) {
  if (dh < 1 || dh > 128) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dtype, dh, Info{smem_bytes, blocks_per_sm});
}
