// MoE router: logits = x @ router in fp32, softmax, then k rounds of
// max / argmax / mask — the token's top-k experts and their probabilities.
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_route.py
// (_route_kernel :19, pallas_call :47). The Pallas kernel keeps the whole
// (D, E) router resident in VMEM across its grid over token tiles; a
// Hopper block holds at most 227 KB of shared memory, so here the blocks
// split the work three ways — a token tile, a slice of the experts and a
// slice of D — and one launch does all of it:
//
//  1. Each block forms its tile's partial logits over its (experts, D)
//     slice and writes them to a float32 workspace the wrapper owns.
//  2. Arrival tickets, also in the workspace: after its writes each block
//     takes a ticket on its (tile, expert slice) with an acq_rel atomic;
//     the block that arrives last adds the D slices' partials in slice
//     order into the tile's logits and resets the ticket for the next
//     call. With more than one expert slice, the last of those takes a
//     ticket on the tile and goes on. So one block per token tile sees its
//     logits whole. (A thread-block cluster summing the slices through
//     distributed shared memory measured slower at every decode shape.)
//  3. That block runs the softmax exp(l - max) / sum and k rounds of
//     argmax (ties to the lowest expert index, as jnp.argmax) with a mask
//     of the winner: the token's experts sit in its lanes' registers — a
//     warp a token at decode, so a round is two redux.sync and a register
//     update; 4 lanes a token at prefill (E <= 64), 8 tokens a warp at
//     once, so a round is a two-step shuffle-max. The (N, E) probabilities
//     never reach device memory.
//
// Three ways to form the partial logits (kernels/moe_route.py:
// route_geometry chooses, the one place the launch is decided):
//  * decode (N <= 64): a tile of TN = 1, 2, 4 or 8 tokens (a template),
//    x's slice staged in shared memory as fp32 (16-byte loads where x's
//    rows allow); each thread streams the router in 16-byte loads (8 bf16
//    or 4 fp32 experts), its rows in flight before x is staged, with
//    TN x VEC sums in registers; the threads of a column group cover D's
//    rows in residues, summed by warp shuffles and then across the 8 warps
//    in order. D is split over enough blocks that the router, read cold
//    from HBM, is in flight at once.
//  * bf16 prefill: 64-token tiles on the tensor cores (mma.sync m16n8k16,
//    bf16 in, fp32 sums; register_tiles.cuh's ldmatrix and mma helpers),
//    x and router chunks of 64 rows of D staged by cp.async in a
//    three-stage ring; each warp owns 16 tokens by the slice's 64 experts.
//    The expert slices of a tile are adjacent in the grid, so they share
//    its x through L2.
//  * fp32 prefill (and bf16 rows that are not 16-byte aligned): the same
//    tiles on the CUDA cores, chunks of 32 rows in a three-stage ring, an
//    8-token by 4-expert register micro-tile a thread. No TF32: the
//    reference computes in fp32.
// Every (token, expert) logit is formed in the same order whatever the
// expert (the same rows in the same order, the same shuffle tree, warps
// and D slices in order), so two equal router columns give bit-equal
// logits and the tie goes to the lower index.
//
// What bounds it: 2·N·D·E operations against N·D + D·E elements read, so
// bytes at the serving shapes — the router at decode, x at large N in
// bf16 — and the FFMA rate in fp32 at large N.
#include <cstdint>

#include "common.cuh"
#include "cp_async.cuh"
#include "register_tiles.cuh"

namespace {

enum { MODE_DECODE = 0, MODE_TC = 1, MODE_TILE = 2 };

constexpr int MAX_E = 2048;
constexpr int SLICE = 64;          // experts a slice holds (decode: at most)
constexpr int DEC_THREADS = 256, DEC_WARPS = 8;
constexpr int DEC_MAX_ROWS = 1024;  // rows of D a decode block stages
constexpr int DEC_BATCH = 8;        // router rows a thread has in flight
constexpr int PF_THREADS = 128;
constexpr int BM = 64;             // tokens a prefill tile
constexpr int KC = 32, STAGES = 3;        // FFMA tiles: rows of D a stage, stages
constexpr int KC_TC = 64, STAGES_TC = 3;  // tensor-core tiles
constexpr float LOWEST = -3.402823466e38f;

struct Args {
  const void* x;
  const void* w;
  float* gates;
  int* idx;
  float* partial;  // (splits, N, E): each D slice's sums, when splits > 1
  float* logits;   // (N, E)
  int* tickets;    // tiles * slices, then tiles; zero between calls
  int N, D, E, k;
  int cw, cg;      // experts a slice; (decode) column groups a slice
  int slices, splits, rows;
  int xwide;       // decode: x's rows and slices in whole 16-byte packs
};

template <typename T, int VEC>
struct alignas(16) Vec {
  T v[VEC];
};

// Shared memory past a kernel's own: the tile's whole logits when one
// expert slice holds them (tn x E floats).
__host__ __device__ __forceinline__ int tail_floats(int tn, int E, int slices) {
  return slices == 1 ? tn * E : 0;
}

// Softmax and top-k of the tile's tokens n0..n0+nt-1 from their logits (lg:
// rows of E, in shared memory or, `global`, in device memory). A token
// takes S lanes (a whole warp, or a group of S), a warp 32 / S tokens at
// once. Lane l of a group holds experts l, l + S, ... (at most MAXR) in
// registers: the logit, then the probability, then its key
// bits(p / sum) + 1 (0 once it has won). The sum goes lane by lane in
// expert order, then an xor-shuffle tree over the group. Each lane keeps
// its best (key << 32 | ~expert); a round's winner — the largest key, then
// the lowest expert, as k rounds of jnp.argmax with a mask — is two
// redux.sync over a warp (S 32) or a shuffle-max over the group, and the
// winner's lane drops it and takes its next best (every lane computes it,
// branch-free; only the winner's lane keeps it).
template <int S, int MAXR>
__device__ void top_k(const Args& a, int n0, int nt, const float* lg, bool global) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int sl = lane % S, per_warp = 32 / S;
  const int E = a.E;
  for (int t0 = warp * per_warp; t0 < nt; t0 += nw * per_warp) {  // uniform over the warp
    const int t = t0 + lane / S;
    const bool live = t < nt;
    const float* src = lg + static_cast<long long>(t) * E;
    float v[MAXR];
    float m = LOWEST;
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      const int e = sl + S * r;
      v[r] = LOWEST;
      if (live && e < E) v[r] = global ? __ldcg(src + e) : src[e];
      m = fmaxf(m, v[r]);
    }
    if (S == 32) {  // redux of the float's bits as an ordered int
      const int o = __float_as_int(m);
      const int r = __reduce_max_sync(0xffffffffu, o >= 0 ? o : o ^ 0x7fffffff);
      m = __int_as_float(r >= 0 ? r : r ^ 0x7fffffff);
    } else {
#pragma unroll
      for (int o = 1; o < S; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    }
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      if (sl + S * r < E) {
        v[r] = expf(v[r] - m);
        sum += v[r];
      }
    }
#pragma unroll
    for (int o = 1; o < S; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    unsigned long long best = 0;
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {  // ascending: strict > keeps the lowest expert
      const int e = sl + S * r;
      const unsigned key = e < E ? __float_as_uint(v[r] / sum) + 1u : 0u;
      v[r] = __uint_as_float(key);
      const unsigned long long c =
          (static_cast<unsigned long long>(key) << 32) | ~static_cast<unsigned>(e);
      if (key != 0u && c > best) best = c;
    }
    for (int j = 0; j < a.k; ++j) {
      unsigned key;
      int win;
      if (S == 32) {
        key = __reduce_max_sync(0xffffffffu, static_cast<unsigned>(best >> 32));
        win = static_cast<int>(__reduce_min_sync(
            0xffffffffu, static_cast<unsigned>(best >> 32) == key ? ~static_cast<unsigned>(best)
                                                                   : 0xffffffffu));
      } else {
        unsigned long long top = best;
#pragma unroll
        for (int o = 1; o < S; o <<= 1) {
          const unsigned long long other = __shfl_xor_sync(0xffffffffu, top, o);
          if (other > top) top = other;
        }
        key = static_cast<unsigned>(top >> 32);
        win = static_cast<int>(~static_cast<unsigned>(top));
      }
      if (live && sl == 0) {
        const long long n = n0 + t;
        a.gates[n * a.k + j] = __uint_as_float(key - 1u);
        a.idx[n * a.k + j] = win;
      }
      const bool mine = live && win % S == sl;
      unsigned long long nb = 0;
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        unsigned u = __float_as_uint(v[r]);
        if (mine && r == win / S) u = 0u;
        v[r] = __uint_as_float(u);
        const unsigned long long c =
            (static_cast<unsigned long long>(u) << 32) | ~static_cast<unsigned>(sl + S * r);
        if (u != 0u && c > nb) nb = c;
      }
      if (mine) best = nb;
    }
  }
}

// The top-k's instantiation by E: at decode a warp a token (a tile's few
// tokens spread over the warps), two, 16 or 64 experts a lane; at prefill
// (64 tokens on 4 warps) E <= 64 takes 4 lanes a token, 16 experts a
// lane, 8 tokens a warp at once.
template <bool PREFILL>
__device__ void top_k_by_e(const Args& a, int n0, int nt, const float* lg, bool global) {
  if (a.E <= 64) {
    if (PREFILL)
      top_k<4, 16>(a, n0, nt, lg, global);
    else
      top_k<32, 2>(a, n0, nt, lg, global);
  } else if (a.E <= 512) {
    top_k<32, 16>(a, n0, nt, lg, global);
  } else {
    top_k<32, 64>(a, n0, nt, lg, global);
  }
}

// Where a block's sums go: its D slice's partials (splits > 1), the
// logits in device memory (several expert slices), or the tile's logits in
// shared memory (lg_s). Rows are the tile's tokens, columns the experts.
__device__ __forceinline__ float* block_out(const Args& a, int split, int n0, float* lg_s) {
  if (a.splits > 1) return a.partial + (static_cast<long long>(split) * a.N + n0) * a.E;
  if (a.slices > 1) return a.logits + static_cast<long long>(n0) * a.E;
  return lg_s;
}

// Thread 0 takes the block's ticket on *tk after the block's writes (the
// barrier, then an acq_rel atomic at GPU scope: the writes before it are
// visible to whoever takes a later ticket, and the writes of earlier
// takers to this block); true in every thread of the block that arrived
// last, which resets the ticket for the next call.
__device__ __forceinline__ bool arrive_last(int* tk, int count) {
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0) {
    int old;
    asm volatile("atom.acq_rel.gpu.add.s32 %0, [%1], 1;" : "=r"(old) : "l"(tk) : "memory");
    last = old == count - 1;
    if (last) *tk = 0;
  }
  __syncthreads();
  return last;
}

// The last block's sum of one (token, expert) pair after another, PAIRS
// pairs of a thread and SPLITS of their D slices in flight at once, each
// pair's slices added in slice order (loads at clamped addresses, so no
// branch sits between them).
template <int PAIRS, int SPLITS>
__device__ void sum_splits(const Args& a, const float* src, float* out, int total, int cwv) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const long long stride = static_cast<long long>(a.N) * a.E;
  for (int i0 = tid; i0 < total; i0 += nthr * PAIRS) {
    float s[PAIRS];
    int off[PAIRS];
#pragma unroll
    for (int u = 0; u < PAIRS; ++u) {
      const int i = min(i0 + u * nthr, total - 1), t = i / cwv;
      off[u] = t * a.E + i - t * cwv;
      s[u] = 0.f;
    }
    for (int sp0 = 0; sp0 < a.splits; sp0 += SPLITS) {
      float v[SPLITS][PAIRS];
#pragma unroll
      for (int j = 0; j < SPLITS; ++j)
#pragma unroll
        for (int u = 0; u < PAIRS; ++u)
          v[j][u] = __ldcg(src + min(sp0 + j, a.splits - 1) * stride + off[u]);
#pragma unroll
      for (int j = 0; j < SPLITS; ++j)
#pragma unroll
        for (int u = 0; u < PAIRS; ++u)
          if (sp0 + j < a.splits) s[u] += v[j][u];
    }
#pragma unroll
    for (int u = 0; u < PAIRS; ++u)
      if (i0 + u * nthr < total) out[off[u]] = s[u];
  }
}

// After a block has written its sums (block_out): the arrival tickets, the
// last block's sum over the D slices (a decode tile's pairs take a slice
// each a thread, 16 in flight; a prefill tile's 16 pairs a thread, 4
// slices at a time), then the top-k by the block that sees the tile whole.
// lg_s: the shared memory past the kernel's own (tail_floats), the tile's
// logits when one expert slice holds them.
template <bool PREFILL>
__device__ void finish(const Args& a, int tile, int slice, int n0, int nt, float* lg_s) {
  if (a.splits > 1) {
    if (!arrive_last(a.tickets + tile * a.slices + slice, a.splits)) return;
    const int c0 = slice * a.cw, cwv = min(a.cw, a.E - c0);
    const float* src = a.partial + static_cast<long long>(n0) * a.E + c0;
    float* out = (a.slices > 1 ? a.logits + static_cast<long long>(n0) * a.E : lg_s) + c0;
    if (PREFILL)
      sum_splits<16, 4>(a, src, out, nt * cwv, cwv);
    else
      sum_splits<1, 16>(a, src, out, nt * cwv, cwv);
  }
  if (a.slices > 1) {
    if (!arrive_last(a.tickets + gridDim.z * a.slices + tile, a.slices)) return;
    top_k_by_e<PREFILL>(a, n0, nt, a.logits + static_cast<long long>(n0) * a.E, true);
    return;
  }
  __syncthreads();
  top_k_by_e<PREFILL>(a, n0, nt, lg_s, false);
}

// ---------------------------------------------------------------------------
// decode: a tile of TN tokens, the router streamed in 16-byte loads
// ---------------------------------------------------------------------------

template <typename T, int TN, bool WIDE>
__global__ void __launch_bounds__(DEC_THREADS) route_decode_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int VEC = 16 / sizeof(T);
  using P = Vec<T, VEC>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slice = blockIdx.x, split = blockIdx.y, tile = blockIdx.z;
  const int n0 = tile * TN, nt = min(TN, a.N - n0);
  const int c0 = slice * a.cw;
  const int d0 = split * a.rows, dn = min(a.rows, a.D - d0);
  const int cg = a.cg, rs = DEC_THREADS / cg;
  const int g = tid % cg, r = tid / cg;
  const int e0 = c0 + g * VEC;
  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);
  float* xs = smem;                    // [dn][TN]
  float* part = smem + a.rows * TN;    // [warp][TN][SLICE]
  float* tail = part + DEC_WARPS * TN * SLICE;

  // this thread's router rows: d0 + r + i * rs, i < nd, DEC_BATCH at a time;
  // the first batch is in flight before x is staged
  const int nd = (e0 < a.E && r < dn) ? (dn - r + rs - 1) / rs : 0;
  auto fetch = [&](int i, P& p) {
    const T* src = w + static_cast<long long>(d0 + r + i * rs) * a.E + e0;
    if constexpr (WIDE) {
      p = *reinterpret_cast<const P*>(src);
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) p.v[v] = e0 + v < a.E ? src[v] : rt::from_f<T>(0.f);
    }
  };
  P cur[DEC_BATCH];
#pragma unroll
  for (int u = 0; u < DEC_BATCH; ++u)
    if (u < nd) fetch(u, cur[u]);

  if (a.xwide) {  // VEC elements of a token's row a load, all of a thread's in flight
    const int dv = dn / VEC;
#pragma unroll 4
    for (int i = tid; i < dv * TN; i += DEC_THREADS) {
      const int t = i / dv, d = (i - t * dv) * VEC;
      P p;
      if (t < nt)
        p = *reinterpret_cast<const P*>(x + static_cast<long long>(n0 + t) * a.D + d0 + d);
#pragma unroll
      for (int v = 0; v < VEC; ++v) xs[(d + v) * TN + t] = t < nt ? rt::to_f(p.v[v]) : 0.f;
    }
  } else {
#pragma unroll 4
    for (int i = tid; i < dn * TN; i += DEC_THREADS) {
      const int t = i / dn, d = i - t * dn;  // consecutive threads: consecutive d
      xs[d * TN + t] =
          t < nt ? rt::to_f(x[static_cast<long long>(n0 + t) * a.D + d0 + d]) : 0.f;
    }
  }
  __syncthreads();

  float acc[TN][VEC];
#pragma unroll
  for (int t = 0; t < TN; ++t)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[t][v] = 0.f;
  for (int i0 = 0; i0 < nd; i0 += DEC_BATCH) {
    if (i0 > 0) {
#pragma unroll
      for (int u = 0; u < DEC_BATCH; ++u)
        if (i0 + u < nd) fetch(i0 + u, cur[u]);
    }
#pragma unroll
    for (int u = 0; u < DEC_BATCH; ++u) {
      if (i0 + u < nd) {
        const float* xr = xs + (r + (i0 + u) * rs) * TN;
        float xv[TN];
#pragma unroll
        for (int t = 0; t < TN; ++t) xv[t] = xr[t];
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const float wv = rt::to_f(cur[u].v[v]);
#pragma unroll
          for (int t = 0; t < TN; ++t) acc[t][v] = fmaf(xv[t], wv, acc[t][v]);
        }
      }
    }
  }

  // the residues of a column group: a shuffle tree within the warp, then
  // the warps in order
  for (int o = cg; o < 32; o <<= 1)
#pragma unroll
    for (int t = 0; t < TN; ++t)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[t][v] += __shfl_xor_sync(0xffffffffu, acc[t][v], o);
  if (lane < cg) {
#pragma unroll
    for (int t = 0; t < TN; ++t)
#pragma unroll
      for (int v = 0; v < VEC; ++v) part[(warp * TN + t) * SLICE + g * VEC + v] = acc[t][v];
  }
  __syncthreads();
  const int cwv = min(a.cw, a.E - c0);
  float* dst = block_out(a, split, n0, tail) + c0;
  for (int i = tid; i < nt * cwv; i += DEC_THREADS) {
    const int t = i / cwv, c = i - t * cwv;
    float s = 0.f;
#pragma unroll
    for (int ww = 0; ww < DEC_WARPS; ++ww) s += part[(ww * TN + t) * SLICE + c];
    dst[t * a.E + c] = s;
  }
  finish<false>(a, tile, slice, n0, nt, tail);
}

// ---------------------------------------------------------------------------
// prefill: 64-token tiles, chunks of 32 rows of D in a cp.async ring
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(PF_THREADS) route_tc_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  using bf = __nv_bfloat16;
  constexpr int XLD = KC_TC + 8;  // 144-byte rows: ldmatrix without conflicts
  constexpr int WLD = SLICE + 8;  // 144-byte rows
  constexpr int XS = BM * XLD, WS = KC_TC * WLD;
  bf* xs = reinterpret_cast<bf*>(smem);
  bf* ws = xs + STAGES_TC * XS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slice = blockIdx.x, split = blockIdx.y, tile = blockIdx.z;
  const int n0 = tile * BM, nt = min(BM, a.N - n0);
  const int c0 = slice * SLICE;
  const int d0 = split * a.rows, dn = min(a.rows, a.D - d0);
  const int nchunks = (dn + KC_TC - 1) / KC_TC;
  const bf* x = static_cast<const bf*>(a.x);
  const bf* w = static_cast<const bf*>(a.w);

  // 16-byte pieces; D and E are multiples of 8, so a piece is all in or out
  auto stage = [&](int ch, int buf) {
    for (int i = tid; i < BM * (KC_TC / 8); i += PF_THREADS) {
      const int t = i / (KC_TC / 8), d = ch * KC_TC + (i % (KC_TC / 8)) * 8;
      const bool ok = t < nt && d < dn;
      rt::cp_async<16>(xs + buf * XS + t * XLD + d - ch * KC_TC,
                       ok ? x + static_cast<long long>(n0 + t) * a.D + d0 + d : x, ok);
    }
    for (int i = tid; i < KC_TC * (SLICE / 8); i += PF_THREADS) {
      const int d = i / (SLICE / 8), e = (i % (SLICE / 8)) * 8;
      const bool ok = ch * KC_TC + d < dn && c0 + e < a.E;
      rt::cp_async<16>(ws + buf * WS + d * WLD + e,
                       ok ? w + static_cast<long long>(d0 + ch * KC_TC + d) * a.E + c0 + e : w, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES_TC - 1; ++s) {
    if (s < nchunks) stage(s, s);
    rt::cp_async_commit();
  }
  float acc[SLICE / 8][4];
#pragma unroll
  for (int n = 0; n < SLICE / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int ch = 0; ch < nchunks; ++ch) {
    rt::cp_async_wait<STAGES_TC - 2>();
    __syncthreads();
    if (ch + STAGES_TC - 1 < nchunks) stage(ch + STAGES_TC - 1, (ch + STAGES_TC - 1) % STAGES_TC);
    rt::cp_async_commit();
    const bf* xb = xs + (ch % STAGES_TC) * XS;
    const bf* wb = ws + (ch % STAGES_TC) * WS;
#pragma unroll
    for (int kk = 0; kk < KC_TC / 16; ++kk) {
      uint32_t af[4];
      rt::ldmatrix_x4(af, xb + (warp * 16 + (lane & 15)) * XLD + (lane >> 4) * 8 + kk * 16);
#pragma unroll
      for (int np = 0; np < SLICE / 16; ++np) {
        uint32_t b[4];
        rt::ldmatrix_x4_trans(
            b, wb + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * WLD + (lane >> 4) * 8 + np * 16);
        rt::mma_bf16(acc[2 * np], af, b[0], b[1]);
        rt::mma_bf16(acc[2 * np + 1], af, b[2], b[3]);
      }
    }
  }
  rt::cp_async_wait_all();

  // acc[n]: rows lane/4 and lane/4 + 8 of the warp's 16, experts 8n + 2(lane % 4), +1
  float* tail = smem + STAGES_TC * (XS + WS) / 2;
  float* dst = block_out(a, split, n0, tail);
#pragma unroll
  for (int n = 0; n < SLICE / 8; ++n) {
    const int e = c0 + 8 * n + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = warp * 16 + (lane >> 2) + 8 * h;
      if (t < nt && e < a.E) {
        float* o = dst + t * a.E + e;
        o[0] = acc[n][2 * h];
        if (e + 1 < a.E) o[1] = acc[n][2 * h + 1];
      }
    }
  }
  finish<true>(a, tile, slice, n0, nt, tail);
}

// T float: cp.async of V bytes (16 when D and E are multiples of 4 and the
// rows 16-byte aligned, else 4). T bfloat16 (rows not 16-byte aligned):
// V == 0, plain loads widened to fp32.
template <typename T, int V>
__global__ void __launch_bounds__(PF_THREADS) route_tile_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int XLD = KC + 4;     // 144-byte rows
  constexpr int WLD = SLICE + 4;  // 272-byte rows
  constexpr int XS = BM * XLD, WS = KC * WLD;
  float* xs = smem;
  float* ws = smem + STAGES * XS;
  const int tid = threadIdx.x;
  const int slice = blockIdx.x, split = blockIdx.y, tile = blockIdx.z;
  const int n0 = tile * BM, nt = min(BM, a.N - n0);
  const int c0 = slice * SLICE;
  const int d0 = split * a.rows, dn = min(a.rows, a.D - d0);
  const int nchunks = (dn + KC - 1) / KC;
  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);
  // tokens tg + 8i (i < 8) by experts 4eg..4eg+3
  const int eg = tid % 16, tg = tid / 16;

  auto stage = [&](int ch, int buf) {
    constexpr int PER = V > 0 ? V / 4 : 1;  // elements a copy
    for (int i = tid; i < BM * (KC / PER); i += PF_THREADS) {
      const int t = i / (KC / PER), d = ch * KC + (i % (KC / PER)) * PER;
      const bool ok = t < nt && d < dn;
      float* dst = xs + buf * XS + t * XLD + d - ch * KC;
      const T* src = x + static_cast<long long>(n0 + t) * a.D + d0 + d;
      if constexpr (V > 0)
        rt::cp_async<V>(dst, ok ? src : x, ok);
      else
        *dst = ok ? rt::to_f(*src) : 0.f;
    }
    for (int i = tid; i < KC * (SLICE / PER); i += PF_THREADS) {
      const int d = i / (SLICE / PER), e = (i % (SLICE / PER)) * PER;
      const bool ok = ch * KC + d < dn && c0 + e < a.E;
      float* dst = ws + buf * WS + d * WLD + e;
      const T* src = w + static_cast<long long>(d0 + ch * KC + d) * a.E + c0 + e;
      if constexpr (V > 0)
        rt::cp_async<V>(dst, ok ? src : w, ok);
      else
        *dst = ok ? rt::to_f(*src) : 0.f;
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nchunks) stage(s, s);
    rt::cp_async_commit();
  }
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int ch = 0; ch < nchunks; ++ch) {
    rt::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (ch + STAGES - 1 < nchunks) stage(ch + STAGES - 1, (ch + STAGES - 1) % STAGES);
    rt::cp_async_commit();
    const float* xb = xs + (ch % STAGES) * XS;
    const float* wb = ws + (ch % STAGES) * WS + 4 * eg;
#pragma unroll
    for (int k4 = 0; k4 < KC; k4 += 4) {
      float4 xv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        xv[i] = *reinterpret_cast<const float4*>(xb + (tg + 8 * i) * XLD + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 wv = *reinterpret_cast<const float4*>(wb + (k4 + kk) * WLD);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float xk = kk == 0 ? xv[i].x : kk == 1 ? xv[i].y : kk == 2 ? xv[i].z : xv[i].w;
          acc[i][0] = fmaf(xk, wv.x, acc[i][0]);
          acc[i][1] = fmaf(xk, wv.y, acc[i][1]);
          acc[i][2] = fmaf(xk, wv.z, acc[i][2]);
          acc[i][3] = fmaf(xk, wv.w, acc[i][3]);
        }
      }
    }
  }
  rt::cp_async_wait_all();

  float* tail = smem + STAGES * (XS + WS);
  float* dst = block_out(a, split, n0, tail);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = tg + 8 * i;
    if (t >= nt) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = c0 + 4 * eg + j;
      if (e < a.E) dst[t * a.E + e] = acc[i][j];
    }
  }
  finish<true>(a, tile, slice, n0, nt, tail);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Launch {
  void* kernel = nullptr;
  int threads = 0;
  size_t smem = 0;
};

template <typename T, bool WIDE>
void* decode_kernel(int tn) {
  switch (tn) {
    case 1: return reinterpret_cast<void*>(route_decode_kernel<T, 1, WIDE>);
    case 2: return reinterpret_cast<void*>(route_decode_kernel<T, 2, WIDE>);
    case 4: return reinterpret_cast<void*>(route_decode_kernel<T, 4, WIDE>);
    case 8: return reinterpret_cast<void*>(route_decode_kernel<T, 8, WIDE>);
    default: return nullptr;
  }
}



// The kernel, block and dynamic shared memory of a geometry; kernel null
// for one the geometry function never gives. `wide`: 16-byte rows (E, and
// for prefill D, multiples of the 16-byte pack, pointers aligned).
Launch pick(int mode, int dtype, int tn, int cg, int rows, int E, bool wide) {
  Launch l;
  const int vec = dtype == RT_F32 ? 4 : 8;
  const int cw = mode == MODE_DECODE ? cg * vec : SLICE;
  if (cw < 1) return l;
  const int slices = (E + cw - 1) / cw;
  if (mode == MODE_DECODE) {
    if (cg > 32 || (cg & (cg - 1)) != 0 || cw > SLICE || rows > DEC_MAX_ROWS) return l;
    l.threads = DEC_THREADS;
    l.smem = static_cast<size_t>(rows * tn + DEC_WARPS * tn * SLICE +
                                 tail_floats(tn, E, slices)) * 4;
    if (dtype == RT_F32)
      l.kernel = wide ? decode_kernel<float, true>(tn) : decode_kernel<float, false>(tn);
    else if (dtype == RT_BF16)
      l.kernel = wide ? decode_kernel<__nv_bfloat16, true>(tn)
                      : decode_kernel<__nv_bfloat16, false>(tn);
    return l;
  }
  if (tn != BM || rows % (mode == MODE_TC ? KC_TC : KC) != 0) return l;
  l.threads = PF_THREADS;
  if (mode == MODE_TC && dtype == RT_BF16 && wide) {
    l.kernel = reinterpret_cast<void*>(route_tc_kernel);
    l.smem = static_cast<size_t>(STAGES_TC) * (BM * (KC_TC + 8) + KC_TC * (SLICE + 8)) * 2 +
             static_cast<size_t>(tail_floats(BM, E, slices)) * 4;
  } else if (mode == MODE_TILE) {
    if (dtype == RT_F32)
      l.kernel = wide ? reinterpret_cast<void*>(route_tile_kernel<float, 16>)
                      : reinterpret_cast<void*>(route_tile_kernel<float, 4>);
    else if (dtype == RT_BF16 && !wide)
      l.kernel = reinterpret_cast<void*>(route_tile_kernel<__nv_bfloat16, 0>);
    l.smem = (static_cast<size_t>(STAGES) * (BM * (KC + 4) + KC * (SLICE + 4)) +
              tail_floats(BM, E, slices)) * 4;
  }
  return l;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x (N, D) and router (D, E) contiguous, both float32 or both bfloat16;
// gates (N, k) float32 and idx (N, k) int32 outputs. The geometry (mode,
// tn tokens a tile, cg column groups a decode slice, splits slices of
// `rows` rows of D) comes from kernels/moe_route.py's route_geometry, which
// also sizes the workspace: partial (splits, N, E) float32 when splits > 1,
// logits (N, E) float32, and tickets (tiles * slices + tiles) int32, zero
// before the first call and left zero by every call.
extern "C" int rt_moe_route(const void* x, const void* w, void* gates, void* idx, void* partial,
                            void* logits, void* tickets, int N, int D, int E, int k, int mode,
                            int tn, int cg, int splits, int rows, int dtype, void* stream) {
  if (N < 1 || D < 1 || E < 1 || E > MAX_E || k < 1 || k > E || tn < 1 || rows < 1 ||
      splits != (D + rows - 1) / rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = dtype == RT_F32 ? 4 : 8;
  const bool wide = mode == MODE_DECODE
                        ? E % vec == 0 && aligned16(w)
                        : E % vec == 0 && D % vec == 0 && aligned16(w) && aligned16(x);
  const Launch l = pick(mode, dtype, tn, cg, rows, E, wide);
  const int cw = mode == MODE_DECODE ? cg * vec : SLICE;
  const int tiles = (N + tn - 1) / tn;
  const int slices = (E + cw - 1) / cw;
  if (l.kernel == nullptr || tiles > 65535 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (l.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        l.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(l.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool xwide = D % vec == 0 && rows % vec == 0 && aligned16(x);
  Args a{x, w, static_cast<float*>(gates), static_cast<int*>(idx), static_cast<float*>(partial),
         static_cast<float*>(logits), static_cast<int*>(tickets), N, D, E, k, cw, cg, slices,
         splits, rows, xwide};
  void* args[] = {&a};
  const cudaError_t err = cudaLaunchKernel(l.kernel, dim3(slices, splits, tiles),
                                           dim3(l.threads), args, l.smem,
                                           static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory of a geometry's kernel and how many of its
// blocks fit on one SM (for the build log).
extern "C" int rt_moe_route_info(int mode, int dtype, int tn, int cg, int rows, int E, int wide,
                                 int* smem_bytes, int* blocks_per_sm) {
  const Launch l = pick(mode, dtype, tn, cg, rows, E, wide != 0);
  if (l.kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (l.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        l.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(l.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  *smem_bytes = static_cast<int>(l.smem);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, l.kernel, l.threads, l.smem));
}
