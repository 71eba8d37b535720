// Slot-aware one-token decode attention (flash-decoding), for engine decode.
//
// Replaces the Pallas TPU kernel src/repro/kernels/slot_decode.py
// (slot_decode_attention :28, pallas_call :52) with its body
// decode_attention.py:_decode_kernel :22; the uniform decode_attention
// (decode_attention.py:55) broadcasts its (T,) mask and reaches this same
// kernel. The validity mask (circular-buffer occupancy, slot_pos >= 0, the
// sliding window) is precomputed per slot by the wrapper, exactly as in
// kernels/ops.py, so the kernel stays branch-free on positions. K and V
// are read in the engine's (B, T, HKV, dh) cache layout through their
// strides: no transpose copy.
//
// What bounds it: decode attention does 4*dh operations per cached key per
// query head against 2*dh*sizeof(T) bytes of K and V per key per KV head,
// so it is bound by the bytes of the live keys: one pass over them is the
// minimum. On the TPU the grid walked T in order; here the key range is
// split so that enough blocks stream at once to fill the card's memory
// system:
//
//   split   grid (HKV * head groups, B, nsplit). Split s of a slot owns
//           keys [s*T/nsplit, (s+1)*T/nsplit) (the wrapper's num_splits
//           keeps every split non-empty and at most MAX_SPLIT_KEYS long),
//           for the G query heads of one KV head (at most 8 a block, so
//           each K/V row is read once for all of them). It reads its keys'
//           valid bytes first, into a bit mask, and lists the key tiles
//           that hold a valid key: no other tile is copied, and inside a
//           live tile a masked key is zero-filled, never read. The live
//           tiles stream through a cp.async ring (16-byte copies where the
//           pointers, strides and dh*elem allow, 8, 4 or element copies
//           otherwise), the next tiles in flight under one tile's math.
//           With nsplit == 1 it writes the normalised output; else its
//           unnormalised fp32 O, running max m (log2 units) and sum l per
//           query head go to the wrapper's workspace.
//   combine one warp per (slot, query head): m* = max_s m_s and
//           O = sum_s 2^(m_s - m*) O_s / max(sum_s 2^(m_s - m*) l_s, 1e-30).
//           A split with no valid key has m_s = NEG_INF and adds nothing;
//           a row with no valid key anywhere writes zeros, the zero-row
//           rule of _decode_kernel.
//
// The math, per key tile in shared memory (it knows nothing of where the
// tile came from, so a paged decode can feed it through its block table):
//
//   fp32    FFMA (0.54 GFLOP at 32 slots x 2048 keys is ~8 us at the fp32
//           CUDA-core rate against a 40 us byte bound). A row of dh <= 8L
//           elements is spread over L = 8, 16 or 32 lanes, eight elements
//           a lane (the query's in registers, pre-scaled by scale *
//           log2(e)); the 32 / L lane groups of a warp take different keys,
//           each with its own online softmax, merged by shuffles at the end.
//   bf16    mma.sync m16n8k16 with the keys as M: S^T (16 keys x 8 heads) =
//           K Q^T, Q^T's B fragments in registers for the whole block, then
//           O^T (dh x 8 heads) += V^T P^T, V^T's A fragments by ldmatrix
//           .trans from the staged rows, P^T's B fragments from S^T's
//           accumulators by four shuffles, rounded to bf16 as the plain
//           version rounds p; fp32 sums, the row sum over the unrounded p.
//           Per 16 keys a warp issues 2 dh/16 mma where FFMA would take
//           ~1000 instructions: the tile is bound by its bytes again.
//
// Four warps take different keys of a tile; their states merge in shared
// memory at the end.
#include <type_traits>

#include "cp_async.cuh"
#include "register_tiles.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SPLIT_KEYS = 4096;    // kernels/slot_decode.py MAX_SPLIT_KEYS
constexpr int MASK_WORDS = MAX_SPLIT_KEYS / 32;
constexpr int MAX_TILES = MAX_SPLIT_KEYS / 8;  // fp32 at dh > 128: 8 keys a tile
constexpr size_t MASK_BYTES = MASK_WORDS * 4 + MAX_TILES * 2 + 16;
constexpr float LOG2E = 1.4426950408889634f;

// Everything a launch passes; strides in elements.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const unsigned char* valid;
  void* o;
  float* ws;  // nsplit > 1: (B, HQ, nsplit, dh) partial O, then (B, HQ, nsplit, 2) m, l
  int B, T, HQ, HKV, dh, nsplit;
  int vec;    // bytes per cp.async (16, 8, 4), or 0: element copies
  long long qsb, qsh, ksb, kst, ksh, vsb, vst, vsh, msb, osb, osh;
  float scale2;  // softmax scale times log2(e)
};

// A block's keys: split s of slot b, its valid bytes as a bit mask (bit i:
// key ks + i) and the list of its BK-key tiles that hold a valid key.
struct Split {
  int ks, n, nlive;
  const uint32_t* mask;
  const int16_t* tiles;

  __device__ __forceinline__ unsigned bit(int i) const { return (mask[i >> 5] >> (i & 31)) & 1u; }
};

// Reads the valid bytes (eight loads a thread in flight), then lists the
// live tiles; ends with a barrier. `smem` holds MASK_BYTES.
__device__ __forceinline__ Split split_keys(const Args& a, int b, int s, int BK,
                                            unsigned char* smem) {
  uint32_t* mask = reinterpret_cast<uint32_t*>(smem);
  int16_t* tiles = reinterpret_cast<int16_t*>(mask + MASK_WORDS);
  int* nlive = reinterpret_cast<int*>(tiles + MAX_TILES);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ks = static_cast<int>(static_cast<long long>(s) * a.T / a.nsplit);
  const int n = static_cast<int>(static_cast<long long>(s + 1) * a.T / a.nsplit) - ks;
  const int ntiles = (n + BK - 1) / BK, nbits = (ntiles * BK + 31) / 32 * 32;
  const unsigned char* mb = a.valid + b * a.msb + ks;
  for (int base = 0; base < nbits; base += 8 * THREADS) {
    bool f[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = base + r * THREADS + tid;
      f[r] = i < n && mb[i] != 0;
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (base + r * THREADS + warp * 32 < nbits) {  // whole warps
        const unsigned bits = __ballot_sync(0xffffffffu, f[r]);
        if (lane == 0) mask[(base + r * THREADS + warp * 32) >> 5] = bits;
      }
  }
  __syncthreads();
  if (warp == 0) {  // the live tiles, in order
    auto live = [&](int t) {
      const int k0 = t * BK;
      if (BK >= 32) {
        uint32_t any = 0;
        for (int w = 0; w < BK / 32; ++w) any |= mask[(k0 >> 5) + w];
        return any != 0;
      }
      return ((mask[k0 >> 5] >> (k0 & 31)) & ((1u << BK) - 1u)) != 0;
    };
    int count = 0;
    for (int t0 = 0; t0 < ntiles; t0 += 32) {
      const int t = t0 + lane;
      const unsigned lv = __ballot_sync(0xffffffffu, t < ntiles && live(t));
      if ((lv >> lane) & 1u) tiles[count + __popc(lv & ((1u << lane) - 1u))] = t;
      count += __popc(lv);
    }
    if (lane == 0) *nlive = count;
  }
  __syncthreads();
  return Split{ks, n, *nlive, mask, tiles};
}

// Copies live tile i of a split into a ring stage: BK rows of K, then BK of
// V, RS elements apart; a key with its bit set is copied, the rest
// zero-filled. V-byte cp.asyncs over the (row, chunk) walk advanced without
// division, or element copies.
template <typename T>
struct Stager {
  const T* kb;
  const T* vb;
  long long kst, vst;
  int dh, vec, BK, RS;
  int cpr, j0, c0, dj, dc;

  __device__ __forceinline__ Stager(const Args& a, int b, int hk, int BK_, int RS_)
      : kb(static_cast<const T*>(a.k) + b * a.ksb + hk * a.ksh),
        vb(static_cast<const T*>(a.v) + b * a.vsb + hk * a.vsh),
        kst(a.kst), vst(a.vst), dh(a.dh), vec(a.vec), BK(BK_), RS(RS_) {
    cpr = vec ? dh * static_cast<int>(sizeof(T)) / vec : 1;  // chunks per row
    const int tid = threadIdx.x;
    j0 = tid / cpr;
    c0 = tid % cpr;
    dj = THREADS / cpr;
    dc = THREADS % cpr;
  }

  template <int V>
  __device__ __forceinline__ void copy(const Split& sp, int i, T* dst) const {
    const int k0 = sp.tiles[i] * BK;
    char* Kd = reinterpret_cast<char*>(dst);
    char* Vd = Kd + BK * RS * sizeof(T);
    if constexpr (V > 0) {
      int j = j0, c = c0;
      while (j < BK) {
        const bool in = sp.bit(k0 + j);
        const long long key = sp.ks + (in ? k0 + j : 0);
        const int byte = c * V, row = j * RS * static_cast<int>(sizeof(T));
        rt::cp_async<V>(Kd + row + byte, reinterpret_cast<const char*>(kb + key * kst) + byte, in);
        rt::cp_async<V>(Vd + row + byte, reinterpret_cast<const char*>(vb + key * vst) + byte, in);
        j += dj;
        c += dc;
        if (c >= cpr) {
          c -= cpr;
          ++j;
        }
      }
    } else {
      T* Kt = reinterpret_cast<T*>(Kd);
      T* Vt = reinterpret_cast<T*>(Vd);
      for (int idx = threadIdx.x; idx < BK * dh; idx += THREADS) {
        const int j = idx / dh, d = idx - j * dh;
        const bool in = sp.bit(k0 + j);
        const long long key = sp.ks + k0 + j;
        Kt[j * RS + d] = in ? kb[key * kst + d] : rt::from_f<T>(0.f);
        Vt[j * RS + d] = in ? vb[key * vst + d] : rt::from_f<T>(0.f);
      }
    }
  }

  // Live tile i (if there is one) into `dst`, then a commit: empty groups
  // keep the count of groups in flight uniform.
  __device__ __forceinline__ void stage(const Split& sp, int i, T* dst) const {
    if (i < sp.nlive) {
      switch (vec) {
        case 16: copy<16>(sp, i, dst); break;
        case 8: copy<8>(sp, i, dst); break;
        case 4: copy<4>(sp, i, dst); break;
        default: copy<0>(sp, i, dst);
      }
    }
    rt::cp_async_commit();
  }
};

// The four warps' states of the block's GH heads, red_o[warp][head][DP] and
// red_ml[warp][head] = (m, l), merged: the normalised output (nsplit 1) or
// the split's partial O, m and l in the workspace.
template <typename T>
__device__ __forceinline__ void write_split(const Args& a, const float* red_o, const float* red_ml,
                                            int GH, int DP, int b, int hk, int hg, int s) {
  const int G = a.HQ / a.HKV, dh = a.dh;
  const long long row0 = static_cast<long long>(b) * a.HQ + static_cast<long long>(hk) * G;
  for (int idx = threadIdx.x; idx < GH * dh; idx += THREADS) {
    const int g = idx / dh, d = idx - g * dh, head = hg * GH + g;
    if (head >= G) continue;
    float ms = rt::NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) ms = fmaxf(ms, red_ml[(w * GH + g) * 2]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = rt::ex2(red_ml[(w * GH + g) * 2] - ms);
      den = fmaf(c, red_ml[(w * GH + g) * 2 + 1], den);
      num = fmaf(c, red_o[(w * GH + g) * DP + d], num);
    }
    if (a.nsplit == 1) {
      T* ob = static_cast<T*>(a.o) + b * a.osb + (static_cast<long long>(hk) * G + head) * a.osh;
      ob[d] = rt::from_f<T>(num / fmaxf(den, 1e-30f));
    } else {
      const long long r = (row0 + head) * a.nsplit + s;
      a.ws[r * dh + d] = num;
      if (d == 0) {
        float* ml = a.ws + static_cast<long long>(a.B) * a.HQ * a.nsplit * dh;
        ml[2 * r] = ms;
        ml[2 * r + 1] = den;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: FFMA, a key row over L lanes
// ---------------------------------------------------------------------------

constexpr int F32_STAGES = 4;
constexpr int F32_STAGE_BYTES = 16384;  // K + V of one key tile
constexpr int F32_U = 2;                // keys a lane group takes per tile
constexpr size_t F32_SMEM = F32_STAGES * F32_STAGE_BYTES + MASK_BYTES;

// Element e of a lane's eight: granules (4 floats) sub and sub + L of the
// row, so the eight lanes of a quarter-warp read 128 contiguous bytes.
__device__ __forceinline__ int lane_col(int sub, int L, int e) {
  return (sub + (e >> 2) * L) * 4 + (e & 3);
}

__device__ __forceinline__ void load_row(const float* row, int sub, int L, float (&f)[8]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float4 x = *reinterpret_cast<const float4*>(row + (sub + i * L) * 4);
    f[4 * i] = x.x;
    f[4 * i + 1] = x.y;
    f[4 * i + 2] = x.z;
    f[4 * i + 3] = x.w;
  }
}

template <int GH>
__global__ void __launch_bounds__(THREADS, 2) slot_decode_f32_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);

  const int G = a.HQ / a.HKV, NHG = (G + GH - 1) / GH;
  const int hk = blockIdx.x / NHG, hg = blockIdx.x % NHG, b = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, dh = a.dh;
  const int L = dh <= 64 ? 8 : dh <= 128 ? 16 : 32;  // lanes a key row
  const int KW = 32 / L, sub = lane % L, grp = lane / L, DP = 8 * L;
  const int BK = F32_STAGE_BYTES / 2 / (DP * 4);    // = 4 * F32_U * KW keys a tile

  // padding columns (dh < DP) of the ring stay zero: nothing writes them
  if (dh < DP) {
    uint4* z = reinterpret_cast<uint4*>(ring);
    for (int i = tid; i < F32_STAGES * F32_STAGE_BYTES / 16; i += THREADS)
      z[i] = make_uint4(0, 0, 0, 0);
  }
  // the query rows of this block's heads, pre-scaled, in registers
  float q[GH][8], o[GH][8], m[GH], l[GH];
  const float* qb = static_cast<const float*>(a.q) + b * a.qsb;
#pragma unroll
  for (int g = 0; g < GH; ++g) {
    const int head = hg * GH + g;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int d = lane_col(sub, L, e);
      q[g][e] = head < G && d < dh
                    ? qb[(static_cast<long long>(hk) * G + head) * a.qsh + d] * a.scale2
                    : 0.f;
      o[g][e] = 0.f;
    }
    m[g] = rt::NEG_INF;
    l[g] = 0.f;
  }
  const Split sp = split_keys(a, b, s, BK, smem + F32_STAGES * F32_STAGE_BYTES);
  const Stager<float> st(a, b, hk, BK, DP);
  auto stage_of = [&](int i) { return ring + (i % F32_STAGES) * 2 * BK * DP; };

#pragma unroll
  for (int i = 0; i < F32_STAGES - 1; ++i) st.stage(sp, i, stage_of(i));
  for (int i = 0; i < sp.nlive; ++i) {
    rt::cp_async_wait<F32_STAGES - 2>();
    __syncthreads();  // tile i landed; every thread is done with tile i - 1
    st.stage(sp, i + F32_STAGES - 1, stage_of(i + F32_STAGES - 1));  // under this tile's math
    const float* Ks = stage_of(i);
    const float* Vs = Ks + BK * DP;
    const int k0 = sp.tiles[i] * BK;
    // this lane group's keys of the tile: j = (warp * U + u) * KW + grp
    float sc[F32_U][GH];
    bool live[F32_U];
#pragma unroll
    for (int u = 0; u < F32_U; ++u) {
      const int j = (warp * F32_U + u) * KW + grp;
      live[u] = sp.bit(k0 + j);
      float kf[8];
      load_row(Ks + j * DP, sub, L, kf);
#pragma unroll
      for (int g = 0; g < GH; ++g) {
        float acc = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc = fmaf(q[g][e], kf[e], acc);
        sc[u][g] = acc;
      }
    }
    for (int off = L >> 1; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < F32_U; ++u)
#pragma unroll
        for (int g = 0; g < GH; ++g) sc[u][g] += __shfl_xor_sync(0xffffffffu, sc[u][g], off);
    // online softmax over the group's keys, in log2 units
#pragma unroll
    for (int g = 0; g < GH; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < F32_U; ++u) mx = live[u] ? fmaxf(mx, sc[u][g]) : mx;
      const float corr = rt::ex2(m[g] - mx);
      m[g] = mx;
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < F32_U; ++u) {
        const float p = live[u] ? rt::ex2(sc[u][g] - mx) : 0.f;
        sc[u][g] = p;
        sum += p;
      }
      l[g] = l[g] * corr + sum;
#pragma unroll
      for (int e = 0; e < 8; ++e) o[g][e] *= corr;
    }
#pragma unroll
    for (int u = 0; u < F32_U; ++u) {
      const int j = (warp * F32_U + u) * KW + grp;
      float vf[8];
      load_row(Vs + j * DP, sub, L, vf);
#pragma unroll
      for (int g = 0; g < GH; ++g)
#pragma unroll
        for (int e = 0; e < 8; ++e) o[g][e] = fmaf(sc[u][g], vf[e], o[g][e]);
    }
  }
  rt::cp_async_wait_all();

  // merge the lane groups of a warp (xor over the group bits of the lane)
  for (int off = L; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < GH; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float c1 = rt::ex2(m[g] - mn), c2 = rt::ex2(mo - mn);
      m[g] = mn;
      l[g] = l[g] * c1 + lo * c2;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        o[g][e] = o[g][e] * c1 + __shfl_xor_sync(0xffffffffu, o[g][e], off) * c2;
    }
  // then the four warps, through shared memory (the ring is free now)
  __syncthreads();
  float* red_o = ring;                      // [WARPS][GH][DP]
  float* red_ml = red_o + WARPS * GH * DP;  // [WARPS][GH][2]
  if (lane < L) {
#pragma unroll
    for (int g = 0; g < GH; ++g) {
#pragma unroll
      for (int e = 0; e < 8; ++e) red_o[(warp * GH + g) * DP + lane_col(sub, L, e)] = o[g][e];
      if (lane == 0) {
        red_ml[(warp * GH + g) * 2] = m[g];
        red_ml[(warp * GH + g) * 2 + 1] = l[g];
      }
    }
  }
  __syncthreads();
  write_split<float>(a, red_o, red_ml, GH, DP, b, hk, hg, s);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, the keys as M
// ---------------------------------------------------------------------------

constexpr int TC_BK = 64;     // keys a tile: 16 a warp
constexpr int TC_HEADS = 8;   // the mma's N: query heads a block

template <int DP>
struct TcLayout {
  static constexpr int LD = DP + 8;  // row stride: rows 16 bytes apart modulo 128,
                                     // so ldmatrix is conflict-free
  static constexpr int STAGES = DP == 64 ? 4 : DP == 128 ? 3 : 2;
  static constexpr size_t STAGE_ELEMS = 2 * TC_BK * LD;
  static constexpr size_t RING_BYTES = STAGES * STAGE_ELEMS * 2;
  static constexpr size_t BYTES = RING_BYTES + MASK_BYTES;
};

template <int DP>
__global__ void __launch_bounds__(THREADS) slot_decode_bf16_kernel(const Args a) {
  using bf = __nv_bfloat16;
  using Ly = TcLayout<DP>;
  constexpr int LD = Ly::LD, STAGES = Ly::STAGES, KT = DP / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf* ring = reinterpret_cast<bf*>(smem);

  const int G = a.HQ / a.HKV, NHG = (G + TC_HEADS - 1) / TC_HEADS;
  const int hk = blockIdx.x / NHG, hg = blockIdx.x % NHG, b = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, dh = a.dh;
  const int g = lane >> 2, t = lane & 3;

  if (dh < DP) {  // padding columns of the ring stay zero
    uint4* z = reinterpret_cast<uint4*>(ring);
    for (int i = tid; i < static_cast<int>(Ly::RING_BYTES / 16); i += THREADS)
      z[i] = make_uint4(0, 0, 0, 0);
  }
  // Q^T's B fragments (k = head dim, n = head g of the block): elements
  // 16kk + 2t, +1 and 16kk + 2t + 8, +9 of head g's row, as they are
  uint32_t qf[KT][2];
  {
    const int head = hg * TC_HEADS + g;
    const uint16_t* qr = reinterpret_cast<const uint16_t*>(
        static_cast<const bf*>(a.q) + b * a.qsb + (static_cast<long long>(hk) * G + head) * a.qsh);
    auto el = [&](int d) -> uint32_t { return head < G && d < dh ? qr[d] : 0u; };
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      const int d = 16 * kk + 2 * t;
      qf[kk][0] = el(d) | (el(d + 1) << 16);
      qf[kk][1] = el(d + 8) | (el(d + 9) << 16);
    }
  }
  // O^T: rows d = 16 mt + g (+ 8), columns heads 2t, 2t + 1
  float o[KT][4];
#pragma unroll
  for (int mt = 0; mt < KT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[mt][e] = 0.f;
  float m[2] = {rt::NEG_INF, rt::NEG_INF}, l[2] = {0.f, 0.f};  // l: this lane's keys

  const Split sp = split_keys(a, b, s, TC_BK, smem + Ly::RING_BYTES);
  const Stager<bf> st(a, b, hk, TC_BK, LD);
  auto stage_of = [&](int i) { return ring + (i % STAGES) * Ly::STAGE_ELEMS; };
  // P^T's B fragment for keys 2t, 2t + 1 (and + 8) of head g: from the lanes
  // holding S^T rows 2t and 2t + 1, their column pair 2(g / 2), +1
  const int src_a = 8 * t + (g >> 1), src_b = src_a + 4;
  const uint32_t sel = (g & 1) ? 0x7632u : 0x5410u;  // the half of head g

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) st.stage(sp, i, stage_of(i));
  for (int i = 0; i < sp.nlive; ++i) {
    rt::cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile i landed; every thread is done with tile i - 1
    st.stage(sp, i + STAGES - 1, stage_of(i + STAGES - 1));  // under this tile's math
    const bf* Ks = stage_of(i);
    const bf* Vs = Ks + TC_BK * LD;
    const int k0 = sp.tiles[i] * TC_BK;
    // S^T = K Q^T for this warp's 16 keys
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    const bf* ka = Ks + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t af[4];
      rt::ldmatrix_x4(af, ka + kk * 16);
      rt::mma_bf16(c, af, qf[kk][0], qf[kk][1]);
    }
    // online softmax per head over the warp's keys (rows g and g + 8)
    const bool live0 = sp.bit(k0 + warp * 16 + g), live1 = sp.bit(k0 + warp * 16 + g + 8);
    float sv[4] = {live0 ? c[0] * a.scale2 : rt::NEG_INF, live0 ? c[1] * a.scale2 : rt::NEG_INF,
                   live1 ? c[2] * a.scale2 : rt::NEG_INF, live1 ? c[3] * a.scale2 : rt::NEG_INF};
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = fmaxf(sv[h], sv[h + 2]);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[h], mx);
      corr[h] = rt::ex2(m[h] - mn);
      m[h] = mn;
      sv[h] = live0 ? rt::ex2(sv[h] - mn) : 0.f;
      sv[h + 2] = live1 ? rt::ex2(sv[h + 2] - mn) : 0.f;
      l[h] = l[h] * corr[h] + sv[h] + sv[h + 2];
    }
#pragma unroll
    for (int mt = 0; mt < KT; ++mt) {
      o[mt][0] *= corr[0];
      o[mt][1] *= corr[1];
      o[mt][2] *= corr[0];
      o[mt][3] *= corr[1];
    }
    const uint32_t p01 = rt::pack_bf16(sv[0], sv[1]), p23 = rt::pack_bf16(sv[2], sv[3]);
    const uint32_t xa = __shfl_sync(0xffffffffu, p01, src_a);
    const uint32_t xb = __shfl_sync(0xffffffffu, p01, src_b);
    const uint32_t ya = __shfl_sync(0xffffffffu, p23, src_a);
    const uint32_t yb = __shfl_sync(0xffffffffu, p23, src_b);
    const uint32_t pb0 = __byte_perm(xa, xb, sel), pb1 = __byte_perm(ya, yb, sel);
    // O^T += V^T P^T: V^T's A fragments by ldmatrix .trans of the V rows
    const bf* va = Vs + (warp * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int mt = 0; mt < KT; ++mt) {
      uint32_t af[4];
      rt::ldmatrix_x4_trans(af, va + mt * 16);
      rt::mma_bf16(o[mt], af, pb0, pb1);
    }
  }
  rt::cp_async_wait_all();
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) l[h] += __shfl_xor_sync(0xffffffffu, l[h], off);

  // the four warps, through shared memory (the ring is free now)
  __syncthreads();
  float* red_o = reinterpret_cast<float*>(smem);  // [WARPS][8][DP]
  float* red_ml = red_o + WARPS * TC_HEADS * DP;  // [WARPS][8][2]
#pragma unroll
  for (int mt = 0; mt < KT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red_o[(warp * TC_HEADS + 2 * t + (e & 1)) * DP + 16 * mt + g + (e >> 1) * 8] = o[mt][e];
  if (g == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      red_ml[(warp * TC_HEADS + 2 * t + h) * 2] = m[h];
      red_ml[(warp * TC_HEADS + 2 * t + h) * 2 + 1] = l[h];
    }
  }
  __syncthreads();
  write_split<bf>(a, red_o, red_ml, TC_HEADS, DP, b, hk, hg, s);
}

// One warp per (slot, query head): the splits' partial O, m and l merged.
template <typename T>
__global__ void __launch_bounds__(THREADS) slot_decode_combine_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const long long r = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (r >= static_cast<long long>(a.B) * a.HQ) return;
  const int b = static_cast<int>(r / a.HQ), h = static_cast<int>(r % a.HQ);
  const int ns = a.nsplit, dh = a.dh;
  const float* po = a.ws + r * ns * dh;
  const float* ml = a.ws + static_cast<long long>(a.B) * a.HQ * ns * dh + r * ns * 2;
  float ms = rt::NEG_INF;
  for (int s = lane; s < ns; s += 32) ms = fmaxf(ms, ml[2 * s]);
  ms = rt::warp_max(ms);
  float den = 0.f;
  for (int s = lane; s < ns; s += 32) den = fmaf(rt::ex2(ml[2 * s] - ms), ml[2 * s + 1], den);
  den = fmaxf(rt::warp_sum(den), 1e-30f);
  T* ob = static_cast<T*>(a.o) + b * a.osb + h * a.osh;
  for (int d = lane; d < dh; d += 32) {
    float num = 0.f;
    for (int s = 0; s < ns; ++s) num = fmaf(rt::ex2(ml[2 * s] - ms), po[s * dh + d], num);
    ob[d] = rt::from_f<T>(num / den);
  }
}

// The split kernel of a launch: fp32 by the query heads a block takes (G
// rounded up to a power of two, at most 8), bf16 by the padded head dim.
template <typename Op>
int dispatch(int dtype, int G, int dh, const Op& op) {
  if (dtype == RT_F32) {
    if (G <= 1) return op.template run<float>(slot_decode_f32_kernel<1>, F32_SMEM, 1);
    if (G <= 2) return op.template run<float>(slot_decode_f32_kernel<2>, F32_SMEM, 2);
    if (G <= 4) return op.template run<float>(slot_decode_f32_kernel<4>, F32_SMEM, 4);
    return op.template run<float>(slot_decode_f32_kernel<8>, F32_SMEM, 8);
  }
  if (dtype == RT_BF16) {
    using bf = __nv_bfloat16;
    if (dh <= 64) return op.template run<bf>(slot_decode_bf16_kernel<64>, TcLayout<64>::BYTES, 8);
    if (dh <= 128)
      return op.template run<bf>(slot_decode_bf16_kernel<128>, TcLayout<128>::BYTES, 8);
    return op.template run<bf>(slot_decode_bf16_kernel<256>, TcLayout<256>::BYTES, 8);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

struct Launch {
  Args a;
  cudaStream_t stream;
  template <typename T, typename K>
  int run(K kernel, size_t smem, int heads) const {
    cudaError_t err = rt::allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    Args args = a;
    const long long e = sizeof(T);
    args.vec = rt::vec_width(reinterpret_cast<uintptr_t>(a.k) | reinterpret_cast<uintptr_t>(a.v) |
                                 static_cast<unsigned long long>(
                                     (a.ksb | a.kst | a.ksh | a.vsb | a.vst | a.vsh) * e),
                             a.dh * e);
    const int G = a.HQ / a.HKV;
    dim3 grid(a.HKV * ((G + heads - 1) / heads), a.B, a.nsplit);
    kernel<<<grid, THREADS, smem, stream>>>(args);
    err = cudaGetLastError();
    if (err != cudaSuccess || a.nsplit == 1) return static_cast<int>(err);
    const long long rows = static_cast<long long>(a.B) * a.HQ;
    slot_decode_combine_kernel<T>
        <<<static_cast<unsigned>((rows + WARPS - 1) / WARPS), THREADS, 0, stream>>>(args);
    return static_cast<int>(cudaGetLastError());
  }
};

struct Info {
  int* smem_bytes;
  int* blocks_per_sm;
  template <typename T, typename K>
  int run(K kernel, size_t smem, int) const {
    cudaError_t err = rt::allow_smem(kernel, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, THREADS, smem);
    *smem_bytes = static_cast<int>(smem);
    return static_cast<int>(err);
  }
};

bool bad_shape(int HQ, int HKV, int dh, int T, int nsplit) {
  return dh < 1 || dh > 256 || HKV < 1 || HQ % HKV != 0 || nsplit < 1 ||
         (T > 0 && nsplit > T) || (T + nsplit - 1) / nsplit > MAX_SPLIT_KEYS;
}

}  // namespace

// q (B,HQ,dh), k/v (B,T,HKV,dh), valid (B,T) bool, o (B,HQ,dh); ws: with
// nsplit > 1, B*HQ*nsplit*(dh + 2) floats of workspace (unused, and may be
// null, at nsplit 1). `strides` (elements): q batch, q head; k batch, time,
// head; v batch, time, head; valid batch; o batch, o head. The last
// dimension of each is contiguous.
extern "C" int rt_slot_decode_attention(const void* q, const void* k, const void* v,
                                        const void* valid, void* o, void* ws, int B, int Tn,
                                        int HQ, int HKV, int dh, int nsplit,
                                        const long long* strides, float scale, int dtype,
                                        void* stream) {
  if (bad_shape(HQ, HKV, dh, Tn, nsplit) || (nsplit > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  const long long* st = strides;
  Args a{q,  k,  v,  static_cast<const unsigned char*>(valid), o, static_cast<float*>(ws),
         B,  Tn, HQ, HKV, dh, nsplit, 0,
         st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
         scale * LOG2E};
  return dispatch(dtype, HQ / HKV, dh, Launch{a, static_cast<cudaStream_t>(stream)});
}

// The split kernel's launch for a query type, group size G and head dim:
// its dynamic shared memory and how many of its blocks fit on one SM.
extern "C" int rt_slot_decode_info(int dtype, int G, int dh, int* smem_bytes,
                                   int* blocks_per_sm) {
  if (G < 1 || dh < 1 || dh > 256) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dtype, G, dh, Info{smem_bytes, blocks_per_sm});
}
