// One-token decode attention (flash-decoding) over slot rows or a block
// pool, for engine decode: one split core, two key sources.
//
// Replaces the Pallas TPU kernels src/repro/kernels/slot_decode.py
// (slot_decode_attention :28, pallas_call :52) with its body
// decode_attention.py:_decode_kernel :22 (the uniform decode_attention,
// decode_attention.py:55, broadcasts its (T,) mask and reaches this same
// kernel), and src/repro/kernels/paged_decode.py (paged_decode_attention,
// pallas_call :135, bodies _paged_kernel :29 and the fused-dequant
// _paged_kernel_quant :37). The validity mask (circular-buffer occupancy,
// slot_pos >= 0, the sliding window; a paged slot's resident prefix) is
// precomputed per slot by the wrapper, exactly as in kernels/ops.py, so the
// kernel stays branch-free on positions.
//
// Where key t of slot b lives is the one thing the two sources differ in:
//
//   slot rows  the engine's (B, T, HKV, dh) cache, read in place through
//              its strides: k + b*ksb + t*kst + hk*ksh.
//   paged      a pool (P+1, bs, HKV, dh) of fixed-size blocks; slot b's
//              chain is its row of the (B, nb) block table, so key t is at
//              pool row r = tables[b, t / bs], offset t % bs:
//              kp + r*ksb + (t % bs)*kst + hk*ksh. Row P is the trash block
//              (empty and finished slots point there) and a chain's last
//              block has a stale tail; the mask keeps both out, and a
//              masked key is never read. On the TPU the table was
//              scalar-prefetched into a BlockSpec index map and the DMA
//              engine did the gather; here the stager resolves it: thread j
//              of a block reads key j's table entry (and, for a quantized
//              pool, its block's K and V scale) into a small ring of key
//              slots, the table loads two tiles and the scale loads one
//              tile ahead of the copies, in flight under a tile's math. No
//              split's table slice is ever held whole (it is up to
//              MAX_SPLIT_KEYS / bs entries).
//
// Quantized pools (kv_dtype int8 / fp8, kernels/kv_quant.py): 1-byte codes
// with one f32 scale per (block, KV head) in ks/vs (P+1, HKV). The codes
// land in the ring raw (16-byte copies where dh and the strides allow) and
// are decoded on chip by kv_codes.cuh. fp32 queries: code * scale in fp32
// as a row is loaded into registers, bit for bit the plain version's
// decode (kernels/ref.py gather_pool). bf16 queries: one convert pass turns
// a tile's codes into bf16 (exact for both formats) for ldmatrix, and the
// scales fold out of the tile as in paged_prefill.cu: the K scale
// multiplies the key's score, the V scale its probability before P is
// rounded to bf16, and the row sum takes the unscaled probability.
//
// What bounds it: decode attention does 4*dh operations per cached key per
// query head against 2*dh*elem bytes of K and V per key per KV head, so it
// is bound by the bytes of the live keys: one pass over them is the
// minimum. On the TPU the grid walked T in order; here the key range is
// split so that enough blocks stream at once to fill the card's memory
// system:
//
//   split   grid (HKV * head groups, B, nsplit). Split s of a slot owns
//           keys [s*T/nsplit, (s+1)*T/nsplit) (the wrapper's num_splits
//           keeps every split non-empty and at most MAX_SPLIT_KEYS long;
//           paged: T = nb*bs), for the G query heads of one KV head (at
//           most 8 a block, so each K/V row is read once for all of them).
//           It reads its keys' valid bytes first, into a bit mask, and
//           lists the key tiles that hold a valid key: no other tile is
//           copied, and inside a live tile a masked key is zero-filled,
//           never read. The live tiles stream through a cp.async ring
//           (16-byte copies where the pointers, strides and dh*elem allow,
//           8, 4 or element copies otherwise), the next tiles in flight
//           under one tile's math. With nsplit == 1 it writes the
//           normalised output; else its unnormalised fp32 O, running max m
//           (log2 units) and sum l per query head go to the wrapper's
//           workspace.
//   combine one warp per (slot, query head): m* = max_s m_s and
//           O = sum_s 2^(m_s - m*) O_s / max(sum_s 2^(m_s - m*) l_s, 1e-30).
//           A split with no valid key has m_s = NEG_INF and adds nothing;
//           a row with no valid key anywhere writes zeros, the zero-row
//           rule of _decode_kernel.
//
// The math, per key tile in shared memory (it knows nothing of where the
// tile came from):
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
//           ~1000 instructions: the tile is bound by its bytes again. A
//           quantized pool's scales are per-row factors on S^T and P^T.
//
// Four warps take different keys of a tile; their states merge in shared
// memory at the end.
#include <cuda_fp8.h>

#include <type_traits>

#include "cp_async.cuh"
#include "kv_codes.cuh"
#include "register_tiles.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SPLIT_KEYS = 4096;    // kernels/slot_decode.py MAX_SPLIT_KEYS
constexpr int MASK_WORDS = MAX_SPLIT_KEYS / 32;
constexpr int MAX_TILES = MAX_SPLIT_KEYS / 8;  // fp32 at dh > 128: 8 keys a tile
constexpr size_t MASK_BYTES = MASK_WORDS * 4 + MAX_TILES * 2 + 16;
constexpr size_t SLOT_KEY_BYTES = 24;   // a key slot: K and V offsets, K and V scales
constexpr float LOG2E = 1.4426950408889634f;

// Everything a launch passes; strides in elements. k/v: slot rows (batch,
// time, head) or pools (block, offset, head).
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const unsigned char* valid;
  void* o;
  float* ws;  // nsplit > 1: (B, HQ, nsplit, dh) partial O, then (B, HQ, nsplit, 2) m, l
  const int* tables;  // paged: (B, nb) block table
  const float* ks;    // quantized pools: (P+1, HKV) K and V scales
  const float* vs;
  int B, T, HQ, HKV, dh, nsplit, bs;
  unsigned bs_mul, bs_shift;  // paged: t / bs as (umulhi(t, bs_mul) + t) >> bs_shift
  int vec;    // bytes per cp.async (16, 8, 4), or 0: element copies
  long long qsb, qsh, ksb, kst, ksh, vsb, vst, vsh, tsb, msb, osb, osh, kssr, vssr;
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

// One stage of a paged split's key slots: each key's K and V row as an
// element offset from the KV head's pool base (-1: masked, zero-filled) and,
// for a quantized pool, its block's K and V scale (0 when masked).
struct KeySlots {
  long long* koff;
  long long* voff;
  float* ks;
  float* vs;
};

// Copies live tile i of a split into a ring stage of S: BK rows of K, then
// BK of V, RS elements apart; a key with its bit set is copied, the rest
// zero-filled. V-byte cp.asyncs over the (row, chunk) walk advanced without
// division, or element copies. KV is the storage type (the query type, or a
// 1-byte code); PAGED resolves each key through the block table into
// NS = S + 2 stages of key slots (`slots`): the rows of tile i + S + 1 and
// the scales of tile i + S are loaded before tile i's math (`ahead`) and
// stored after it (`store`), so a slot stage lives from its rows' store
// (end of iteration t - S - 1) to its tile's math (iteration t).
template <typename KV, bool PAGED, int S>
struct Stager {
  static constexpr bool QNT = sizeof(KV) == 1;
  static constexpr int NS = S + 2;
  using Raw = rt::Bits<KV>;
  const KV* kb;
  const KV* vb;
  long long kst, vst;
  int dh, vec, BK, RS;
  int cpr, j0, c0, dj, dc;
  unsigned char* slots;
  const int* tb;      // paged: slot b's table row
  const float* ksc;   // quantized: the KV head's column of ks / vs
  const float* vsc;
  int r_next;         // paged, thread j < BK: key j's pool row in tile i + S + 1

  __device__ __forceinline__ Stager(const Args& a, int b, int hk, int BK_, int RS_,
                                    unsigned char* slots_)
      : kb(static_cast<const KV*>(a.k) + (PAGED ? 0 : b * a.ksb) + hk * a.ksh),
        vb(static_cast<const KV*>(a.v) + (PAGED ? 0 : b * a.vsb) + hk * a.vsh),
        kst(a.kst), vst(a.vst), dh(a.dh), vec(a.vec), BK(BK_), RS(RS_), slots(slots_),
        tb(PAGED ? a.tables + b * a.tsb : nullptr),
        ksc(QNT ? a.ks + hk : nullptr), vsc(QNT ? a.vs + hk : nullptr), r_next(-1) {
    cpr = vec ? dh * static_cast<int>(sizeof(KV)) / vec : 1;  // chunks per row
    const int tid = threadIdx.x;
    j0 = tid / cpr;
    c0 = tid % cpr;
    dj = THREADS / cpr;
    dc = THREADS % cpr;
  }

  __device__ __forceinline__ KeySlots slot(int i) const {
    unsigned char* base = slots + (i % NS) * SLOT_KEY_BYTES * BK;
    long long* ko = reinterpret_cast<long long*>(base);
    float* kf = reinterpret_cast<float*>(ko + 2 * BK);
    return {ko, ko + BK, kf, kf + BK};
  }

  // A key's table entry (loaded) and offset in its block.
  struct Row {
    int r, off;
  };
  // paged, thread j < BK: key j of live tile i, its pool row -1 when there
  // is no such tile or the key is masked
  __device__ __forceinline__ Row table_row(const Args& a, const Split& sp, int i) const {
    if (i >= sp.nlive) return {-1, 0};
    const int k = sp.tiles[i] * BK + threadIdx.x;
    const unsigned t = sp.ks + k, blk = (__umulhi(t, a.bs_mul) + t) >> a.bs_shift;
    return {sp.bit(k) ? tb[blk] : -1, static_cast<int>(t - blk * a.bs)};
  }
  __device__ __forceinline__ void put_row(const Args& a, int i, Row w) const {
    const KeySlots s = slot(i);
    const int j = threadIdx.x;
    s.koff[j] = w.r >= 0 ? w.r * a.ksb + w.off * a.kst : -1;
    s.voff[j] = w.r >= 0 ? w.r * a.vsb + w.off * a.vst : -1;
  }
  // Block r's K and V scales (0 for no block).
  __device__ __forceinline__ float2 scales_of(const Args& a, int r) const {
    return r >= 0 ? make_float2(ksc[r * a.kssr], vsc[r * a.vssr]) : make_float2(0.f, 0.f);
  }
  __device__ __forceinline__ void put_scales(int i, float2 c) const {
    const KeySlots s = slot(i);
    s.ks[threadIdx.x] = c.x;
    s.vs[threadIdx.x] = c.y;
  }

  // Paged: the key slots of the first tiles (rows of 0..S, scales of
  // 0..S-1), then a barrier. Nothing for slot rows.
  __device__ __forceinline__ void resolve_first(const Args& a, const Split& sp) {
    if constexpr (PAGED) {
      if (threadIdx.x < BK) {
        for (int i = 0; i <= S; ++i) {
          const Row w = table_row(a, sp, i);
          put_row(a, i, w);
          if (i == S) r_next = w.r;
          else if constexpr (QNT) put_scales(i, scales_of(a, w.r));
        }
      }
      __syncthreads();
    }
  }

  // Loads issued before tile i's math and stored after it.
  struct Ahead {
    Row w;
    float2 c;
  };
  __device__ __forceinline__ Ahead ahead(const Args& a, const Split& sp, int i) const {
    Ahead h{{-1, 0}, {0.f, 0.f}};
    if constexpr (PAGED) {
      if (threadIdx.x < BK) {
        h.w = table_row(a, sp, i + S + 1);
        if constexpr (QNT) h.c = scales_of(a, r_next);
      }
    }
    return h;
  }
  __device__ __forceinline__ void store(const Args& a, int i, const Ahead& h) {
    if constexpr (PAGED) {
      if (threadIdx.x < BK) {
        put_row(a, i + S + 1, h.w);
        if constexpr (QNT) put_scales(i + S, h.c);
        r_next = h.w.r;
      }
    }
  }

  // Key j of live tile i: whether it is copied, and its K and V element
  // offsets from kb / vb (a legal address when it is not: the split's first
  // key, or the pool's first row).
  __device__ __forceinline__ bool row(const Split& sp, const KeySlots& s, int k0, int j,
                                      long long& ko, long long& vo) const {
    if constexpr (PAGED) {
      ko = s.koff[j];
      vo = s.voff[j];
      const bool in = ko >= 0;
      if (!in) ko = vo = 0;
      return in;
    } else {
      const bool in = sp.bit(k0 + j);
      const long long key = sp.ks + (in ? k0 + j : 0);
      ko = key * kst;
      vo = key * vst;
      return in;
    }
  }

  template <int V>
  __device__ __forceinline__ void copy(const Split& sp, int i, KV* dst) const {
    const int k0 = sp.tiles[i] * BK;
    KeySlots s{};
    if constexpr (PAGED) s = slot(i);
    char* Kd = reinterpret_cast<char*>(dst);
    char* Vd = Kd + BK * RS * sizeof(KV);
    if constexpr (V > 0) {
      int j = j0, c = c0;
      while (j < BK) {
        long long ko, vo;
        const bool in = row(sp, s, k0, j, ko, vo);
        const int byte = c * V, r = j * RS * static_cast<int>(sizeof(KV));
        rt::cp_async<V>(Kd + r + byte, reinterpret_cast<const char*>(kb + ko) + byte, in);
        rt::cp_async<V>(Vd + r + byte, reinterpret_cast<const char*>(vb + vo) + byte, in);
        j += dj;
        c += dc;
        if (c >= cpr) {
          c -= cpr;
          ++j;
        }
      }
    } else {
      Raw* Kt = reinterpret_cast<Raw*>(Kd);
      Raw* Vt = reinterpret_cast<Raw*>(Vd);
      const Raw* kr = reinterpret_cast<const Raw*>(kb);
      const Raw* vr = reinterpret_cast<const Raw*>(vb);
      for (int idx = threadIdx.x; idx < BK * dh; idx += THREADS) {
        const int j = idx / dh, d = idx - j * dh;
        long long ko, vo;
        const bool in = row(sp, s, k0, j, ko, vo);
        Kt[j * RS + d] = in ? kr[ko + d] : Raw(0);
        Vt[j * RS + d] = in ? vr[vo + d] : Raw(0);
      }
    }
  }

  // Live tile i (if there is one) into `dst`, then a commit: empty groups
  // keep the count of groups in flight uniform.
  __device__ __forceinline__ void stage(const Split& sp, int i, KV* dst) const {
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
constexpr int F32_STAGE_BYTES = 16384;  // K + V of one key tile of fp32 rows
constexpr int F32_U = 2;                // keys a lane group takes per tile
constexpr int F32_MAX_BK = 32;
constexpr size_t F32_RING = F32_STAGES * F32_STAGE_BYTES;

constexpr size_t f32_smem(bool paged) {
  return F32_RING + MASK_BYTES + (paged ? (F32_STAGES + 2) * F32_MAX_BK * SLOT_KEY_BYTES : 0);
}

// Element e of a lane's eight: granules (4 elements) sub and sub + L of
// the row, so the eight lanes of a quarter-warp read contiguous bytes.
__device__ __forceinline__ int lane_col(int sub, int L, int e) {
  return (sub + (e >> 2) * L) * 4 + (e & 3);
}

// A lane's eight elements of a staged row: fp32 as they are, 1-byte codes
// decoded and times their key's scale c in fp32.
template <typename KV>
__device__ __forceinline__ void load_row(const KV* row, int sub, int L, float c, float (&f)[8]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if constexpr (std::is_same<KV, float>::value) {
      const float4 x = *reinterpret_cast<const float4*>(row + (sub + i * L) * 4);
      f[4 * i] = x.x;
      f[4 * i + 1] = x.y;
      f[4 * i + 2] = x.z;
      f[4 * i + 3] = x.w;
    } else {
      float d[4];
      rt::decode4<KV>(*reinterpret_cast<const uint32_t*>(row + (sub + i * L) * 4), d);
#pragma unroll
      for (int e = 0; e < 4; ++e) f[4 * i + e] = d[e] * c;
    }
  }
}

template <int GH, typename KV, bool PAGED>
__global__ void __launch_bounds__(THREADS, 2) decode_split_f32_kernel(const Args a) {
  constexpr bool QNT = sizeof(KV) == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  KV* ring = reinterpret_cast<KV*>(smem);

  const int G = a.HQ / a.HKV, NHG = (G + GH - 1) / GH;
  const int hk = blockIdx.x / NHG, hg = blockIdx.x % NHG, b = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, dh = a.dh;
  const int L = dh <= 64 ? 8 : dh <= 128 ? 16 : 32;  // lanes a key row
  const int KW = 32 / L, sub = lane % L, grp = lane / L, DP = 8 * L;
  const int BK = F32_STAGE_BYTES / 2 / (DP * 4);    // = 4 * F32_U * KW keys a tile

  // padding columns (dh < DP) of the ring stay zero: nothing writes them
  if (dh < DP) {
    uint4* z = reinterpret_cast<uint4*>(smem);
    for (int i = tid; i < static_cast<int>(F32_RING / 16); i += THREADS)
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
  const Split sp = split_keys(a, b, s, BK, smem + F32_RING);
  Stager<KV, PAGED, F32_STAGES> st(a, b, hk, BK, DP, smem + F32_RING + MASK_BYTES);
  st.resolve_first(a, sp);
  auto stage_of = [&](int i) { return ring + (i % F32_STAGES) * 2 * BK * DP; };

#pragma unroll
  for (int i = 0; i < F32_STAGES - 1; ++i) st.stage(sp, i, stage_of(i));
  for (int i = 0; i < sp.nlive; ++i) {
    rt::cp_async_wait<F32_STAGES - 2>();
    __syncthreads();  // tile i landed; every thread is done with tile i - 1
    st.stage(sp, i + F32_STAGES - 1, stage_of(i + F32_STAGES - 1));  // under this tile's math
    const auto ahead = st.ahead(a, sp, i);
    const KV* Ks = stage_of(i);
    const KV* Vs = Ks + BK * DP;
    const int k0 = sp.tiles[i] * BK;
    KeySlots ksl{};
    if constexpr (QNT) ksl = st.slot(i);
    // this lane group's keys of the tile: j = (warp * U + u) * KW + grp
    float sc[F32_U][GH];
    bool live[F32_U];
#pragma unroll
    for (int u = 0; u < F32_U; ++u) {
      const int j = (warp * F32_U + u) * KW + grp;
      live[u] = sp.bit(k0 + j);
      float kf[8];
      load_row(Ks + j * DP, sub, L, QNT ? ksl.ks[j] : 1.f, kf);
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
      load_row(Vs + j * DP, sub, L, QNT ? ksl.vs[j] : 1.f, vf);
#pragma unroll
      for (int g = 0; g < GH; ++g)
#pragma unroll
        for (int e = 0; e < 8; ++e) o[g][e] = fmaf(sc[u][g], vf[e], o[g][e]);
    }
    st.store(a, i, ahead);
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
  float* red_o = reinterpret_cast<float*>(smem);  // [WARPS][GH][DP]
  float* red_ml = red_o + WARPS * GH * DP;        // [WARPS][GH][2]
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

// Shared memory of one instantiation: the ring (rows of the storage type,
// LR elements apart), for a quantized pool the tile converted to bf16 (LD
// apart), the split's mask and tile list, a paged split's key slots.
template <int DP, typename KV, bool PAGED>
struct TcLayout {
  static constexpr bool QNT = sizeof(KV) == 1;
  static constexpr int LD = DP + 8;  // bf16 row stride: rows 16 bytes apart modulo 128,
                                     // so ldmatrix is conflict-free
  static constexpr int LR = QNT ? DP + 16 : LD;
  static constexpr int STAGES = DP == 64 ? 4 : DP == 128 ? 3 : 2;
  static constexpr size_t STAGE_ELEMS = 2 * TC_BK * LR;
  static constexpr size_t RING_BYTES = STAGES * STAGE_ELEMS * sizeof(KV);
  static constexpr size_t WORK_BYTES = QNT ? 2 * TC_BK * LD * 2 : 0;
  static constexpr size_t SLOT_BYTES = PAGED ? (STAGES + 2) * TC_BK * SLOT_KEY_BYTES : 0;
  static constexpr size_t BYTES = RING_BYTES + WORK_BYTES + MASK_BYTES + SLOT_BYTES;
};

template <int DP, typename KV, bool PAGED>
__global__ void __launch_bounds__(THREADS) decode_split_bf16_kernel(const Args a) {
  using bf = __nv_bfloat16;
  using Ly = TcLayout<DP, KV, PAGED>;
  constexpr bool QNT = Ly::QNT;
  constexpr int LD = Ly::LD, LR = Ly::LR, STAGES = Ly::STAGES, KT = DP / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  KV* ring = reinterpret_cast<KV*>(smem);
  bf* work = reinterpret_cast<bf*>(smem + Ly::RING_BYTES);

  const int G = a.HQ / a.HKV, NHG = (G + TC_HEADS - 1) / TC_HEADS;
  const int hk = blockIdx.x / NHG, hg = blockIdx.x % NHG, b = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, dh = a.dh;
  const int g = lane >> 2, t = lane & 3;

  if (dh < DP) {  // padding columns of the ring stay zero
    uint4* z = reinterpret_cast<uint4*>(smem);
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

  const Split sp = split_keys(a, b, s, TC_BK, smem + Ly::RING_BYTES + Ly::WORK_BYTES);
  Stager<KV, PAGED, STAGES> st(a, b, hk, TC_BK, LR,
                               smem + Ly::RING_BYTES + Ly::WORK_BYTES + MASK_BYTES);
  st.resolve_first(a, sp);
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
    const auto ahead = st.ahead(a, sp, i);
    const bf* Ks;
    const bf* Vs;
    if constexpr (QNT) {  // the codes as bf16, exactly
      const KV* Kr = stage_of(i);
      rt::convert<THREADS, false, TC_BK, DP, LD, LR>(work, Kr, nullptr);
      rt::convert<THREADS, false, TC_BK, DP, LD, LR>(work + TC_BK * LD, Kr + TC_BK * LR, nullptr);
      __syncthreads();
      Ks = work;
    } else {
      Ks = stage_of(i);
    }
    Vs = Ks + TC_BK * LD;
    const int k0 = sp.tiles[i] * TC_BK, j0 = warp * 16 + g;
    // S^T = K Q^T for this warp's 16 keys
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    const bf* ka = Ks + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t af[4];
      rt::ldmatrix_x4(af, ka + kk * 16);
      rt::mma_bf16(c, af, qf[kk][0], qf[kk][1]);
    }
    // online softmax per head over the warp's keys (rows g and g + 8); a
    // quantized pool's K scale multiplies row j's scores
    const bool live0 = sp.bit(k0 + j0), live1 = sp.bit(k0 + j0 + 8);
    float s0 = a.scale2, s1 = a.scale2;
    KeySlots ksl{};
    if constexpr (QNT) {
      ksl = st.slot(i);
      s0 *= ksl.ks[j0];
      s1 *= ksl.ks[j0 + 8];
    }
    float sv[4] = {live0 ? c[0] * s0 : rt::NEG_INF, live0 ? c[1] * s0 : rt::NEG_INF,
                   live1 ? c[2] * s1 : rt::NEG_INF, live1 ? c[3] * s1 : rt::NEG_INF};
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
    // P^T, its rows times their V scale (quantized) before the rounding
    uint32_t p01, p23;
    if constexpr (QNT) {
      const float v0 = ksl.vs[j0], v1 = ksl.vs[j0 + 8];
      p01 = rt::pack_bf16(sv[0] * v0, sv[1] * v0);
      p23 = rt::pack_bf16(sv[2] * v1, sv[3] * v1);
    } else {
      p01 = rt::pack_bf16(sv[0], sv[1]);
      p23 = rt::pack_bf16(sv[2], sv[3]);
    }
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
    st.store(a, i, ahead);
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
__global__ void __launch_bounds__(THREADS) decode_combine_kernel(const Args a) {
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
// rounded up to a power of two, at most 8), bf16 by the padded head dim;
// each over the storage type KV and the key source.
template <typename KV, bool PAGED, typename Op>
int f32_by_heads(int G, const Op& op) {
  constexpr size_t smem = f32_smem(PAGED);
  if (G <= 1) return op.template run<float, KV>(decode_split_f32_kernel<1, KV, PAGED>, smem, 1);
  if (G <= 2) return op.template run<float, KV>(decode_split_f32_kernel<2, KV, PAGED>, smem, 2);
  if (G <= 4) return op.template run<float, KV>(decode_split_f32_kernel<4, KV, PAGED>, smem, 4);
  return op.template run<float, KV>(decode_split_f32_kernel<8, KV, PAGED>, smem, 8);
}

template <typename KV, bool PAGED, typename Op>
int bf16_by_dim(int dh, const Op& op) {
  using bf = __nv_bfloat16;
  if (dh <= 64)
    return op.template run<bf, KV>(decode_split_bf16_kernel<64, KV, PAGED>,
                                   TcLayout<64, KV, PAGED>::BYTES, TC_HEADS);
  if (dh <= 128)
    return op.template run<bf, KV>(decode_split_bf16_kernel<128, KV, PAGED>,
                                   TcLayout<128, KV, PAGED>::BYTES, TC_HEADS);
  return op.template run<bf, KV>(decode_split_bf16_kernel<256, KV, PAGED>,
                                 TcLayout<256, KV, PAGED>::BYTES, TC_HEADS);
}

template <typename T, bool PAGED, typename Op>
int by_storage(int kv_dtype, int G, int dh, const Op& op) {
  auto run = [&](auto kv) {
    using KV = decltype(kv);
    if constexpr (std::is_same<T, float>::value)
      return f32_by_heads<KV, PAGED>(G, op);
    else
      return bf16_by_dim<KV, PAGED>(dh, op);
  };
  if (kv_dtype == RT_UNQUANTIZED) return run(T{});
  if constexpr (PAGED) {
    if (kv_dtype == RT_I8) return run(int8_t{});
    if (kv_dtype == RT_E4M3) return run(__nv_fp8_e4m3{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Slot rows take pools in q's dtype only (kv_dtype RT_UNQUANTIZED).
template <bool PAGED, typename Op>
int dispatch(int dtype, int kv_dtype, int G, int dh, const Op& op) {
  if (dtype == RT_F32) return by_storage<float, PAGED>(kv_dtype, G, dh, op);
  if (dtype == RT_BF16) return by_storage<__nv_bfloat16, PAGED>(kv_dtype, G, dh, op);
  return static_cast<int>(cudaErrorInvalidValue);
}

struct Launch {
  Args a;
  cudaStream_t stream;
  template <typename T, typename KV, typename K>
  int run(K kernel, size_t smem, int heads) const {
    cudaError_t err = rt::allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    Args args = a;
    const long long e = sizeof(KV);
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
    const unsigned blocks = static_cast<unsigned>((rows + WARPS - 1) / WARPS);
    decode_combine_kernel<T><<<blocks, THREADS, 0, stream>>>(args);
    return static_cast<int>(cudaGetLastError());
  }
};

struct Info {
  int* smem_bytes;
  int* blocks_per_sm;
  template <typename T, typename KV, typename K>
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

// Slot rows: q (B,HQ,dh), k/v (B,T,HKV,dh), valid (B,T) bool, o (B,HQ,dh);
// ws: with nsplit > 1, B*HQ*nsplit*(dh + 2) floats of workspace (unused,
// and may be null, at nsplit 1). `strides` (elements): q batch, q head; k
// batch, time, head; v batch, time, head; valid batch; o batch, o head. The
// last dimension of each is contiguous.
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
         nullptr, nullptr, nullptr, B, Tn, HQ, HKV, dh, nsplit, 1, 0, 0, 0,
         st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], 0, st[8], st[9], st[10], 0, 0,
         scale * LOG2E};
  return dispatch<false>(dtype, RT_UNQUANTIZED, HQ / HKV, dh,
                         Launch{a, static_cast<cudaStream_t>(stream)});
}

// A block pool: q (B,HQ,dh), kp/vp (P+1,bs,HKV,dh), tables (B,nb) int32,
// valid (B,nb*bs) bool, o (B,HQ,dh), ws as above over T = nb*bs. kv_dtype
// -1: the pools hold q's dtype and ks/vs are null; RT_I8 / RT_E4M3: int8 or
// float8 e4m3 codes with ks/vs (P+1,HKV) f32 per-block scales. `strides`
// (elements): q batch, head; kp block, offset, head; vp block, offset,
// head; tables batch; valid batch; o batch, head; then, quantized, ks
// block, vs block. The last dimension of each is contiguous.
extern "C" int rt_paged_decode_attention(const void* q, const void* kp, const void* vp,
                                         const void* ks, const void* vs, const void* tables,
                                         const void* valid, void* o, void* ws, int B, int nb,
                                         int bs, int HQ, int HKV, int dh, int nsplit,
                                         const long long* strides, float scale, int dtype,
                                         int kv_dtype, void* stream) {
  const bool quant = kv_dtype != RT_UNQUANTIZED;
  if (bs < 1 || nb < 1 || bad_shape(HQ, HKV, dh, nb * bs, nsplit) ||
      (nsplit > 1 && ws == nullptr) || quant != (ks != nullptr && vs != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  const long long* st = strides;
  // t / bs by a multiply and a shift (Granlund and Montgomery), exact for
  // 0 <= t < 2^31: shift = ceil(log2 bs), mul = 2^32 (2^shift - bs) / bs + 1
  unsigned shift = 0;
  while ((1ull << shift) < static_cast<unsigned long long>(bs)) ++shift;
  const unsigned mul = static_cast<unsigned>(((1ull << 32) * ((1ull << shift) - bs)) / bs + 1);
  Args a{q,  kp, vp, static_cast<const unsigned char*>(valid), o, static_cast<float*>(ws),
         static_cast<const int*>(tables), static_cast<const float*>(ks),
         static_cast<const float*>(vs), B, nb * bs, HQ, HKV, dh, nsplit, bs, 0, 0, 0,
         st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
         quant ? st[12] : 0, quant ? st[13] : 0, scale * LOG2E};
  a.bs_mul = mul;
  a.bs_shift = shift;
  return dispatch<true>(dtype, kv_dtype, HQ / HKV, dh,
                        Launch{a, static_cast<cudaStream_t>(stream)});
}

// The split kernel's launch for a query type, group size G and head dim:
// its dynamic shared memory and how many of its blocks fit on one SM; slot
// rows (paged 0, kv_dtype -1) or a pool (paged 1) of kv_dtype.
extern "C" int rt_decode_info(int paged, int dtype, int kv_dtype, int G, int dh,
                              int* smem_bytes, int* blocks_per_sm) {
  if (G < 1 || dh < 1 || dh > 256) return static_cast<int>(cudaErrorInvalidValue);
  const Info op{smem_bytes, blocks_per_sm};
  return paged ? dispatch<true>(dtype, kv_dtype, G, dh, op)
               : dispatch<false>(dtype, kv_dtype, G, dh, op);
}
