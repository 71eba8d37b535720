// Paged chunked-prefill attention over a block pool, for the paged KV
// backend's chunk pass (serve/paging.py): every slot's W chunk queries
// attend over its resident block chain under the causal mask
// k_pos <= start + w.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_prefill.py
// (paged_prefill_attention, pallas_call :185; body _paged_prefill_kernel
// :43, fused-dequant body _paged_prefill_kernel_quant :82). One template
// covers fp32 and bf16 queries over unquantized, int8 and e4m3 pools.
//
// Rows. The W chunk queries of a (slot, KV head) are W*G query rows (row r
// is chunk position r / G, query head hk*G + r % G), so each K/V tile is
// read once for all G heads. A block takes 64 of them: grid (row tile, KV
// head, slot), four warps of 16 rows. Row r sees keys t <= start[b] + r / G
// (the Pallas mask i*bs + j <= start[b] + w), a prefix of the keys, so the
// mask is one bound per row and tile; keys past the block's last row bound
// the key loop (k_hi), where the Pallas kernel read all nb blocks. q and o
// are read and written through their (B, W, HQ, dh) strides: no transpose
// copy.
//
// What bounds it. At chunk widths of tens of tokens and more the kernel
// does W*G*4*dh operations per key it reads: operations, not bytes. So
// the math runs from registers (register_tiles.cuh): bf16 queries on the
// tensor cores (mma.sync m16n8k16, fp32 sums), fp32 queries as register
// micro-tiles on the CUDA cores (TF32 would keep three digits).
//
// Staging through the block table. On the TPU the table was
// scalar-prefetched into a BlockSpec index map and the DMA engine did the
// gather. Here each 64-key tile (32 at fp32 dh > 128) is resolved once per
// key: thread j reads tables[b, t / bs] (and, for a quantized pool, that
// block's K and V scale) into a three-stage ring of key slots, a tile
// ahead of the copy, with the loads in flight under a tile's math. The rows are then copied with cp.async into a two-stage ring, so
// the next tile's gather runs under this tile's math, at 16, 8 or 4 bytes
// a thread, the widest that the pool's base pointers, strides and dh*elem
// allow (chosen at launch); rows narrower than that (int8 or bf16 at odd
// dh) are copied element by element. Keys the mask rules out for the whole
// block (t >= k_hi) are zero-filled, never read: neither the trash row nor
// a block's stale tail.
//
// Quantized pools (kernels/kv_quant.py): int8 or e4m3 codes with one f32
// scale per (block, KV head). The codes land in the raw ring, and one pass
// turns a tile into the compute type. fp32 queries: code * scale in fp32,
// the staged tile bit-identical to the plain version's decoded pool. bf16
// queries: the codes as bf16 (exact for both formats), the scales folded
// out of the tiles: the K scale multiplies score column j, the V scale
// multiplies probability column j before P is rounded to bf16, and the row
// sum takes the unscaled probabilities.
#include <cstdint>
#include <type_traits>

#include "cp_async.cuh"
#include "kv_codes.cuh"
#include "register_tiles.cuh"

namespace {

constexpr int BQ = rt::TILE_ROWS;
constexpr int THREADS = rt::TILE_THREADS;
constexpr int SLOT_STAGES = 3;  // key slots: copied, copying, resolving

// Everything a launch passes; strides in elements.
struct Args {
  const void* q;
  const void* kp;
  const void* vp;
  const float* ks;  // quantized pools: (P+1, HKV) scales
  const float* vs;
  const int* tables;
  const int* start;
  void* o;
  int W, nb, bs, HQ, HKV, dh;
  int vec;  // bytes per cp.async (16, 8, 4), or 0: element copies
  long long qsb, qsw, qsh, ksb, kso, ksh, vsb, vso, vsh, tsb, osb, osw, osh, kssr, vssr;
  float scale;
};

template <typename T, int DP>
struct TileOf {
  using type = rt::FmaTile<DP>;
};
template <int DP>
struct TileOf<__nv_bfloat16, DP> {
  using type = rt::TcTile<DP>;
};

// Shared memory of one instantiation: the block's queries; the raw ring (2
// stages x {K, V} x BK rows of the pool's type, rows padded by 16 bytes);
// for quantized pools the converted K/V tile; the FMA tile's P strip; the
// key slots (3 stages).
template <typename T, typename KV, bool QNT, int DP>
struct Layout {
  using Tile = typename TileOf<T, DP>::type;
  using CT = typename Tile::elem;
  static constexpr int BK = Tile::BK, LD = Tile::LD;
  static constexpr int LR = DP + 16 / static_cast<int>(sizeof(KV));
  static_assert(QNT || (std::is_same<KV, CT>::value && LR == LD),
                "an unquantized pool is staged straight into the compute tile");
  static constexpr size_t Q_BYTES = sizeof(CT) * BQ * LD;
  static constexpr size_t RAW_BYTES = sizeof(KV) * 4 * BK * LR;
  static constexpr size_t WORK_BYTES = QNT ? sizeof(CT) * 2 * BK * LD : 0;
  static constexpr size_t P_BYTES = sizeof(float) * Tile::P_FLOATS;
  static constexpr size_t SLOT_BYTES = 24 * SLOT_STAGES * BK;
  static constexpr size_t BYTES = Q_BYTES + RAW_BYTES + WORK_BYTES + P_BYTES + SLOT_BYTES;
  // bf16 at dh <= 64 takes 50 KB, so four blocks fit an SM once ptxas
  // keeps to 128 registers (left alone it took ~150: three blocks);
  // elsewhere shared memory allows one or two, and ptxas may use up to 255
  static constexpr int MIN_BLOCKS = std::is_same<CT, __nv_bfloat16>::value && DP == 64 ? 4 : 1;
};

// One stage of key slots: each key's K and V row as an element offset into
// the KV head's pool (-1: not loaded) and its block's K and V scale.
template <int BK>
struct Slots {
  long long* koff;
  long long* voff;
  float* ks;
  float* vs;
  __device__ __forceinline__ Slots(void* base, int stage) {
    koff = static_cast<long long*>(base) + stage * 3 * BK;
    voff = koff + BK;
    ks = reinterpret_cast<float*>(voff + BK);
    vs = ks + BK;
  }
};

template <int V>
using Vec = std::integral_constant<int, V>;

template <typename T, typename KV, bool QNT, int DP>
__global__ void __launch_bounds__(THREADS, (Layout<T, KV, QNT, DP>::MIN_BLOCKS))
    paged_prefill_kernel(const Args a) {
  using L = Layout<T, KV, QNT, DP>;
  using Tile = typename L::Tile;
  using CT = typename L::CT;
  constexpr int BK = L::BK, LD = L::LD, LR = L::LR;
  constexpr bool TC = std::is_same<CT, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  CT* Qs = reinterpret_cast<CT*>(smem);
  KV* raw = reinterpret_cast<KV*>(smem + L::Q_BYTES);
  CT* work = reinterpret_cast<CT*>(smem + L::Q_BYTES + L::RAW_BYTES);
  float* Ps = reinterpret_cast<float*>(smem + L::Q_BYTES + L::RAW_BYTES + L::WORK_BYTES);
  void* slot_base = smem + L::BYTES - L::SLOT_BYTES;

  const int r0 = blockIdx.x * BQ, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int G = a.HQ / a.HKV, rows = a.W * G, dh = a.dh, bs = a.bs;
  const int s0 = a.start[b];
  // keys any row of this block can see: t <= s0 + (last row) / G
  const int k_hi = min(a.nb * bs, s0 + (min(r0 + BQ, rows) - 1) / G + 1);
  const int ntiles = (k_hi + BK - 1) / BK;
  const T* qb = static_cast<const T*>(a.q) + b * a.qsb + static_cast<long long>(hk) * G * a.qsh;
  const KV* kb = static_cast<const KV*>(a.kp) + hk * a.ksh;
  const KV* vb = static_cast<const KV*>(a.vp) + hk * a.vsh;
  const int* tb = a.tables + b * a.tsb;

  // padding columns (dh < DP) of the K/V tiles stay zero: nothing writes them
  if (dh < DP) {
    uint4* z = reinterpret_cast<uint4*>(smem + L::Q_BYTES);
    for (int i = tid; i < static_cast<int>((L::RAW_BYTES + L::WORK_BYTES) / 16); i += THREADS)
      z[i] = make_uint4(0, 0, 0, 0);
  }
  // the block's queries, a warp per row, padding rows and columns zero
  for (int i = tid >> 5; i < BQ; i += THREADS / 32) {
    const int r = r0 + i;
    const T* qr = qb + (r / G) * a.qsw + (r % G) * a.qsh;
    for (int d = tid & 31; d < DP; d += 32)
      Qs[i * LD + d] = rt::from_f<CT>(r < rows && d < dh ? rt::to_f(qr[d]) : 0.f);
  }

  // Key slots: thread j < BK resolves key j of each tile. The table load
  // for tile t + 2 and the scale loads for tile t + 1 are issued before tile
  // t's math and stored after it, so no thread waits on them.
  auto row_of = [&](int t) {
    const int key = t * BK + tid;
    return key < k_hi ? tb[key / bs] : -1;
  };
  auto scale_of = [&](const float* sc, long long sr, int r) {
    return r >= 0 ? sc[r * sr + hk] : 0.f;
  };
  auto put_rows = [&](int t, int r) {
    const Slots<BK> st(slot_base, t % SLOT_STAGES);
    const int off = (t * BK + tid) % bs;
    st.koff[tid] = r >= 0 ? r * a.ksb + off * a.kso : -1;
    st.voff[tid] = r >= 0 ? r * a.vsb + off * a.vso : -1;
  };
  auto put_scales = [&](int t, float k, float v) {
    const Slots<BK> st(slot_base, t % SLOT_STAGES);
    st.ks[tid] = k;
    st.vs[tid] = v;
  };

  // copy key tile t into raw stage t & 1: V-byte cp.asyncs (the chunk
  // walk (j, c) advanced without division), or element copies (V = 0)
  const int cpr = a.vec ? dh * static_cast<int>(sizeof(KV)) / a.vec : 1;  // chunks per row
  const int j0 = tid / cpr, c0 = tid % cpr, dj = THREADS / cpr, dc = THREADS % cpr;
  auto copy = [&](int t, auto vec) {
    constexpr int V = decltype(vec)::value;
    const Slots<BK> st(slot_base, t % SLOT_STAGES);
    char* Kd = reinterpret_cast<char*>(raw + (t & 1) * 2 * BK * LR);
    char* Vd = Kd + BK * LR * sizeof(KV);
    if constexpr (V > 0) {
      int j = j0, c = c0;
      while (j < BK) {
        const long long ko = st.koff[j], vo = st.voff[j];
        const int byte = c * V, row = j * LR * static_cast<int>(sizeof(KV));
        rt::cp_async<V>(Kd + row + byte,
                        reinterpret_cast<const char*>(kb + (ko < 0 ? 0 : ko)) + byte, ko >= 0);
        rt::cp_async<V>(Vd + row + byte,
                        reinterpret_cast<const char*>(vb + (vo < 0 ? 0 : vo)) + byte, vo >= 0);
        j += dj;
        c += dc;
        if (c >= cpr) {
          c -= cpr;
          ++j;
        }
      }
      rt::cp_async_commit();
    } else {
      using B = rt::Bits<KV>;
      for (int idx = tid; idx < BK * dh; idx += THREADS) {
        const int j = idx / dh, d = idx - j * dh;
        const long long ko = st.koff[j], vo = st.voff[j];
        reinterpret_cast<B*>(Kd)[j * LR + d] = ko >= 0 ? reinterpret_cast<const B*>(kb + ko)[d] : 0;
        reinterpret_cast<B*>(Vd)[j * LR + d] = vo >= 0 ? reinterpret_cast<const B*>(vb + vo)[d] : 0;
      }
    }
  };
  auto stage = [&](int t) {
    switch (a.vec) {
      case 16: copy(t, Vec<16>{}); break;
      case 8: copy(t, Vec<8>{}); break;
      case 4: copy(t, Vec<4>{}); break;
      default: copy(t, Vec<0>{});
    }
  };

  int r_next = -1;  // this thread's key of tile t + 1: its pool row
  if (tid < BK) {
    const int r = row_of(0);
    r_next = row_of(1);
    put_rows(0, r);
    put_rows(1, r_next);
    if constexpr (QNT) put_scales(0, scale_of(a.ks, a.kssr, r), scale_of(a.vs, a.vssr, r));
  }
  __syncthreads();  // slots, queries and the zeroed padding published
  if (ntiles > 0) stage(0);
  Tile tile;
  tile.init();
  // block row i sees keys t <= s0 + (r0 + i) / G
  tile.set_limits([=](int i) { return min(k_hi, s0 + (r0 + i) / G + 1); });
  if constexpr (TC) tile.load_q(Qs);
  for (int t = 0; t < ntiles; ++t) {
    rt::cp_async_wait_all();
    __syncthreads();  // tile t landed; every thread is done with tile t - 1
    if (t + 1 < ntiles) stage(t + 1);  // overlaps this tile's math
    int r_after = -1;
    float ks_next = 0.f, vs_next = 0.f;
    if (tid < BK) {
      r_after = row_of(t + 2);
      if constexpr (QNT) {
        ks_next = scale_of(a.ks, a.kssr, r_next);
        vs_next = scale_of(a.vs, a.vssr, r_next);
      }
    }
    const Slots<BK> st(slot_base, t % SLOT_STAGES);
    const KV* Kr = raw + (t & 1) * 2 * BK * LR;
    const CT* Kt;
    const CT* Vt;
    if constexpr (QNT) {
      rt::convert<THREADS, !TC, BK, DP, LD, LR>(work, Kr, st.ks);
      rt::convert<THREADS, !TC, BK, DP, LD, LR>(work + BK * LD, Kr + BK * LR, st.vs);
      __syncthreads();
      Kt = work;
      Vt = work + BK * LD;
    } else {
      Kt = reinterpret_cast<const CT*>(Kr);
      Vt = Kt + BK * LD;
    }
    if constexpr (TC)
      tile.template step<QNT, QNT>(Qs, Kt, Vt, st.ks, st.vs, a.scale, t * BK);
    else
      tile.step(Qs, Kt, Vt, Ps, a.scale, dh, t * BK);
    if (tid < BK) {
      put_rows(t + 2, r_after);
      if constexpr (QNT) put_scales(t + 1, ks_next, vs_next);
      r_next = r_after;
    }
  }

  T* ob = static_cast<T*>(a.o) + b * a.osb + static_cast<long long>(hk) * G * a.osh;
  tile.finish(
      [&](int i) -> T* {
        const int r = r0 + i;
        return r < rows ? ob + (r / G) * a.osw + (r % G) * a.osh : nullptr;
      },
      dh);
}

// The widest copy (16, 8 or 4 bytes) that every K/V row start and dh*elem
// allow, or 0 for element copies.
int vec_width(const Args& a, long long elem) {
  const unsigned long long g =
      reinterpret_cast<uintptr_t>(a.kp) | reinterpret_cast<uintptr_t>(a.vp) |
      static_cast<unsigned long long>((a.ksb | a.kso | a.ksh | a.vsb | a.vso | a.vsh) * elem) |
      static_cast<unsigned long long>(a.dh * elem);
  return g % 16 == 0 ? 16 : g % 8 == 0 ? 8 : g % 4 == 0 ? 4 : 0;
}

// Runs op.run<T, KV, QNT, DP>() for a query type, a storage type
// (RT_UNQUANTIZED, RT_I8, RT_E4M3) and the head dim padded to 64, 128 or 256.
template <typename T, typename KV, bool QNT, typename Op>
int by_head_dim(int dh, const Op& op) {
  if (dh <= 64) return op.template run<T, KV, QNT, 64>();
  if (dh <= 128) return op.template run<T, KV, QNT, 128>();
  return op.template run<T, KV, QNT, 256>();
}

template <typename T, typename Op>
int by_storage(int kv_dtype, int dh, const Op& op) {
  if (kv_dtype == RT_UNQUANTIZED) return by_head_dim<T, T, false>(dh, op);
  if (kv_dtype == RT_I8) return by_head_dim<T, int8_t, true>(dh, op);
  if (kv_dtype == RT_E4M3) return by_head_dim<T, __nv_fp8_e4m3, true>(dh, op);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename Op>
int dispatch(int dtype, int kv_dtype, int dh, const Op& op) {
  if (dtype == RT_F32) return by_storage<float>(kv_dtype, dh, op);
  if (dtype == RT_BF16) return by_storage<__nv_bfloat16>(kv_dtype, dh, op);
  return static_cast<int>(cudaErrorInvalidValue);
}

struct Launch {
  Args a;
  int B;
  cudaStream_t stream;
  template <typename T, typename KV, bool QNT, int DP>
  int run() const {
    using L = Layout<T, KV, QNT, DP>;
    auto kernel = paged_prefill_kernel<T, KV, QNT, DP>;
    cudaError_t err = rt::allow_smem(kernel, L::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    Args args = a;
    args.vec = vec_width(a, sizeof(KV));
    dim3 grid((a.W * (a.HQ / a.HKV) + BQ - 1) / BQ, a.HKV, B);
    kernel<<<grid, THREADS, L::BYTES, stream>>>(args);
    return static_cast<int>(cudaGetLastError());
  }
};

struct Info {
  int* smem_bytes;
  int* blocks_per_sm;
  template <typename T, typename KV, bool QNT, int DP>
  int run() const {
    using L = Layout<T, KV, QNT, DP>;
    auto kernel = paged_prefill_kernel<T, KV, QNT, DP>;
    cudaError_t err = rt::allow_smem(kernel, L::BYTES);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, THREADS,
                                                          L::BYTES);
    *smem_bytes = static_cast<int>(L::BYTES);
    return static_cast<int>(err);
  }
};

bool bad_heads(int HQ, int HKV, int dh) {
  return dh < 1 || dh > 256 || HKV < 1 || HQ % HKV != 0;
}

int prefill(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
            const void* tables, const void* start, void* o, int B, int W, int nb, int bs, int HQ,
            int HKV, int dh, const long long* st, float scale, int dtype, int kv_dtype,
            void* stream) {
  if (bad_heads(HQ, HKV, dh) || bs < 1 || nb < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || W == 0) return static_cast<int>(cudaGetLastError());
  const bool quant = kv_dtype != RT_UNQUANTIZED;
  Args a{q,  kp, vp, static_cast<const float*>(ks), static_cast<const float*>(vs),
         static_cast<const int*>(tables), static_cast<const int*>(start), o, W, nb, bs, HQ, HKV,
         dh, 0, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
         st[11], st[12], quant ? st[13] : 0, quant ? st[14] : 0, scale};
  return dispatch(dtype, kv_dtype, dh, Launch{a, B, static_cast<cudaStream_t>(stream)});
}

}  // namespace

// q (B,W,HQ,dh), kp/vp (P+1,bs,HKV,dh), tables (B,nb) int32, start (B,)
// int32 contiguous, o (B,W,HQ,dh). `strides` (elements): q batch, position,
// head; kp block, offset, head; vp block, offset, head; tables batch; o
// batch, position, head. The last dimension of each is contiguous.
extern "C" int rt_paged_prefill_attention(const void* q, const void* kp, const void* vp,
                                          const void* tables, const void* start, void* o,
                                          int B, int W, int nb, int bs, int HQ, int HKV, int dh,
                                          const long long* strides, float scale, int dtype,
                                          void* stream) {
  return prefill(q, kp, vp, nullptr, nullptr, tables, start, o, B, W, nb, bs, HQ, HKV, dh,
                 strides, scale, dtype, RT_UNQUANTIZED, stream);
}

// The fused-dequant variant: as above with kp/vp int8 (kv_dtype RT_I8) or
// float8 e4m3 (RT_E4M3) codes and ks/vs (P+1,HKV) f32 per-block scales
// (last dimension contiguous). `strides` as above, then ks block, vs block.
extern "C" int rt_paged_prefill_attention_quant(const void* q, const void* kp, const void* vp,
                                                const void* ks, const void* vs,
                                                const void* tables, const void* start, void* o,
                                                int B, int W, int nb, int bs, int HQ, int HKV,
                                                int dh, const long long* strides, float scale,
                                                int dtype, int kv_dtype, void* stream) {
  if (kv_dtype != RT_I8 && kv_dtype != RT_E4M3) return static_cast<int>(cudaErrorInvalidValue);
  return prefill(q, kp, vp, ks, vs, tables, start, o, B, W, nb, bs, HQ, HKV, dh, strides, scale,
                 dtype, kv_dtype, stream);
}

// The launch an instantiation gets: its dynamic shared memory and how many
// of its blocks fit on one SM (kv_dtype -1: a pool in q's dtype).
extern "C" int rt_paged_prefill_info(int dtype, int kv_dtype, int dh, int* smem_bytes,
                                     int* blocks_per_sm) {
  if (dh < 1 || dh > 256) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dtype, kv_dtype, dh, Info{smem_bytes, blocks_per_sm});
}
