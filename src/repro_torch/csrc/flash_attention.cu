// Causal / sliding-window GQA flash attention forward, for admission prefill.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_flash_kernel :35, pallas_call :164). On the TPU the grid walked the KV
// axis sequentially, carrying m/l/acc in VMEM scratch across grid steps; on
// Hopper blocks run in parallel and in no order, so a block owns 64 query
// rows and loops over the key tiles itself.
//
// Rows. The Sq queries of a (batch, KV head) are Sq*G query rows: row r is
// query position r / G of query head hk*G + r % G (GQA: head h reads KV
// head h / G), so each K/V tile is staged once for all G heads. A block
// takes 64 of them; four warps of 16 run the register tiles of
// register_tiles.cuh. The blocks are launched heaviest first: under the
// causal mask the last row tiles see the most keys.
//
// Masks as row limits. Row r at position p sees keys lo(p) <= t < hi(p),
// hi = min(Sk, p + 1) when causal (else Sk), lo = max(0, p - window + 1)
// with a window (else 0), which is the Pallas kernel's per-element mask
// (qpos >= kpos, qpos - kpos < window, both inside the sequence). The key
// loop runs over the tiles between the block's least lo and its greatest
// hi (the Pallas kernel skipped fully masked tiles with pl.when); a tile
// inside every row's range takes the tiles' mask-free path. A row that
// sees no key writes zeros (the final normalizer is max(l, 1e-30)).
//
// What bounds it: at prefill lengths the work is the 4*dh operations per
// live (query, key) pair, so the bound is operations. So the math runs
// from registers: bf16 on the tensor cores (TcTile: mma.sync m16n8k16,
// fp32 sums, P rounded to bf16 before P V as the plain version does),
// fp32 as register micro-tiles on the CUDA cores (FmaTile: no TF32, which
// would keep three digits). The head dim is padded to 64, 128 or 256 with
// zero columns, so any dh <= 256 works, odd ones too. K and V rows are
// copied with cp.async into a two-stage ring, the next tile's copy under
// this tile's math, at the widest width (16, 8 or 4 bytes) that the
// pointers, strides and dh*elem allow, element by element otherwise. Q, K,
// V and O are read and written through their (B, S, H, dh) strides: no
// transpose copy. For training the rows' log-sum-exp goes out too (lse,
// natural log, (B, HQ, Sq)), which flash_attention_bwd.cu takes instead of
// recomputing it.
#include "cp_async.cuh"
#include "register_tiles.cuh"

namespace {

constexpr int BQ = rt::TILE_ROWS;
constexpr int THREADS = rt::TILE_THREADS;

// Everything a launch passes; strides in elements.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, HQ, Sq) row log-sum-exp for the backward, or nullptr
  int B, Sq, Sk, HQ, HKV, dh, causal, window;
  int vec;  // bytes per cp.async (16, 8, 4), or 0: element copies
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh;
  float scale;
};

template <typename T, int DP>
struct TileOf {
  using type = rt::FmaTile<DP, true>;
};
template <int DP>
struct TileOf<__nv_bfloat16, DP> {
  using type = rt::TcTile<DP, true>;
};

// Shared memory: the block's queries, the two-stage {K, V} ring, the FMA
// tile's P strip.
template <typename T, int DP>
struct Layout {
  using Tile = typename TileOf<T, DP>::type;
  static constexpr int BK = Tile::BK, LD = Tile::LD;
  static constexpr size_t Q_BYTES = sizeof(T) * BQ * LD;
  static constexpr size_t RING_BYTES = sizeof(T) * 4 * BK * LD;
  static constexpr size_t P_BYTES = sizeof(float) * Tile::P_FLOATS;
  static constexpr size_t BYTES = Q_BYTES + RING_BYTES + P_BYTES;
  // bf16 at dh <= 64 takes 46 KB: four blocks an SM at 128 registers
  static constexpr int MIN_BLOCKS = std::is_same<T, __nv_bfloat16>::value && DP == 64 ? 4 : 1;
};

template <int V>
using Vec = std::integral_constant<int, V>;

// LSE: also write the rows' log-sum-exp to a.lse (training). A compile-time
// option, so the serving instantiation carries none of its code: a runtime
// branch moved the fp32 dh-64 kernel's register allocation (204 -> 164) and
// cost it 2-5 % at (1,2048,32,64) on the H100.
template <typename T, int DP, bool LSE>
__global__ void __launch_bounds__(THREADS, (Layout<T, DP>::MIN_BLOCKS))
    flash_fwd_kernel(const Args a) {
  using L = Layout<T, DP>;
  using Tile = typename L::Tile;
  constexpr int BK = L::BK, LD = L::LD;
  constexpr bool TC = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* ring = reinterpret_cast<T*>(smem + L::Q_BYTES);
  float* Ps = reinterpret_cast<float*>(smem + L::Q_BYTES + L::RING_BYTES);

  // heaviest row tiles first: the linear block index walks the row tiles
  // from the last, every (KV head, batch) at one row tile before the next
  const int G = a.HQ / a.HKV, rows = a.Sq * G, dh = a.dh;
  const int per = a.HKV * a.B, ntr = (rows + BQ - 1) / BQ;
  const int rt_idx = ntr - 1 - static_cast<int>(blockIdx.x / per);
  const int hk = static_cast<int>(blockIdx.x % per) % a.HKV;
  const int b = static_cast<int>(blockIdx.x % per) / a.HKV;
  const int r0 = rt_idx * BQ, tid = threadIdx.x;
  const int causal = a.causal, window = a.window, Sk = a.Sk;
  auto hi_of = [=](int p) { return causal ? min(Sk, p + 1) : Sk; };
  auto lo_of = [=](int p) { return window > 0 ? max(0, p - window + 1) : 0; };
  // keys any row of this block sees: both limits grow with the position
  const int k_lo = lo_of(r0 / G), k_hi = hi_of((min(r0 + BQ, rows) - 1) / G);
  const int t_begin = k_lo / BK, t_end = k_lo < k_hi ? (k_hi + BK - 1) / BK : t_begin;

  const T* qb = static_cast<const T*>(a.q) + b * a.qsb + static_cast<long long>(hk) * G * a.qsh;
  const T* kb = static_cast<const T*>(a.k) + b * a.ksb + hk * a.ksh;
  const T* vb = static_cast<const T*>(a.v) + b * a.vsb + hk * a.vsh;

  // padding columns (dh < DP) of the K/V ring stay zero: nothing writes them
  if (dh < DP) {
    uint4* z = reinterpret_cast<uint4*>(ring);
    for (int i = tid; i < static_cast<int>(L::RING_BYTES / 16); i += THREADS)
      z[i] = make_uint4(0, 0, 0, 0);
  }
  // the block's queries, a warp per row, padding rows and columns zero
  for (int i = tid >> 5; i < BQ; i += THREADS / 32) {
    const int r = r0 + i;
    const T* qr = qb + (r / G) * a.qss + (r % G) * a.qsh;
    for (int d = tid & 31; d < DP; d += 32)
      Qs[i * LD + d] = rt::from_f<T>(r < rows && d < dh ? rt::to_f(qr[d]) : 0.f);
  }

  // copy key tile t into ring stage t & 1: keys t*BK + j < k_hi, the rest
  // zero-filled (never read); V-byte cp.asyncs over the (row, chunk) walk
  // advanced without division, or element copies (V = 0)
  const int cpr = a.vec ? dh * static_cast<int>(sizeof(T)) / a.vec : 1;  // chunks per row
  const int j0 = tid / cpr, c0 = tid % cpr, dj = THREADS / cpr, dc = THREADS % cpr;
  auto copy = [&](int t, auto vec) {
    constexpr int V = decltype(vec)::value;
    char* Kd = reinterpret_cast<char*>(ring + (t & 1) * 2 * BK * LD);
    char* Vd = Kd + BK * LD * sizeof(T);
    const int k0 = t * BK;
    if constexpr (V > 0) {
      int j = j0, c = c0;
      while (j < BK) {
        const int key = k0 + j;
        const bool in = key < k_hi;
        const long long kk = in ? key : 0;
        const int byte = c * V, row = j * LD * static_cast<int>(sizeof(T));
        rt::cp_async<V>(Kd + row + byte, reinterpret_cast<const char*>(kb + kk * a.kss) + byte, in);
        rt::cp_async<V>(Vd + row + byte, reinterpret_cast<const char*>(vb + kk * a.vss) + byte, in);
        j += dj;
        c += dc;
        if (c >= cpr) {
          c -= cpr;
          ++j;
        }
      }
      rt::cp_async_commit();
    } else {
      T* Kt = reinterpret_cast<T*>(Kd);
      T* Vt = reinterpret_cast<T*>(Vd);
      for (int idx = tid; idx < BK * dh; idx += THREADS) {
        const int j = idx / dh, d = idx - j * dh;
        const long long key = k0 + j;
        const bool in = key < k_hi;
        Kt[j * LD + d] = in ? kb[key * a.kss + d] : rt::from_f<T>(0.f);
        Vt[j * LD + d] = in ? vb[key * a.vss + d] : rt::from_f<T>(0.f);
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

  __syncthreads();  // queries and the zeroed padding published
  if (t_begin < t_end) stage(t_begin);
  Tile tile;
  tile.init();
  // block row i: position (r0 + i) / G; a padding row sees nothing
  tile.set_limits([=](int i) { return r0 + i < rows ? hi_of((r0 + i) / G) : 0; },
                  [=](int i) { return r0 + i < rows ? lo_of((r0 + i) / G) : 0; });
  if constexpr (TC) tile.load_q(Qs);
  for (int t = t_begin; t < t_end; ++t) {
    rt::cp_async_wait_all();
    __syncthreads();  // tile t landed; every thread is done with tile t - 1
    if (t + 1 < t_end) stage(t + 1);  // overlaps this tile's math
    const T* Kt = ring + (t & 1) * 2 * BK * LD;
    const T* Vt = Kt + BK * LD;
    if constexpr (TC)
      tile.template step<false, false>(Qs, Kt, Vt, nullptr, nullptr, a.scale, t * BK);
    else
      tile.step(Qs, Kt, Vt, Ps, a.scale, dh, t * BK);
  }

  T* ob = static_cast<T*>(a.o) + b * a.osb + static_cast<long long>(hk) * G * a.osh;
  tile.finish(
      [&](int i) -> T* {
        const int r = r0 + i;
        return r < rows ? ob + (r / G) * a.oss + (r % G) * a.osh : nullptr;
      },
      dh);
  if constexpr (LSE) {
    float* lb = a.lse + static_cast<long long>(b) * a.HQ * a.Sq;
    tile.row_lse(
        [&](int i, float x) {
          const int r = r0 + i;
          if (r < rows) lb[static_cast<long long>(hk * G + r % G) * a.Sq + r / G] = x;
        },
        a.scale);
  }
}

template <typename Op>
int dispatch(int dtype, int dh, const Op& op) {
  if (dtype == RT_F32) {
    if (dh <= 64) return op.template run<float, 64>();
    if (dh <= 128) return op.template run<float, 128>();
    return op.template run<float, 256>();
  }
  if (dtype == RT_BF16) {
    if (dh <= 64) return op.template run<__nv_bfloat16, 64>();
    if (dh <= 128) return op.template run<__nv_bfloat16, 128>();
    return op.template run<__nv_bfloat16, 256>();
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

struct Launch {
  Args a;
  cudaStream_t stream;
  template <typename T, int DP>
  int run() const {
    using L = Layout<T, DP>;
    auto kernel = a.lse != nullptr ? flash_fwd_kernel<T, DP, true> : flash_fwd_kernel<T, DP, false>;
    cudaError_t err = rt::allow_smem(kernel, L::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    Args args = a;
    const long long e = sizeof(T);
    args.vec = rt::vec_width(reinterpret_cast<uintptr_t>(a.k) | reinterpret_cast<uintptr_t>(a.v) |
                                 static_cast<unsigned long long>(
                                     (a.ksb | a.kss | a.ksh | a.vsb | a.vss | a.vsh) * e),
                             a.dh * e);
    const long long rows = static_cast<long long>(a.Sq) * (a.HQ / a.HKV);
    const long long blocks = (rows + BQ - 1) / BQ * a.HKV * a.B;
    kernel<<<static_cast<unsigned>(blocks), THREADS, L::BYTES, stream>>>(args);
    return static_cast<int>(cudaGetLastError());
  }
};

struct Info {
  int* smem_bytes;
  int* blocks_per_sm;
  template <typename T, int DP>
  int run() const {
    using L = Layout<T, DP>;
    auto kernel = flash_fwd_kernel<T, DP, false>;
    cudaError_t err = rt::allow_smem(kernel, L::BYTES);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, THREADS,
                                                          L::BYTES);
    *smem_bytes = static_cast<int>(L::BYTES);
    return static_cast<int>(err);
  }
};

}  // namespace

// q (B,Sq,HQ,dh), k/v (B,Sk,HKV,dh), o (B,Sq,HQ,dh); `strides` holds the
// batch, sequence and head strides (elements) of q, k, v and o in that
// order; the last dimension of each is contiguous. lse: nullptr, or a
// contiguous (B,HQ,Sq) fp32 output for the rows' log-sum-exp of the scaled
// scores (natural log; +inf for a row that sees no key); o is the same
// either way.
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v, void* o,
                                  float* lse, int B, int Sq, int Sk, int HQ, int HKV, int dh,
                                  const long long* strides, int causal, int window, float scale,
                                  int dtype, void* stream) {
  if (dh < 1 || dh > 256 || HKV < 1 || HQ % HKV != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  const long long* st = strides;
  Args a{q, k, v, o, lse, B, Sq, Sk, HQ, HKV, dh, causal, window, /*vec=*/0,
         st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
         scale};
  return dispatch(dtype, dh, Launch{a, static_cast<cudaStream_t>(stream)});
}

// The launch an instantiation gets: its dynamic shared memory and how many
// of its blocks fit on one SM.
extern "C" int rt_flash_info(int dtype, int dh, int* smem_bytes, int* blocks_per_sm) {
  if (dh < 1 || dh > 256) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dtype, dh, Info{smem_bytes, blocks_per_sm});
}
