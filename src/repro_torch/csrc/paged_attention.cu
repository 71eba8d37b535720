// Paged attention over a block pool: one-token decode and chunked prefill,
// for the paged KV backend (serve/paging.py).
//
// Replaces two Pallas TPU kernels:
//   src/repro/kernels/paged_decode.py  (paged_decode_attention, pallas_call
//     :135, body _paged_kernel :29 -> decode_attention.py:_decode_kernel)
//   src/repro/kernels/paged_prefill.py (paged_prefill_attention, pallas_call
//     :185, body _paged_prefill_kernel :43)
// The quantized bodies (_paged_kernel_quant, _paged_prefill_kernel_quant)
// are not ported here: they need quantized KV first.
//
// The KV cache is a pool (P+1, bs, HKV, dh) of fixed-size blocks; each slot
// owns a chain of them, listed in its row of the (B, nb) block table, and
// logical key t of a slot lives at pool row tables[b, t / bs], offset
// t % bs. Row P is the trash block: empty and finished slots point there,
// and the tail of a slot's last block holds stale keys — the masks below
// must (and do) keep both out of every softmax.
//
// On the TPU the table was scalar-prefetched and consumed by a BlockSpec
// index map, so the DMA engine did the gather. A GPU block has no such map:
// it resolves each key of a 32-key tile to its pool row itself: one thread
// per key reads tables[b, t / bs] into shared memory, then the block
// stages the tile's K and V rows from those addresses. So the table read
// is one load per key, not a load ahead of every element, and the
// gathered view never exists in device memory. Keys the mask rules out
// are zero-filled instead of loaded, so garbage in the trash row or a
// block tail is never read at all.
//
// paged decode: one block per (slot, KV head), exactly like slot decode
// (decode_attention.cu): the G query heads of the KV head share each tile,
// so each live key is read once. A tile with no valid key is skipped
// (__syncthreads_or over the validity mask), which is the same arithmetic
// as the online softmax over it (corr = 1, p = 0): the work follows the
// slot's resident length, not the table's width.
//
// paged prefill: the W chunk queries of a (slot, KV head) are W*G query
// rows (row r is chunk position r / G, query head h*G + r % G). The Pallas
// kernel kept all W*G rows in one program; at the default chunk width of
// 72 that is 576 rows, far beyond a block's shared memory and registers.
// So the rows are tiled over the grid, 32 per block: (row tile, KV head,
// slot), each block walking the chain. Row r sits at position start[b] +
// r / G and sees keys t <= that position (the Pallas mask
// i*bs + j <= start[b] + w). Keys past the tile's last row position are
// fully masked, so they bound the loop — the Pallas kernel read all nb
// blocks; the result is the same. q and o are read and written through
// their (B, W, HQ, dh) strides: no transpose copy.
//
// What bounds them: decode reads each live key's K and V once per KV head
// for 4*dh FLOPs per query head — bytes. Prefill at chunk widths of tens of
// tokens does W*G times more work per key byte, and at W = 256 it is
// bound by operations. Both run the fp32 online softmax of
// attention_tile.cuh on CUDA cores; split-T decode and tensor-core prefill
// tiles are the later, fast versions.
#include "attention_tile.cuh"

namespace {

constexpr int THREADS = 128;  // four warps
constexpr int BQ = 32;        // prefill: query rows (of W*G) per block

// Resolve key t0 + tid of a tile (threads tid < BK): its pool row
// tb[t / bs] and offset t % bs into prow/poff, or row -1 when load(t) is
// false. Returns load(t) (false for the other threads).
template <typename Load>
__device__ __forceinline__ bool resolve_keys(int* prow, int* poff, const int* tb, int bs, int t0,
                                             Load load) {
  const int tid = threadIdx.x;
  if (tid >= rt::BK) return false;
  const int t = t0 + tid;
  const bool in = load(t);
  prow[tid] = in ? tb[t / bs] : -1;
  poff[tid] = t % bs;
  return in;
}

// Stage the tile's keys into Ks/Vs (fp32 rows of stride ld) from the rows
// resolve_keys found; a key with row -1 is zero-filled, never read.
template <typename T>
__device__ __forceinline__ void stage_tile(float* Ks, float* Vs, const T* kb, const T* vb,
                                           const int* prow, const int* poff, long long ksb,
                                           long long kso, long long vsb, long long vso, int dh,
                                           int ld) {
  for (int idx = threadIdx.x; idx < rt::BK * dh; idx += blockDim.x) {
    const int j = idx / dh, d = idx % dh;
    const int r = prow[j];
    float kv = 0.f, vv = 0.f;
    if (r >= 0) {
      kv = rt::to_f(kb[r * ksb + poff[j] * kso + d]);
      vv = rt::to_f(vb[r * vsb + poff[j] * vso + d]);
    }
    Ks[j * ld + d] = kv;
    Vs[j * ld + d] = vv;
  }
}

// Shared memory of a kernel: the attention tile (tile_smem_floats) and the
// resolved row and offset of each key of the tile.
size_t paged_smem_bytes(int rows, int dh) {
  return rt::tile_smem_floats(rows, dh) * sizeof(float) + 2 * rt::BK * sizeof(int);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
                    const int* __restrict__ tables, const unsigned char* __restrict__ valid,
                    T* __restrict__ o, int nb, int bs, int HQ, int HKV, int dh, long long qsb,
                    long long qsh, long long ksb, long long kso, long long ksh, long long vsb,
                    long long vso, long long vsh, long long tsb, long long msb, long long osb,
                    long long osh, float scale) {
  extern __shared__ float smem[];
  const int G = HQ / HKV;
  const int ld = rt::tile_ld(dh);
  float* Qs = smem;
  float* Ks = Qs + G * ld;
  float* Vs = Ks + rt::BK * ld;
  float* S = Vs + rt::BK * ld;
  float* acc = S + G * rt::BK;
  float* m = acc + G * dh;
  float* l = m + G;
  float* corr = l + G;
  int* prow = reinterpret_cast<int*>(corr + G);
  int* poff = prow + rt::BK;

  const int hk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int Tn = nb * bs;
  const T* qb = q + b * qsb + static_cast<long long>(hk) * G * qsh;
  const T* kb = kp + hk * ksh;
  const T* vb = vp + hk * vsh;
  const int* tb = tables + b * tsb;
  const unsigned char* mb = valid + b * msb;

  for (int idx = tid; idx < G * dh; idx += THREADS) {
    const int i = idx / dh, d = idx % dh;
    Qs[i * ld + d] = rt::to_f(qb[i * qsh + d]);
    acc[idx] = 0.f;
  }
  for (int i = tid; i < G; i += THREADS) {
    m[i] = rt::NEG_INF;
    l[i] = 0.f;
  }

  auto live_key = [=](int t) { return t < Tn && mb[t] != 0; };
  for (int t0 = 0; t0 < Tn; t0 += rt::BK) {
    // skip a tile with no valid key; the barrier also publishes prow/poff
    if (!__syncthreads_or(resolve_keys(prow, poff, tb, bs, t0, live_key))) continue;
    stage_tile(Ks, Vs, kb, vb, prow, poff, ksb, kso, vsb, vso, dh, ld);
    __syncthreads();
    auto live = [=](int, int j) { return live_key(t0 + j); };
    rt::tile_update(Qs, Ks, Vs, S, acc, m, l, corr, G, dh, ld, scale, live);
  }
  __syncthreads();

  T* ob = o + b * osb + static_cast<long long>(hk) * G * osh;
  for (int idx = tid; idx < G * dh; idx += THREADS) {
    const int i = idx / dh, d = idx % dh;
    ob[i * osh + d] = rt::from_f<T>(acc[idx] / fmaxf(l[i], 1e-30f));
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
                     const int* __restrict__ tables, const int* __restrict__ start,
                     T* __restrict__ o, int W, int nb, int bs, int HQ, int HKV, int dh,
                     long long qsb, long long qsw, long long qsh, long long ksb, long long kso,
                     long long ksh, long long vsb, long long vso, long long vsh, long long tsb,
                     long long osb, long long osw, long long osh, float scale) {
  extern __shared__ float smem[];
  const int G = HQ / HKV;
  const int ld = rt::tile_ld(dh);
  float* Qs = smem;
  float* Ks = Qs + BQ * ld;
  float* Vs = Ks + rt::BK * ld;
  float* S = Vs + rt::BK * ld;
  float* acc = S + BQ * rt::BK;
  float* m = acc + BQ * dh;
  float* l = m + BQ;
  float* corr = l + BQ;
  int* prow = reinterpret_cast<int*>(corr + BQ);
  int* poff = prow + rt::BK;

  const int r0 = blockIdx.x * BQ, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int rows = W * G, Tn = nb * bs;
  const int s0 = start[b];
  const T* qb = q + b * qsb + static_cast<long long>(hk) * G * qsh;
  const T* kb = kp + hk * ksh;
  const T* vb = vp + hk * vsh;
  const int* tb = tables + b * tsb;

  for (int idx = tid; idx < BQ * dh; idx += THREADS) {
    const int i = idx / dh, d = idx % dh;
    const int r = r0 + i;
    Qs[i * ld + d] = r < rows ? rt::to_f(qb[(r / G) * qsw + (r % G) * qsh + d]) : 0.f;
    acc[idx] = 0.f;
  }
  for (int i = tid; i < BQ; i += THREADS) {
    m[i] = rt::NEG_INF;
    l[i] = 0.f;
  }

  // keys any row of this tile can see: t <= s0 + (last row) / G
  const int k_hi = min(Tn, s0 + (min(r0 + BQ, rows) - 1) / G + 1);
  auto in_range = [=](int t) { return t < k_hi; };
  for (int k0 = 0; k0 < k_hi; k0 += rt::BK) {
    resolve_keys(prow, poff, tb, bs, k0, in_range);
    __syncthreads();
    stage_tile(Ks, Vs, kb, vb, prow, poff, ksb, kso, vsb, vso, dh, ld);
    __syncthreads();
    auto live = [=](int i, int j) {
      const int r = r0 + i, t = k0 + j;
      return r < rows && t < k_hi && t <= s0 + r / G;
    };
    rt::tile_update(Qs, Ks, Vs, S, acc, m, l, corr, BQ, dh, ld, scale, live);
  }
  __syncthreads();

  T* ob = o + b * osb + static_cast<long long>(hk) * G * osh;
  for (int idx = tid; idx < BQ * dh; idx += THREADS) {
    const int i = idx / dh, d = idx % dh;
    const int r = r0 + i;
    if (r < rows) ob[(r / G) * osw + (r % G) * osh + d] = rt::from_f<T>(acc[idx] / fmaxf(l[i], 1e-30f));
  }
}

template <typename T>
int launch_decode(const void* q, const void* kp, const void* vp, const void* tables,
                  const void* valid, void* o, int B, int nb, int bs, int HQ, int HKV, int dh,
                  const long long* st, float scale, cudaStream_t stream) {
  const size_t smem = paged_smem_bytes(HQ / HKV, dh);
  cudaError_t err = rt::allow_smem(paged_decode_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(HKV, B);
  paged_decode_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      static_cast<const int*>(tables), static_cast<const unsigned char*>(valid),
      static_cast<T*>(o), nb, bs, HQ, HKV, dh, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_prefill(const void* q, const void* kp, const void* vp, const void* tables,
                   const void* start, void* o, int B, int W, int nb, int bs, int HQ, int HKV,
                   int dh, const long long* st, float scale, cudaStream_t stream) {
  const size_t smem = paged_smem_bytes(BQ, dh);
  cudaError_t err = rt::allow_smem(paged_prefill_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((W * (HQ / HKV) + BQ - 1) / BQ, HKV, B);
  paged_prefill_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      static_cast<const int*>(tables), static_cast<const int*>(start), static_cast<T*>(o), W,
      nb, bs, HQ, HKV, dh, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], st[12], scale);
  return static_cast<int>(cudaGetLastError());
}

bool bad_heads(int HQ, int HKV, int dh) {
  return dh < 1 || dh > 256 || HKV < 1 || HQ % HKV != 0;
}

}  // namespace

// q (B,HQ,dh), kp/vp (P+1,bs,HKV,dh), tables (B,nb) int32, valid (B,nb*bs)
// bool, o (B,HQ,dh). `strides` (elements): q batch, head; kp block, offset,
// head; vp block, offset, head; tables batch; valid batch; o batch, head.
// The last dimension of each is contiguous.
extern "C" int rt_paged_decode_attention(const void* q, const void* kp, const void* vp,
                                         const void* tables, const void* valid, void* o, int B,
                                         int nb, int bs, int HQ, int HKV, int dh,
                                         const long long* strides, float scale, int dtype,
                                         void* stream) {
  if (bad_heads(HQ, HKV, dh) || bs < 1 || nb < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == RT_F32)
    return launch_decode<float>(q, kp, vp, tables, valid, o, B, nb, bs, HQ, HKV, dh, strides,
                                scale, s);
  if (dtype == RT_BF16)
    return launch_decode<__nv_bfloat16>(q, kp, vp, tables, valid, o, B, nb, bs, HQ, HKV, dh,
                                        strides, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// q (B,W,HQ,dh), kp/vp (P+1,bs,HKV,dh), tables (B,nb) int32, start (B,)
// int32 contiguous, o (B,W,HQ,dh). `strides` (elements): q batch, position,
// head; kp block, offset, head; vp block, offset, head; tables batch; o
// batch, position, head. The last dimension of each is contiguous.
extern "C" int rt_paged_prefill_attention(const void* q, const void* kp, const void* vp,
                                          const void* tables, const void* start, void* o,
                                          int B, int W, int nb, int bs, int HQ, int HKV, int dh,
                                          const long long* strides, float scale, int dtype,
                                          void* stream) {
  if (bad_heads(HQ, HKV, dh) || bs < 1 || nb < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || W == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == RT_F32)
    return launch_prefill<float>(q, kp, vp, tables, start, o, B, W, nb, bs, HQ, HKV, dh,
                                 strides, scale, s);
  if (dtype == RT_BF16)
    return launch_prefill<__nv_bfloat16>(q, kp, vp, tables, start, o, B, W, nb, bs, HQ, HKV,
                                         dh, strides, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
