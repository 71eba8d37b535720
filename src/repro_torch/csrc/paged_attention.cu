// Paged one-token decode attention over a block pool, for the paged KV
// backend (serve/paging.py).
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_decode.py
// (paged_decode_attention, pallas_call :135, body _paged_kernel :29 ->
// decode_attention.py:_decode_kernel; quantized body _paged_kernel_quant
// :37). The chunked-prefill twin is paged_prefill.cu.
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
// One block per (slot, KV head), exactly like slot decode
// (decode_attention.cu): the G query heads of the KV head share each tile,
// so each live key is read once. A tile with no valid key is skipped
// (__syncthreads_or over the validity mask), which is the same arithmetic
// as the online softmax over it (corr = 1, p = 0): the work follows the
// slot's resident length, not the table's width.
//
// Quantized pools (kv_dtype int8 / fp8, kernels/kv_quant.py): the pools
// hold int8 or e4m3 codes and each (block, KV head) has one f32 scale in
// ks/vs (P+1, HKV). On the TPU the scale rode the table indirection as a
// (1, 1) BlockSpec; here resolve_keys, which already reads each key's pool
// row, also reads that row's K and V scale into shared memory: one scale
// load per key, not per element. stage_tile converts each 1-byte code to
// float (exact for both formats) and multiplies by the key's scale in fp32,
// the TPU's k.astype(f32) * ks, so the staged tile is bit-identical to the
// plain version's decoded pool and only the summation order differs. The
// storage type is a template parameter beside the query type; pools are
// read one byte per element through the same element strides.
//
// What bounds it: decode reads each live key's K and V once per KV head
// for 4*dh FLOPs per query head — bytes. It runs the fp32 online softmax
// of attention_tile.cuh on CUDA cores; split-T decode is the later, fast
// version.
#include <cuda_fp8.h>

#include <cstdint>

#include "attention_tile.cuh"

namespace rt {
// The quantized pools' codes as float: exact for both formats.
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) { return static_cast<float>(x); }
}  // namespace rt

namespace {

constexpr int THREADS = 128;  // four warps

// Per-block scales of a quantized pool, as the kernel sees them: the KV
// head's column of ks/vs (P+1, HKV) and the row strides. Unquantized pools
// pass nullptrs and never read them (Q = false).
struct Scales {
  const float* k;
  const float* v;
  long long ksr, vsr;
};

// Shared-memory slots the tile's keys are resolved into: pool row (-1 =
// not loaded), offset in the block and, for quantized pools, the row's K
// and V scale.
struct KeySlots {
  int* row;
  int* off;
  float* ksc;
  float* vsc;
};

// Resolve key t0 + tid of a tile (threads tid < BK): its pool row
// tb[t / bs] and offset t % bs, and with Q that row's scales, or row -1
// when load(t) is false. Returns load(t) (false for the other threads).
template <bool Q, typename Load>
__device__ __forceinline__ bool resolve_keys(KeySlots slots, Scales sc, const int* tb, int bs,
                                             int t0, Load load) {
  const int tid = threadIdx.x;
  if (tid >= rt::BK) return false;
  const int t = t0 + tid;
  const bool in = load(t);
  const int r = in ? tb[t / bs] : -1;
  slots.row[tid] = r;
  slots.off[tid] = t % bs;
  if constexpr (Q) {
    slots.ksc[tid] = in ? sc.k[r * sc.ksr] : 0.f;
    slots.vsc[tid] = in ? sc.v[r * sc.vsr] : 0.f;
  }
  return in;
}

// Stage the tile's keys into Ks/Vs (fp32 rows of stride ld) from the rows
// resolve_keys found, decoded with the key's scale when Q; a key with row
// -1 is zero-filled, never read.
template <bool Q, typename KV>
__device__ __forceinline__ void stage_tile(float* Ks, float* Vs, const KV* kb, const KV* vb,
                                           KeySlots slots, long long ksb, long long kso,
                                           long long vsb, long long vso, int dh, int ld) {
  // unrolled so that a thread keeps several elements' loads in flight:
  // left to itself, the compiler unrolled less for the fp32 pools once the
  // storage type became a template parameter, and fp32 decode slowed down
  // by a quarter
#pragma unroll 4
  for (int idx = threadIdx.x; idx < rt::BK * dh; idx += blockDim.x) {
    const int j = idx / dh, d = idx % dh;
    const int r = slots.row[j];
    float kv = 0.f, vv = 0.f;
    if (r >= 0) {
      kv = rt::to_f(kb[r * ksb + slots.off[j] * kso + d]);
      vv = rt::to_f(vb[r * vsb + slots.off[j] * vso + d]);
      if constexpr (Q) {
        kv *= slots.ksc[j];
        vv *= slots.vsc[j];
      }
    }
    Ks[j * ld + d] = kv;
    Vs[j * ld + d] = vv;
  }
}

// Shared memory of a kernel: the attention tile (tile_smem_floats) and the
// resolved row, offset and (quantized) two scales of each key of the tile.
size_t paged_smem_bytes(int rows, int dh) {
  return rt::tile_smem_floats(rows, dh) * sizeof(float) + 2 * rt::BK * sizeof(int) +
         2 * rt::BK * sizeof(float);
}

// Carve the key slots out of shared memory after the attention tile.
__device__ __forceinline__ KeySlots key_slots(float* after_tile) {
  int* row = reinterpret_cast<int*>(after_tile);
  float* ksc = reinterpret_cast<float*>(row + 2 * rt::BK);
  return {row, row + rt::BK, ksc, ksc + rt::BK};
}

template <typename T, typename KV, bool Q>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
                    const KV* __restrict__ vp, Scales sc, const int* __restrict__ tables,
                    const unsigned char* __restrict__ valid, T* __restrict__ o, int nb, int bs,
                    int HQ, int HKV, int dh, long long qsb, long long qsh, long long ksb,
                    long long kso, long long ksh, long long vsb, long long vso, long long vsh,
                    long long tsb, long long msb, long long osb, long long osh, float scale) {
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
  const KeySlots slots = key_slots(corr + G);

  const int hk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int Tn = nb * bs;
  const T* qb = q + b * qsb + static_cast<long long>(hk) * G * qsh;
  const KV* kb = kp + hk * ksh;
  const KV* vb = vp + hk * vsh;
  if constexpr (Q) {
    sc.k += hk;
    sc.v += hk;
  }
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
    // skip a tile with no valid key; the barrier also publishes the slots
    if (!__syncthreads_or(resolve_keys<Q>(slots, sc, tb, bs, t0, live_key))) continue;
    stage_tile<Q>(Ks, Vs, kb, vb, slots, ksb, kso, vsb, vso, dh, ld);
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

template <typename T, typename KV, bool Q>
int launch_decode(const void* q, const void* kp, const void* vp, Scales sc, const void* tables,
                  const void* valid, void* o, int B, int nb, int bs, int HQ, int HKV, int dh,
                  const long long* st, float scale, cudaStream_t stream) {
  const size_t smem = paged_smem_bytes(HQ / HKV, dh);
  cudaError_t err = rt::allow_smem(paged_decode_kernel<T, KV, Q>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(HKV, B);
  paged_decode_kernel<T, KV, Q><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(kp), static_cast<const KV*>(vp), sc,
      static_cast<const int*>(tables), static_cast<const unsigned char*>(valid),
      static_cast<T*>(o), nb, bs, HQ, HKV, dh, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], scale);
  return static_cast<int>(cudaGetLastError());
}

// The quantized launches by query type (RT_F32 / RT_BF16) and storage type
// (RT_I8 / RT_E4M3); the caller has checked the shapes.
template <typename T>
int launch_decode_quant(const void* q, const void* kp, const void* vp, Scales sc,
                        const void* tables, const void* valid, void* o, int B, int nb, int bs,
                        int HQ, int HKV, int dh, const long long* st, float scale, int kv_dtype,
                        cudaStream_t s) {
  if (kv_dtype == RT_I8)
    return launch_decode<T, int8_t, true>(q, kp, vp, sc, tables, valid, o, B, nb, bs, HQ, HKV,
                                          dh, st, scale, s);
  if (kv_dtype == RT_E4M3)
    return launch_decode<T, __nv_fp8_e4m3, true>(q, kp, vp, sc, tables, valid, o, B, nb, bs,
                                                 HQ, HKV, dh, st, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

bool bad_heads(int HQ, int HKV, int dh) {
  return dh < 1 || dh > 256 || HKV < 1 || HQ % HKV != 0;
}

constexpr Scales NO_SCALES{nullptr, nullptr, 0, 0};

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
    return launch_decode<float, float, false>(q, kp, vp, NO_SCALES, tables, valid, o, B, nb,
                                              bs, HQ, HKV, dh, strides, scale, s);
  if (dtype == RT_BF16)
    return launch_decode<__nv_bfloat16, __nv_bfloat16, false>(
        q, kp, vp, NO_SCALES, tables, valid, o, B, nb, bs, HQ, HKV, dh, strides, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The fused-dequant variant: as above with kp/vp int8 (kv_dtype RT_I8) or
// float8 e4m3 (RT_E4M3) codes and ks/vs (P+1,HKV) f32 per-block scales
// (last dimension contiguous). `strides` as above, then ks block, vs block.
extern "C" int rt_paged_decode_attention_quant(const void* q, const void* kp, const void* vp,
                                               const void* ks, const void* vs,
                                               const void* tables, const void* valid, void* o,
                                               int B, int nb, int bs, int HQ, int HKV, int dh,
                                               const long long* strides, float scale, int dtype,
                                               int kv_dtype, void* stream) {
  if (bad_heads(HQ, HKV, dh) || bs < 1 || nb < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Scales sc{static_cast<const float*>(ks), static_cast<const float*>(vs), strides[12],
                  strides[13]};
  if (dtype == RT_F32)
    return launch_decode_quant<float>(q, kp, vp, sc, tables, valid, o, B, nb, bs, HQ, HKV, dh,
                                      strides, scale, kv_dtype, s);
  if (dtype == RT_BF16)
    return launch_decode_quant<__nv_bfloat16>(q, kp, vp, sc, tables, valid, o, B, nb, bs, HQ,
                                              HKV, dh, strides, scale, kv_dtype, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
