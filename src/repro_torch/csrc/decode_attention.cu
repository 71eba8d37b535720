// Slot-aware one-token decode attention (flash-decode), for engine decode.
//
// Replaces the Pallas TPU kernel src/repro/kernels/slot_decode.py
// (slot_decode_attention :28, pallas_call :52) with its body
// decode_attention.py:_decode_kernel :22; the uniform decode_attention
// (decode_attention.py:55) broadcasts its (T,) mask and reaches this same
// kernel. One block owns one (slot, KV head): the G query heads of that KV
// head are the rows of the tile step, so each K/V tile is read from device
// memory once for all of them, and the block walks the cache T in 32-key
// tiles with an online fp32 softmax. The validity mask (circular-buffer
// occupancy, slot_pos >= 0, the sliding window) is precomputed per slot by
// the wrapper, exactly as in kernels/ops.py, so the kernel stays branch-free
// on positions. A row with no valid key writes zeros (l is clamped at
// 1e-30), as _decode_kernel does. K and V are read in the engine's
// (B, T, HKV, dh) cache layout through their strides — no transpose copy.
//
// What bounds it: decode attention does 4·dh FLOPs per cached key per query
// head against 2·dh·sizeof(T) bytes of K+V per key per KV head, so it is
// bound by bytes: one pass over the cache is the minimum, and this kernel
// makes exactly one. With only B·HKV blocks (16 at four tinyllama slots) it
// fills a few of the 132 SMs; splitting T across blocks with a second
// reduction pass (flash-decoding) is the later, fast version.
#include "attention_tile.cuh"

namespace {

constexpr int THREADS = 128;

template <typename T>
__global__ void __launch_bounds__(THREADS)
slot_decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const unsigned char* __restrict__ valid, T* __restrict__ o, int Tn, int HQ,
                   int HKV, int dh, long long qsb, long long qsh,
                   long long ksb, long long kst, long long ksh,
                   long long vsb, long long vst, long long vsh,
                   long long msb, long long osb, long long osh, float scale) {
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

  const int hk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const T* qb = q + b * qsb + static_cast<long long>(hk) * G * qsh;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;
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

  for (int t0 = 0; t0 < Tn; t0 += rt::BK) {
    for (int idx = tid; idx < rt::BK * dh; idx += THREADS) {
      const int j = idx / dh, d = idx % dh;
      const bool in = t0 + j < Tn;
      Ks[j * ld + d] = in ? rt::to_f(kb[(t0 + j) * kst + d]) : 0.f;
      Vs[j * ld + d] = in ? rt::to_f(vb[(t0 + j) * vst + d]) : 0.f;
    }
    __syncthreads();
    auto live = [=](int, int j) { return t0 + j < Tn && mb[t0 + j] != 0; };
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
int launch(const void* q, const void* k, const void* v, const void* valid, void* o, int B,
           int Tn, int HQ, int HKV, int dh, const long long* st, float scale,
           cudaStream_t stream) {
  const size_t smem = rt::tile_smem_floats(HQ / HKV, dh) * sizeof(float);
  cudaError_t err = rt::allow_smem(slot_decode_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(HKV, B);
  slot_decode_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const unsigned char*>(valid), static_cast<T*>(o), Tn, HQ, HKV, dh, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B,HQ,dh), k/v (B,T,HKV,dh), valid (B,T) bool, o (B,HQ,dh). `strides`
// (elements): q batch, q head; k batch, time, head; v batch, time, head;
// valid batch; o batch, o head. The last dimension of each is contiguous.
extern "C" int rt_slot_decode_attention(const void* q, const void* k, const void* v,
                                        const void* valid, void* o, int B, int Tn, int HQ,
                                        int HKV, int dh, const long long* strides, float scale,
                                        int dtype, void* stream) {
  if (dh < 1 || dh > 256 || HKV < 1 || HQ % HKV != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == RT_F32)
    return launch<float>(q, k, v, valid, o, B, Tn, HQ, HKV, dh, strides, scale, s);
  if (dtype == RT_BF16)
    return launch<__nv_bfloat16>(q, k, v, valid, o, B, Tn, HQ, HKV, dh, strides, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
