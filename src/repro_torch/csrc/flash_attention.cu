// Causal / sliding-window GQA flash attention forward, for admission prefill.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_flash_kernel :35, pallas_call :164). On the TPU the grid walked the KV
// axis sequentially, carrying m/l/acc in VMEM scratch across grid steps; on
// Hopper blocks run in parallel and in no order, so one block owns one
// (batch, query head, 32-row query tile) and loops over the K/V tiles
// itself. GQA: query head h reads KV head h / G. The causal frontier and
// the window are loop bounds on the key tiles (the Pallas kernel skipped
// fully masked tiles with pl.when); the per-element mask inside a tile is
// the kernel's (qpos >= kpos, qpos - kpos < window, both inside the
// sequence). There is no padding of dh to 128 (that was for TPU lanes): any
// dh <= 256 works, odd ones too. Q, K and V are read through their strides,
// so the (B, S, H, dh) layout of the model is taken as it is.
//
// What bounds it: at prefill lengths the work is the 4·dh FLOPs per live
// (query, key) pair, so the bound is operations. This first version does
// them on the CUDA cores in fp32 out of shared memory (odd row stride, no
// bank conflicts) — correct and simple; wgmma tiles, TMA staging and a
// warp-specialised pipeline are the later, fast version.
#include "attention_tile.cuh"

namespace {

constexpr int BQ = 32;        // query rows per block
constexpr int THREADS = 128;  // four warps

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int Sq, int Sk, int HQ, int HKV, int dh,
                 long long qsb, long long qss, long long qsh,
                 long long ksb, long long kss, long long ksh,
                 long long vsb, long long vss, long long vsh,
                 long long osb, long long oss, long long osh,
                 int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int ld = rt::tile_ld(dh);
  float* Qs = smem;
  float* Ks = Qs + BQ * ld;
  float* Vs = Ks + rt::BK * ld;
  float* S = Vs + rt::BK * ld;
  float* acc = S + BQ * rt::BK;
  float* m = acc + BQ * dh;
  float* l = m + BQ;
  float* corr = l + BQ;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (HQ / HKV);
  const int tid = threadIdx.x;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  for (int idx = tid; idx < BQ * dh; idx += THREADS) {
    const int i = idx / dh, d = idx % dh;
    Qs[i * ld + d] = (q0 + i < Sq) ? rt::to_f(qb[(q0 + i) * qss + d]) : 0.f;
    acc[idx] = 0.f;
  }
  for (int i = tid; i < BQ; i += THREADS) {
    m[i] = rt::NEG_INF;
    l[i] = 0.f;
  }

  // keys this q-tile can see: [k_lo, k_hi)
  int k_hi = Sk;
  if (causal) k_hi = min(Sk, q0 + BQ);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q0 - window + 1);

  for (int k0 = (k_lo / rt::BK) * rt::BK; k0 < k_hi; k0 += rt::BK) {
    for (int idx = tid; idx < rt::BK * dh; idx += THREADS) {
      const int j = idx / dh, d = idx % dh;
      const bool in = k0 + j < Sk;
      Ks[j * ld + d] = in ? rt::to_f(kb[(k0 + j) * kss + d]) : 0.f;
      Vs[j * ld + d] = in ? rt::to_f(vb[(k0 + j) * vss + d]) : 0.f;
    }
    __syncthreads();
    auto live = [=](int i, int j) {
      const int qp = q0 + i, kp = k0 + j;
      bool ok = qp < Sq && kp < Sk;
      if (causal) ok = ok && qp >= kp;
      if (window > 0) ok = ok && qp - kp < window;
      return ok;
    };
    rt::tile_update(Qs, Ks, Vs, S, acc, m, l, corr, BQ, dh, ld, scale, live);
  }
  __syncthreads();

  T* ob = o + b * osb + h * osh;
  for (int idx = tid; idx < BQ * dh; idx += THREADS) {
    const int i = idx / dh, d = idx % dh;
    if (q0 + i < Sq) ob[(q0 + i) * oss + d] = rt::from_f<T>(acc[idx] / fmaxf(l[i], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk, int HQ,
           int HKV, int dh, const long long* st, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = rt::tile_smem_floats(BQ, dh) * sizeof(float);
  cudaError_t err = rt::allow_smem(flash_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + BQ - 1) / BQ, HQ, B);
  flash_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, HQ, HKV, dh, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B,Sq,HQ,dh), k/v (B,Sk,HKV,dh), o (B,Sq,HQ,dh); `strides` holds the
// batch, sequence and head strides (elements) of q, k, v and o in that
// order; the last dimension of each is contiguous.
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                                  int Sq, int Sk, int HQ, int HKV, int dh,
                                  const long long* strides, int causal, int window, float scale,
                                  int dtype, void* stream) {
  if (dh < 1 || dh > 256 || HKV < 1 || HQ % HKV != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == RT_F32)
    return launch<float>(q, k, v, o, B, Sq, Sk, HQ, HKV, dh, strides, causal, window, scale, s);
  if (dtype == RT_BF16)
    return launch<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, HQ, HKV, dh, strides, causal, window,
                                 scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
