// RWKV-6 time-mix recurrence: per (batch, head), for every token t
//   y_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j] = w_t[i] * S[i][j] + k_t[i] * v_t[j]
// in fp32, and the final state S after the last token.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6.py (_rwkv_kernel
// :28, pallas_call :75). The TPU kernel runs a grid (B, nh, chunks) whose
// last axis walks the sequence in order, the (hd, hd) state held in VMEM
// scratch across chunks, and drops that state when the last chunk ends; its
// wrapper transposes r/k/v/w to (B, nh, S, hd) and pads S to whole chunks
// (w with 1.0). Here one block owns one (b, h) and walks all S tokens itself:
// no transposes, no padding, and the state is stored at the true last token,
// which the serving prefill needs for the decode cache.
//
// As in the reference CUDA RWKV-6 kernel, each thread owns one value column
// j and keeps S[:, j] (hd floats) in registers. A chunk of tokens' r, k, w
// and v rows is staged in shared memory between two barriers, so the token
// loop itself runs without one: every thread reads r_t[i], k_t[i], w_t[i]
// as shared-memory broadcasts and its own v_t[j]. Columns past hd (hd below
// the instantiated width) stage r = k = v = 0 and w = 1: their terms add
// nothing and their state stays 0. y[t][j] is summed in four partial sums
// so the dependent chain is hd / 4 long.
//
// What bounds it: the function needs 5 hd^2 + 5 hd flops per (token,
// head) -- the read-out sum_i r_i S_ij (one fma per element), the decay
// and add w_i S_ij + k_i v_j (a multiply and an fma per element) and the
// bonus v_j * sum_i r_i u_i k_i (O(hd)) -- against 5 hd floats read and
// written per (token, head) plus hd^2 for the state once: about hd / 4
// flops per byte, so at hd 64 it is bound by bytes on the H100 (20 fp32
// flops per byte; at (4, 1024, 64, 64): 340 MB, 0.101 ms, against
// 5.5 GFLOP, 0.081 ms). This kernel does 7 hd^2: it recomputes the
// bonus per element (u_i k_i v_j) rather than once per token. At the
// serving prefill's S of 32 it is bound by the latency of the serial token
// loop. The grid is only B * nh blocks (64 at one admission of rwkv6-7b):
// parallelising over tokens (a chunked form) is later work.
#include "common.cuh"

namespace {

constexpr int MAX_HD = 128;
constexpr int STAGE = 2048;  // floats per staged array and chunk: tokens * HD

template <int HD>
__global__ void __launch_bounds__(HD)
rwkv_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, float* __restrict__ y,
                 float* __restrict__ state, int S, int nh, int hd) {
  constexpr int TC = STAGE / HD;  // tokens per staged chunk
  __shared__ __align__(16) float rs[TC][HD];
  __shared__ __align__(16) float ks[TC][HD];
  __shared__ __align__(16) float ws[TC][HD];
  __shared__ __align__(16) float vs[TC][HD];
  __shared__ __align__(16) float us[HD];

  const int j = threadIdx.x;  // this thread's value column
  const int bh = blockIdx.x, b = bh / nh, h = bh % nh;
  const bool live = j < hd;
  const long long row = static_cast<long long>(nh) * hd;  // one token's stride
  const long long base = static_cast<long long>(b) * S * row + static_cast<long long>(h) * hd + j;

  us[j] = live ? u[h * hd + j] : 0.f;
  float s[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) s[i] = 0.f;

  for (int t0 = 0; t0 < S; t0 += TC) {
    const int tc = min(TC, S - t0);
    __syncthreads();  // the previous chunk is consumed
    for (int t = 0; t < tc; ++t) {
      const long long o = base + (t0 + t) * row;
      rs[t][j] = live ? r[o] : 0.f;
      ks[t][j] = live ? k[o] : 0.f;
      ws[t][j] = live ? w[o] : 1.f;
      vs[t][j] = live ? v[o] : 0.f;
    }
    __syncthreads();
    for (int t = 0; t < tc; ++t) {
      const float vj = vs[t][j];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < HD; ++i) {
        const float kv = ks[t][i] * vj;
        acc[i % 4] = fmaf(rs[t][i], fmaf(us[i], kv, s[i]), acc[i % 4]);
        s[i] = fmaf(ws[t][i], s[i], kv);
      }
      if (live) y[base + (t0 + t) * row] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
  }
  if (live) {
    float* st = state + static_cast<long long>(bh) * hd * hd + j;  // [b, h, i, j]
#pragma unroll
    for (int i = 0; i < HD; ++i)
      if (i < hd) st[static_cast<long long>(i) * hd] = s[i];
  }
}

template <int HD>
int launch(const float* r, const float* k, const float* v, const float* w, const float* u,
           float* y, float* state, int B, int S, int nh, int hd, cudaStream_t stream) {
  rwkv_scan_kernel<HD><<<B * nh, HD, 0, stream>>>(r, k, v, w, u, y, state, S, nh, hd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v, w: (B, S, nh, hd) contiguous float32; u: (nh, hd) contiguous
// float32; y: (B, S, nh, hd) float32 output; state: (B, nh, hd, hd) float32
// output [b, h, k, v]. 1 <= hd <= 128.
extern "C" int rt_rwkv_scan(const void* r, const void* k, const void* v, const void* w,
                            const void* u, void* y, void* state, int B, int S, int nh, int hd,
                            void* stream) {
  if (B < 0 || S < 0 || nh < 1 || hd < 1 || hd > MAX_HD)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *rf = static_cast<const float*>(r), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v), *wf = static_cast<const float*>(w),
              *uf = static_cast<const float*>(u);
  float *yf = static_cast<float*>(y), *sf = static_cast<float*>(state);
  if (hd <= 16) return launch<16>(rf, kf, vf, wf, uf, yf, sf, B, S, nh, hd, s);
  if (hd <= 32) return launch<32>(rf, kf, vf, wf, uf, yf, sf, B, S, nh, hd, s);
  if (hd <= 64) return launch<64>(rf, kf, vf, wf, uf, yf, sf, B, S, nh, hd, s);
  return launch<128>(rf, kf, vf, wf, uf, yf, sf, B, S, nh, hd, s);
}
