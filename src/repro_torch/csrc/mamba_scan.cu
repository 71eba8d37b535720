// Mamba selective scan with its discretization fused: per batch row b and
// channel d, for every token t and state n
//   h[n] = exp(dt_t * A[d][n]) * h[n] + (dt_t * x_t) * B_t[n]
//   y_t  = sum_n h[n] * C_t[n]
// in fp32, and the final state h after the last token.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba_ssm.py
// (_mamba_kernel :26, pallas_call :74). The TPU kernel runs a grid (B, di
// tiles, S chunks) whose last axis walks the sequence in order, a (di_tile,
// ds) state in VMEM scratch carried across chunks; inside a chunk it forms
// the (chunk, di_tile, ds) gates and runs an associative scan over them, and
// it drops the state when the last chunk ends. Its wrapper pads S and di to
// whole tiles. Here channels are independent, so one thread owns one (b, d)
// and walks all S tokens itself with its ds states and its row of A in
// registers: no associative scan, no carry across blocks, no padding (the
// tail block masks its channels), and the state is stored at the true last
// token, which the serving prefill needs for the decode cache. The gates a
// and (dt x) B are formed in registers and never reach memory.
//
// A block holds 64 channels of one batch row. Per run of 32 tokens it stages
// in shared memory the run's B and C rows (shared by the whole block) and
// each thread's dt and dt x (its own column; the reads coalesced along di),
// so the token loop runs from shared memory without a barrier. States past
// ds (ds below the instantiated width) keep A = 0 and B = C = 0: a = 1, and
// they stay 0 and add nothing to y.
//
// The dtype contract is the JAX oracles' (kernels/ref.py:114,
// models/layers.py:880-893) and so the serving path's: dt x is formed in the
// inputs' dtype and widened after. For bf16 the fp32 product of two bf16
// values is exact and is rounded once to bf16, which is XLA's bf16 multiply.
// (The Pallas kernel widens x and dt first; the two agree in fp32.)
//
// What bounds it: per (b, t, d, n) the function does dt A, exp, (dt x) B,
// a h + bx (two) and h C summed (two): 7 operations on 4 bytes of x, dt and
// y per (b, t, d), i.e. about 2 ds operations per byte, so at ds 16 it is
// bound by bytes on the H100 (20 fp32 operations per byte; at (4, 1024,
// 8192, 16): 406 MB, 0.121 ms, against 3.8 GFLOP, 0.056 ms). The exps go to
// the SFU at 16 per clock per SM: 537 M of them need about 0.13 ms at
// 1.98 GHz, as long as the byte bound. At the serving prefill's S of 32 it is
// bound by the latency of the serial token loop, 2 warps per SM at di 8192.
#include "common.cuh"

namespace {

constexpr int MAX_DS = 32;
constexpr int BLOCK = 64;  // channels per block, one thread each
constexpr int TC = 32;     // tokens per staged run

template <typename T, int DS>
__global__ void __launch_bounds__(BLOCK)
mamba_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                  const float* __restrict__ A, const T* __restrict__ Bv,
                  const T* __restrict__ Cv, float* __restrict__ y,
                  float* __restrict__ h_last, int S, int di, int ds) {
  __shared__ float bs[TC][DS];
  __shared__ float cs[TC][DS];
  __shared__ float dts[TC][BLOCK];
  __shared__ float dxs[TC][BLOCK];

  const int j = threadIdx.x;
  const int b = blockIdx.y;
  const int d = blockIdx.x * BLOCK + j;
  const bool live = d < di;
  const long long row = static_cast<long long>(b) * S;  // token 0 of row b

  float a[DS], h[DS];
#pragma unroll
  for (int n = 0; n < DS; ++n) {
    a[n] = live && n < ds ? A[static_cast<long long>(d) * ds + n] : 0.f;
    h[n] = 0.f;
  }

  for (int t0 = 0; t0 < S; t0 += TC) {
    const int tc = min(TC, S - t0);
    __syncthreads();  // the previous run is consumed
    for (int i = j; i < TC * DS; i += BLOCK) {
      const int t = i / DS, n = i % DS;
      const bool ok = t < tc && n < ds;
      const long long o = (row + t0 + t) * ds + n;
      bs[t][n] = ok ? rt::to_f(Bv[o]) : 0.f;
      cs[t][n] = ok ? rt::to_f(Cv[o]) : 0.f;
    }
    if (live) {
#pragma unroll 8
      for (int t = 0; t < tc; ++t) {
        const long long o = (row + t0 + t) * di + d;
        const float dtv = rt::to_f(dt[o]);
        dts[t][j] = dtv;
        dxs[t][j] = rt::to_f(rt::from_f<T>(dtv * rt::to_f(x[o])));
      }
    }
    __syncthreads();
    if (!live) continue;
    for (int t = 0; t < tc; ++t) {
      const float dtv = dts[t][j], dx = dxs[t][j];
      float acc[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < DS; ++n) {
        h[n] = fmaf(expf(dtv * a[n]), h[n], dx * bs[t][n]);
        acc[n % 2] = fmaf(h[n], cs[t][n], acc[n % 2]);
      }
      y[(row + t0 + t) * di + d] = acc[0] + acc[1];
    }
  }
  if (live) {
    float* hl = h_last + (static_cast<long long>(b) * di + d) * ds;
#pragma unroll
    for (int n = 0; n < DS; ++n)
      if (n < ds) hl[n] = h[n];
  }
}

template <typename T, int DS>
int launch(const void* x, const void* dt, const void* A, const void* Bv, const void* Cv,
           void* y, void* h_last, int B, int S, int di, int ds, cudaStream_t stream) {
  const dim3 grid((di + BLOCK - 1) / BLOCK, B);
  mamba_scan_kernel<T, DS><<<grid, BLOCK, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bv), static_cast<const T*>(Cv), static_cast<float*>(y),
      static_cast<float*>(h_last), S, di, ds);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* dt, const void* A, const void* Bv, const void* Cv,
             void* y, void* h_last, int B, int S, int di, int ds, cudaStream_t s) {
  if (ds <= 4) return launch<T, 4>(x, dt, A, Bv, Cv, y, h_last, B, S, di, ds, s);
  if (ds <= 8) return launch<T, 8>(x, dt, A, Bv, Cv, y, h_last, B, S, di, ds, s);
  if (ds <= 16) return launch<T, 16>(x, dt, A, Bv, Cv, y, h_last, B, S, di, ds, s);
  return launch<T, 32>(x, dt, A, Bv, Cv, y, h_last, B, S, di, ds, s);
}

}  // namespace

// x, dt: (B, S, di) and Bv, Cv: (B, S, ds), contiguous, all float32 or all
// bfloat16 (dtype RT_F32 / RT_BF16); A: (di, ds) contiguous float32; y:
// (B, S, di) float32 output; h_last: (B, di, ds) float32 output, the state
// after token S - 1 (zeros when S is 0). 1 <= ds <= 32.
extern "C" int rt_mamba_scan(const void* x, const void* dt, const void* A, const void* Bv,
                             const void* Cv, void* y, void* h_last, int B, int S, int di,
                             int ds, int dtype, void* stream) {
  if (B < 0 || S < 0 || di < 1 || ds < 1 || ds > MAX_DS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == RT_F32) return dispatch<float>(x, dt, A, Bv, Cv, y, h_last, B, S, di, ds, s);
  if (dtype == RT_BF16)
    return dispatch<__nv_bfloat16>(x, dt, A, Bv, Cv, y, h_last, B, S, di, ds, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
