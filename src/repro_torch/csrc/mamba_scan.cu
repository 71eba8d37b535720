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
// whole tiles. Here channels are independent, so a channel's lanes walk all
// S tokens themselves with its states and its row of A in registers: no
// associative scan, no carry across blocks, no padding (the tail block
// masks its channels), and the state is stored at the true last token,
// which the serving prefill needs for the decode cache. The gates a and
// (dt x) B are formed in registers and never reach memory.
//
// The dtype contract is the JAX oracles' (kernels/ref.py:114,
// models/layers.py:880-893) and so the serving path's: dt x is formed in the
// inputs' dtype and widened after. For bf16 the fp32 product of two bf16
// values is exact and is rounded once to bf16, which is XLA's bf16 multiply.
// (The Pallas kernel widens x and dt first; the two agree in fp32.) The
// product is formed where a token's x and dt are read from the staged run.
//
// What bounds it: per (b, t, d, n) the function does dt A, exp, (dt x) B,
// a h + bx (two) and h C summed (two): 7 operations on 4 bytes of x, dt and
// y per (b, t, d), i.e. about 2 ds operations per byte, so at ds 16 it is
// bound by bytes on the H100 (20 fp32 operations per byte; at (4, 1024,
// 8192, 16): 406 MB, 0.121 ms, against 3.8 GFLOP, 0.056 ms). The exps go to
// the SFU at 16 per clock per SM: 537 M of them need about 0.13 ms at
// 1.98 GHz, as long as the byte bound. The accurate expf is about 8
// instructions around its one SFU op, 12 for a state and token: issued,
// near 0.2 ms at (4, 1024, 8192, 16). At the serving prefill's S of 32
// (jamba: B 1, di 8192) the tokens are few and serial: what counts is how
// many warps share the SMs and how short a token's instruction stream is.
//
// Design (the geometry from kernels/mamba_ssm.py: mamba_geometry, checked
// here):
// - The gate is 2^(dt * (A log2 e)) on the SFU (ex2.approx), A scaled once
//   as it is loaded: 5 instructions a state and token where expf takes 12.
//   Measured on the H100 against the plain version (torch.exp), y and the
//   state agree within 5.8e-6 (fp32; 7.7e-6 from bf16 inputs) at (4,
//   1024, 8192, 16) and 3.9e-6 at jamba's admission, against gates of
//   1e-4 (chip_smoke.py's mamba_scan phase).
// - A channel's states are split over LANES adjacent lanes of a warp, NS
//   states a lane (LANES * NS >= ds: at ds 16, 4 lanes of 4); a block is
//   128 threads, 32 channels at ds 16. jamba's admission runs 256 blocks
//   of 4 warps, 4x the warps of the first design (one thread a channel,
//   128 blocks of 2 warps). A lane loads its states' B and C once a token
//   as 16-byte shared loads (8 for bf16). (A lane holding 4 channels and
//   reusing B and C over them measured no faster at (4, 1024, 8192, 16)
//   and was dropped.) The lane counts and shared-memory strides are
//   compile-time.
// - The partial sums of up to 4 tokens are added over the LANES lanes at
//   once in a scattering xor-shuffle tree (common.cuh: scatter_sum;
//   offsets 1, 2, 4, ..., no branch), after which lane q < 4 holds one
//   token's y and stores it; software-pipelined, a batch's tree is summed
//   after the next batch's partials are formed.
// - A run of tc tokens of x, dt (the block's channels, coalesced along di)
//   and B, C (the whole row, shared by the block) is staged by the whole
//   block with cp.async (16 bytes a copy where the row and the pointers
//   allow it, else 8 or 4, else element copies) into one of three
//   buffers: runs c + 1 and c + 2 are in flight while run c is consumed,
//   one barrier a run. States past ds keep A = 0 and B = C = 0
//   (zero-filled): a = 1, and they stay 0 and add nothing; channels past
//   di read dt = 0 and write nothing.
#include <cstdint>

#include "common.cuh"
#include "cp_async.cuh"

namespace {

// threads a block; the kernel's launch bounds name a minimum of one block
// an SM, so ptxas may take up to 255 registers a thread (without it,
// it spilled a few bytes in four instantiations)
constexpr int THREADS = 128;
// Tokens whose partials one shuffle tree sums: up to 4, fewer where their
// loads (2 NS + 2 floats each) would pass 64 registers. A power of two,
// at most LANES: a lane ends with one token's sum.
__host__ __device__ constexpr int tokens_a_tree(int ns) {
  int nt = 4;
  while (nt > 1 && nt * (2 * ns + 2) > 64) nt /= 2;
  return nt;
}
constexpr int MAX_SMEM = 227 * 1024;
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ __forceinline__ int pad16(int n) { return (n + 7) & ~7; }

// Shared elements of one staged run: x and dt (tc x cb each), B and C
// (tc x dsp each), each padded to a whole 16 bytes.
__host__ __device__ __forceinline__ int run_elems(int tc, int cb, int dsp) {
  return 2 * pad16(tc * cb) + 2 * pad16(tc * dsp);
}

// Stage run `run` of tc tokens into its buffer: x and dt of the block's
// CB channels (zero past di), B and C of every state (zero past ds).
template <typename T, int CB, int DSP>
__device__ __forceinline__ void stage_run(T* buf, const T* x, const T* dt, const T* Bv,
                                          const T* Cv, long long row0, int run, int S, int tc,
                                          int di, int ds, int d0, int vx, int vbc) {
  const long long t0 = row0 + static_cast<long long>(run) * tc;
  const int n = min(tc, S - run * tc);
  const int xt = pad16(tc * CB), bt = pad16(tc * DSP);
  rt::stage_rows(buf, CB, x + t0 * di + d0, di, n, CB, di - d0, vx, threadIdx.x, THREADS);
  rt::stage_rows(buf + xt, CB, dt + t0 * di + d0, di, n, CB, di - d0, vx, threadIdx.x,
                 THREADS);
  rt::stage_rows(buf + 2 * xt, DSP, Bv + t0 * ds, ds, n, DSP, ds, vbc, threadIdx.x, THREADS);
  rt::stage_rows(buf + 2 * xt + bt, DSP, Cv + t0 * ds, ds, n, DSP, ds, vbc, threadIdx.x,
                 THREADS);
  rt::cp_async_commit();
}

// NT consecutive tokens of a staged run (X, DT at the first token's row and
// the lane's channel, BB, CC at its first state): the lane's NS states
// advanced and its partial y of each token into acc.
template <typename T, int NS, int LANES, int NT>
__device__ __forceinline__ void mamba_tokens(const T* X, const T* DT, const T* BB,
                                             const T* CC, const float (&a2)[NS],
                                             float (&h)[NS], float (&acc)[NT]) {
  constexpr int CB = THREADS / LANES, DSP = LANES * NS;
#pragma unroll
  for (int b = 0; b < NT; ++b) {
    float bb[NS], cc[NS];
    rt::load_n(BB + b * DSP, bb);
    rt::load_n(CC + b * DSP, cc);
    const float dtv = rt::to_f(DT[b * CB]);
    // dt x in the inputs' dtype, widened after (the oracles' contract)
    const float dx = rt::to_f(rt::from_f<T>(dtv * rt::to_f(X[b * CB])));
    float a = 0.f;
#pragma unroll
    for (int m = 0; m < NS; ++m) {
      h[m] = fmaf(rt::ex2(dtv * a2[m]), h[m], dx * bb[m]);
      a = fmaf(h[m], cc[m], a);
    }
    acc[b] = a;
  }
}

template <typename T, int NS, int LANES>
__global__ void __launch_bounds__(THREADS, 1)
mamba_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                  const float* __restrict__ A, const T* __restrict__ Bv,
                  const T* __restrict__ Cv, float* __restrict__ y,
                  float* __restrict__ h_last, int S, int di, int ds, int tc, int vx, int vbc) {
  constexpr int CB = THREADS / LANES;       // channels a block
  constexpr int DSP = LANES * NS;           // states, padded
  constexpr int TB = tokens_a_tree(NS);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int q = threadIdx.x % LANES;        // the lane's place in its group
  const int c = threadIdx.x / LANES;        // the group's channel in the block
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CB, d = d0 + c;
  const bool live = d < di;
  const int n0 = q * NS;
  const int per_run = run_elems(tc, CB, DSP);
  const int xt = pad16(tc * CB), bt = pad16(tc * DSP);  // tile sizes
  // rows of x and dt are CB wide, of B and C DSP: copies no wider
  const int vxr = min(vx, CB * static_cast<int>(sizeof(T)));
  const int vbcr = min(vbc, DSP * static_cast<int>(sizeof(T)));

  float a2[NS], h[NS];
#pragma unroll
  for (int m = 0; m < NS; ++m) {
    a2[m] = live && n0 + m < ds ? A[static_cast<long long>(d) * ds + n0 + m] * LOG2E : 0.f;
    h[m] = 0.f;
  }

  // three buffers: runs 0 and 1 are in flight before the loop, and run + 2
  // is issued once every thread is past run - 1, whose buffer it takes
  const long long row0 = static_cast<long long>(b) * S;  // token 0 of row b
  const int runs = (S + tc - 1) / tc;
  for (int p = 0; p < 2; ++p) {
    if (p < runs)
      stage_run<T, CB, DSP>(smem + p * per_run, x, dt, Bv, Cv, row0, p, S, tc, di, ds, d0, vxr,
                            vbcr);
    else
      rt::cp_async_commit();
  }
  for (int run = 0; run < runs; ++run) {
    rt::cp_async_wait<1>();  // run `run` has landed (run + 1 may be in flight)
    __syncthreads();         // for every thread; and run - 1 is consumed
    if (run + 2 < runs)
      stage_run<T, CB, DSP>(smem + (run + 2) % 3 * per_run, x, dt, Bv, Cv, row0, run + 2, S, tc,
                            di, ds, d0, vxr, vbcr);
    else
      rt::cp_async_commit();
    const T* X = smem + run % 3 * per_run + c;
    const T* DT = X + xt;
    const T* BB = smem + run % 3 * per_run + 2 * xt + n0;
    const T* CC = BB + bt;
    const int t0 = run * tc, n = min(tc, S - t0);
    float* yr = y + (row0 + t0) * di + d;
    // the partials of TB tokens are summed over the lanes in one
    // scattering tree, after which lane q < TB holds token `first`'s sum;
    // software-pipelined: a batch's tree is summed after the next batch's
    // partials are formed
    int t = 0;
    if (n >= TB) {
      float acc[TB];
      mamba_tokens<T, NS, LANES, TB>(X, DT, BB, CC, a2, h, acc);
      for (t = TB; t + TB <= n; t += TB) {
        float next[TB];
        mamba_tokens<T, NS, LANES, TB>(X + t * CB, DT + t * CB, BB + t * DSP, CC + t * DSP, a2,
                                       h, next);
        int first = 0;
        rt::scatter_sum<LANES>(acc, q, first);
        if (q < TB && live) yr[static_cast<long long>(t - TB + first) * di] = acc[0];
#pragma unroll
        for (int e = 0; e < TB; ++e) acc[e] = next[e];
      }
      int first = 0;
      rt::scatter_sum<LANES>(acc, q, first);
      if (q < TB && live) yr[static_cast<long long>(t - TB + first) * di] = acc[0];
    }
    for (; t < n; ++t) {
      float acc[1];
      mamba_tokens<T, NS, LANES, 1>(X + t * CB, DT + t * CB, BB + t * DSP, CC + t * DSP, a2, h,
                                    acc);
      int first = 0;
      rt::scatter_sum<LANES>(acc, q, first);
      if (q == 0 && live) yr[static_cast<long long>(t) * di] = acc[0];
    }
  }

  if (!live) return;
  float* hl = h_last + (static_cast<long long>(b) * di + d) * ds + n0;
#pragma unroll
  for (int m = 0; m < NS; ++m)
    if (n0 + m < ds) hl[m] = h[m];
}

// The instantiated lane tiles (states a lane, lanes a channel), by tile
// code: kernels/mamba_ssm.py's TILES in order.
constexpr int TILE_STATES[] = {4, 8, 16, 8, 16, 16};
constexpr int TILE_LANES[] = {4, 4, 4, 16, 16, 32};
constexpr int N_TILES = 6;

template <typename T>
void* pick(int tile) {
  switch (tile) {
    case 0: return reinterpret_cast<void*>(mamba_scan_kernel<T, 4, 4>);
    case 1: return reinterpret_cast<void*>(mamba_scan_kernel<T, 8, 4>);
    case 2: return reinterpret_cast<void*>(mamba_scan_kernel<T, 16, 4>);
    case 3: return reinterpret_cast<void*>(mamba_scan_kernel<T, 8, 16>);
    case 4: return reinterpret_cast<void*>(mamba_scan_kernel<T, 16, 16>);
    case 5: return reinterpret_cast<void*>(mamba_scan_kernel<T, 16, 32>);
    default: return nullptr;
  }
}

void* kernel_for(int dtype, int tile) {
  if (tile < 0 || tile >= N_TILES) return nullptr;
  if (dtype == RT_F32) return pick<float>(tile);
  if (dtype == RT_BF16) return pick<__nv_bfloat16>(tile);
  return nullptr;
}

int elem_size(int dtype) { return dtype == RT_F32 ? 4 : 2; }

// The dynamic shared memory of a launch, or -1 for a geometry the kernel
// does not take.
long long smem_for(int dtype, int tile, int tc) {
  if (kernel_for(dtype, tile) == nullptr || tc < 1) return -1;
  const long long bytes =
      3LL * run_elems(tc, THREADS / TILE_LANES[tile], TILE_LANES[tile] * TILE_STATES[tile]) *
      elem_size(dtype);
  return bytes <= MAX_SMEM ? bytes : -1;
}

bool aligned(int vbytes, uintptr_t bits) {
  return vbytes == 0 || ((vbytes == 4 || vbytes == 8 || vbytes == 16) && bits % vbytes == 0);
}

}  // namespace

// x, dt: (B, S, di) and Bv, Cv: (B, S, ds), contiguous, all float32 or all
// bfloat16 (dtype RT_F32 / RT_BF16); A: (di, ds) contiguous float32; y:
// (B, S, di) float32 output; h_last: (B, di, ds) float32 output, the state
// after token S - 1 (zeros when S is 0). The geometry comes from
// kernels/mamba_ssm.py's mamba_geometry: the lane tile (TILE_STATES[tile]
// states a lane, TILE_LANES[tile] lanes a channel; lanes * states >= ds),
// tc tokens a
// staged run, vx and vbc bytes a staged copy of x and dt rows and of B and
// C rows (16, 8, 4, or 0 for element copies; the pointers and the row's
// bytes aligned to it).
extern "C" int rt_mamba_scan(const void* x, const void* dt, const void* A, const void* Bv,
                             const void* Cv, void* y, void* h_last, int B, int S, int di,
                             int ds, int dtype, int tile, int tc, int vx, int vbc,
                             void* stream) {
  const long long smem = smem_for(dtype, tile, tc);
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int es = elem_size(dtype);
  if (B < 0 || B > 65535 || S < 0 || di < 1 || ds < 1 ||
      TILE_LANES[tile] * TILE_STATES[tile] < ds ||
      !aligned(vx, reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dt) |
                       static_cast<uintptr_t>(di) * es) ||
      !aligned(vbc, reinterpret_cast<uintptr_t>(Bv) | reinterpret_cast<uintptr_t>(Cv) |
                        static_cast<uintptr_t>(ds) * es))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  void* kern = kernel_for(dtype, tile);
  cudaError_t err = rt::allow_smem(kern, static_cast<size_t>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cb = THREADS / TILE_LANES[tile];
  void* args[] = {static_cast<void*>(&x),      static_cast<void*>(&dt),
                  static_cast<void*>(&A),      static_cast<void*>(&Bv),
                  static_cast<void*>(&Cv),     static_cast<void*>(&y),
                  static_cast<void*>(&h_last), static_cast<void*>(&S),
                  static_cast<void*>(&di),     static_cast<void*>(&ds),
                  static_cast<void*>(&tc),     static_cast<void*>(&vx),
                  static_cast<void*>(&vbc)};
  err = cudaLaunchKernel(kern, dim3((di + cb - 1) / cb, B), dim3(THREADS), args,
                         static_cast<size_t>(smem), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory of a (dtype, tile, tc) launch and how many of
// its blocks fit on one SM (for the build log).
extern "C" int rt_mamba_scan_info(int dtype, int tile, int tc, int* smem_bytes,
                                  int* blocks_per_sm) {
  const long long smem = smem_for(dtype, tile, tc);
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  void* kern = kernel_for(dtype, tile);
  const cudaError_t err = rt::allow_smem(kern, static_cast<size_t>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem_bytes = static_cast<int>(smem);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kern, THREADS, static_cast<size_t>(smem)));
}
