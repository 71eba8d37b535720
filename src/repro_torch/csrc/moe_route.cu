// MoE router: logits = x @ router in fp32, softmax, then k rounds of
// max / argmax / mask — the token's top-k experts and their probabilities.
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_route.py
// (_route_kernel :19, pallas_call :47). The Pallas kernel keeps the whole
// (D, E) router resident in VMEM across its grid over token tiles; at D 2048,
// E 64 that is 512 KB in fp32 (256 KB in bf16), more than the 227 KB of
// shared memory a Hopper block can hold. Here the router is read through L2
// (every block reads the same rows, so after the first block they are L2
// hits) and only x is staged in shared memory, as fp32.
//
// Two kernels, one call:
//  1. route_logits_kernel: one block per (tile of TN tokens, slice of D).
//     The block stages its x slice in shared memory chunk by chunk; each
//     thread owns one expert column e and one residue class of d inside the
//     chunk, and keeps TN fp32 sums in registers (router loads are coalesced
//     along E, x reads are shared-memory broadcasts). The block adds its
//     threads' sums in a fixed order and writes the slice's partial logits
//     (N, E) to a scratch buffer the wrapper allocated. At decode N is 4, one
//     token tile: splitting D over up to 16 blocks is what puts enough loads
//     in flight to stream the router; at large N the token tiles alone fill
//     the card and D is not split.
//  2. route_topk_kernel: one warp per token. It adds the slices' partials in
//     slice order, takes the softmax exp(l - max) / sum, and runs k rounds
//     of a warp argmax whose ties go to the lowest expert index (as
//     jnp.argmax), masking each winner to -1e30. The (N, E) probabilities
//     live only in shared memory, as in the Pallas kernel.
// Every (token, expert) sum is formed in the same order whatever the expert,
// so two equal router columns give bit-equal logits and the tie goes to the
// lower index.
//
// What bounds it: 2·N·D·E FLOPs against N·D + D·E elements read, so at the
// serving shapes it is bound by bytes (the router at decode, x at large N).
// This first version does the products on the CUDA cores in fp32.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TN = 16;       // tokens per block (registers per thread)
constexpr int DC = 128;      // rows of D staged per chunk
constexpr int XLD = TN + 4;  // row stride of the staged x chunk: 16-byte rows
constexpr int MAX_E = 256;
constexpr int MAX_D = 8192;
constexpr float LOWEST = -3.402823466e38f;  // below every logit and NEG_INF

template <typename T>
__global__ void __launch_bounds__(THREADS)
route_logits_kernel(const T* __restrict__ x, const T* __restrict__ w, float* __restrict__ partial,
                    int N, int D, int E, int chunks_per_split) {
  __shared__ __align__(16) float xs[DC * XLD];  // x chunk, [d][token], fp32
  __shared__ float part[THREADS * TN];          // [s][token][e] per-thread sums

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * TN, split = blockIdx.y;
  const int nt = min(TN, N - n0);
  const int nsplit = max(1, THREADS / E);  // residue classes of d per chunk
  const int e = tid % E, s = tid / E;
  const bool active = s < nsplit;
  const int d_begin = split * chunks_per_split * DC;
  const int d_end = min(D, d_begin + chunks_per_split * DC);

  float acc[TN];
#pragma unroll
  for (int t = 0; t < TN; ++t) acc[t] = 0.f;

  for (int d0 = d_begin; d0 < d_end; d0 += DC) {
    const int dc = min(DC, d_end - d0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < DC * TN; i += THREADS) {
      const int t = i / DC, d = i % DC;  // consecutive threads: consecutive d
      xs[d * XLD + t] =
          (t < nt && d < dc) ? rt::to_f(x[static_cast<long long>(n0 + t) * D + d0 + d]) : 0.f;
    }
    __syncthreads();
    if (active) {
      const T* wr = w + static_cast<long long>(d0) * E + e;
#pragma unroll 8
      for (int d = s; d < dc; d += nsplit) {
        const float wv = rt::to_f(wr[static_cast<long long>(d) * E]);
        const float4* xr = reinterpret_cast<const float4*>(xs + d * XLD);
#pragma unroll
        for (int q = 0; q < TN / 4; ++q) {
          const float4 xv = xr[q];
          acc[4 * q + 0] = fmaf(xv.x, wv, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(xv.y, wv, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(xv.z, wv, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(xv.w, wv, acc[4 * q + 3]);
        }
      }
    }
  }

  if (active) {
#pragma unroll
    for (int t = 0; t < TN; ++t) part[(s * TN + t) * E + e] = acc[t];
  }
  __syncthreads();
  float* out = partial + static_cast<long long>(split) * N * E;
  for (int p = tid; p < nt * E; p += THREADS) {
    const int t = p / E, ee = p % E;
    float sum = 0.f;
    for (int ss = 0; ss < nsplit; ++ss) sum += part[(ss * TN + t) * E + ee];
    out[static_cast<long long>(n0 + t) * E + ee] = sum;
  }
}

constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
route_topk_kernel(const float* __restrict__ partial, float* __restrict__ gates,
                  int* __restrict__ idx, int N, int E, int k, int splits) {
  __shared__ float probs[WARPS * MAX_E];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = blockIdx.x * WARPS + warp;
  if (n >= N) return;  // whole warps leave: no block barrier below
  float* row = probs + warp * MAX_E;

  float m = LOWEST;
  for (int e = lane; e < E; e += 32) {
    float l = 0.f;  // in slice order; unrolled so the loads are in flight together
#pragma unroll 8
    for (int sp = 0; sp < splits; ++sp) l += partial[(static_cast<long long>(sp) * N + n) * E + e];
    row[e] = l;
    m = fmaxf(m, l);
  }
  m = rt::warp_max(m);
  float sum = 0.f;
  for (int e = lane; e < E; e += 32) {
    const float p = expf(row[e] - m);
    row[e] = p;
    sum += p;
  }
  sum = rt::warp_sum(sum);
  for (int e = lane; e < E; e += 32) row[e] = row[e] / sum;
  __syncwarp();

  for (int j = 0; j < k; ++j) {
    float bv = LOWEST;
    int bi = E;
    for (int e = lane; e < E; e += 32) {  // ascending: strict > keeps the lowest
      const float v = row[e];
      if (v > bv) {
        bv = v;
        bi = e;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      gates[static_cast<long long>(n) * k + j] = bv;
      idx[static_cast<long long>(n) * k + j] = bi;
    }
    if (bi % 32 == lane) row[bi] = rt::NEG_INF;
    __syncwarp();
  }
}

template <typename T>
int launch(const void* x, const void* w, void* gates, void* idx, void* partial, int N, int D,
           int E, int k, int splits, cudaStream_t stream) {
  const int chunks = (D + DC - 1) / DC;
  const int per_split = (chunks + splits - 1) / splits;
  if ((chunks + per_split - 1) / per_split != splits)
    return static_cast<int>(cudaErrorInvalidValue);  // the wrapper's split count
  dim3 grid((N + TN - 1) / TN, splits);
  route_logits_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<float*>(partial), N, D, E,
      per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  route_topk_kernel<<<(N + WARPS - 1) / WARPS, THREADS, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(gates), static_cast<int*>(idx), N,
      E, k, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (N, D) and router (D, E) contiguous, both float32 or both bfloat16;
// gates (N, k) float32 and idx (N, k) int32 contiguous outputs; partial a
// float32 scratch of splits * N * E, where splits is the number of D slices
// of DC-row chunks (moe_route.py's wrapper computes it).
extern "C" int rt_moe_route(const void* x, const void* w, void* gates, void* idx, void* partial,
                            int N, int D, int E, int k, int splits, int dtype, void* stream) {
  if (N < 0 || D < 1 || D > MAX_D || E < 1 || E > MAX_E || k < 1 || k > E || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == RT_F32) return launch<float>(x, w, gates, idx, partial, N, D, E, k, splits, s);
  if (dtype == RT_BF16)
    return launch<__nv_bfloat16>(x, w, gates, idx, partial, N, D, E, k, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
