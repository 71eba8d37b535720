// RWKV-6 time-mix recurrence: per (batch, head), for every token t
//   y_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j] = w_t[i] * S[i][j] + k_t[i] * v_t[j]
// in fp32 (r, k, v, w and u float32 or bfloat16, widened on load), and the
// final state S after the last token.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6.py (_rwkv_kernel
// :28, pallas_call :75). The TPU kernel runs a grid (B, nh, chunks) whose
// last axis walks the sequence in order, the (hd, hd) state held in VMEM
// scratch across chunks, and drops that state when the last chunk ends; its
// wrapper transposes r/k/v/w to (B, nh, S, hd) and pads S to whole chunks
// (w with 1.0). Here the blocks of one (b, h) walk all S tokens themselves:
// no transposes, no padding, and the state is stored at the true last
// token, which the serving prefill needs for the decode cache.
//
// What bounds it: the function needs 5 hd^2 + 5 hd flops per (token,
// head) -- the read-out sum_i r_i S_ij (one fma per element), the decay
// and add w_i S_ij + k_i v_j (a multiply and an fma per element) and the
// bonus v_j * sum_i r_i u_i k_i (O(hd)) -- against 5 hd floats read and
// written per (token, head) plus hd^2 for the state once: about hd / 4
// flops per byte, so at hd 64 it is bound by bytes on the H100 (20 fp32
// flops per byte; at (4, 1024, 64, 64): 340 MB, 0.101 ms, against
// 5.5 GFLOP, 0.081 ms). Issued, the three instructions per state element
// and token take 0.096 ms there at the full fp32 rate. At the serving
// prefill's S of 32 (one admission of rwkv6-7b: B * nh = 64 heads) the
// tokens are few and serial: what counts is how many warps share the SMs
// and how short a token's instruction stream is.
//
// Design (the geometry from kernels/rwkv6.py: rwkv_geometry, checked here):
// - The state is split over lanes. A lane holds a TI x TJ tile of S: key
//   rows i0 .. i0 + TI - 1 of TJ value columns (TI * TJ <= 64 floats). 16
//   adjacent lanes split a head's key rows (16 * TI >= hd), so a column
//   group's partial read-outs meet inside one warp; a block is 8 column
//   groups, 128 threads. Per token a lane loads its rows' r, k, w once, as
//   16-byte shared loads (8 for bf16), and reuses them over its TJ
//   columns; u stays in registers for the whole sequence. The lane counts
//   and the shared-memory strides are compile-time, so a token's loads
//   take no address arithmetic.
// - The bonus is formed once per token: a lane's partial is
//   sum_{i in rows} r_i S_ij + v_j * sum_{i in rows} r_i (u_i k_i), which
//   sums to the function over the lanes: 5 hd^2 + O(hd) flops, one
//   reduction. The partials of NT tokens (NT * TJ <= 16 values a lane;
//   NT the most whose loads stay near 64 registers) are added at once in a
//   scattering xor-shuffle tree (common.cuh: scatter_sum; no branch), after
//   which each of the first NT * TJ lanes holds one (token, column) sum and
//   stores it. The loop is software-pipelined: a batch's tree is summed
//   after the next batch's partials are formed, so the shuffles' latency
//   overlaps arithmetic.
// - The state update is fmaf(w_i, S_ij, k_i * v_j), the plain version's
//   rounding of k v, so the stored state does not depend on the split.
// - The lane tile trades shared-memory loads against warps: a wide tile
//   (4 x 8) loads 0.63 floats per state element and token, a narrow one
//   (4 x 2) 1.75 but puts 4x the warps on a short sequence. The geometry
//   takes the widest that still gives 3 warps an SM: 4 x 4 at one
//   rwkv6-7b admission (64 heads in 2 blocks each: 128 blocks of 4 warps;
//   the first design ran 64 blocks of 2 warps, one thread a value
//   column), 4 x 8 at (4, 1024, 64, 64), a block a head. A head's columns
//   take hd / (8 TJ) blocks; each re-reads r, k and w, 3 hd floats a
//   token, from L2 (the blocks of a head are adjacent in the grid and run
//   together; the first to touch a row reads it from device memory).
// - A run of tc tokens is staged by the whole block with cp.async (16
//   bytes a copy where hd * the element size and the pointers allow it,
//   else 8 or 4, else element copies) into one of three buffers: runs
//   c + 1 and c + 2 are in flight while run c is consumed, one barrier a
//   run. Key rows and value columns past hd are zero-filled: with
//   r = k = 0 their state stays 0 and adds nothing.
#include <cstdint>

#include "common.cuh"
#include "cp_async.cuh"

namespace {

constexpr int LANES = 16;         // lanes that split a head's key rows
constexpr int GROUPS = 8;         // column groups a block
// threads a block; the kernel's launch bounds name a minimum of one block
// an SM, so ptxas may take up to 255 registers a thread (without it,
// it spilled a few bytes in three instantiations)
constexpr int THREADS = LANES * GROUPS;
// Tokens whose partials one shuffle tree sums: at most 16 values a lane,
// and at most 4 tokens' loads (3 TI + TJ floats each) kept near 64
// registers. A power of two.
__host__ __device__ constexpr int tokens_a_tree(int ti, int tj) {
  int nt = 16 / tj;
  while (nt > 1 && nt * (3 * ti + tj) > 64) nt /= 2;
  return nt > 4 ? 4 : nt;
}
constexpr int MAX_SMEM = 227 * 1024;

__device__ __forceinline__ float load_u(const void* u, int u_bf16, int idx) {
  return u_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(u)[idx])
                : static_cast<const float*>(u)[idx];
}

// Shared elements of one staged run: r, k and w (tc x hdp each) and v
// (tc x jc), padded to a whole 16 bytes.
__host__ __device__ __forceinline__ int run_elems(int tc, int hdp, int jc) {
  return (tc * (3 * hdp + jc) + 7) & ~7;
}

// Stage run `run` of tc tokens into its buffer: r, k and w of every key
// row (zero past hd) and v of the block's columns.
template <typename T, int HDP, int JC>
__device__ __forceinline__ void stage_run(T* buf, const T* r, const T* k, const T* v,
                                          const T* w, long long head, long long row, int run,
                                          int S, int tc, int j0, int hd, int vbytes,
                                          int vv_bytes) {
  const long long o = head + static_cast<long long>(run) * tc * row;
  const int n = min(tc, S - run * tc);
  rt::stage_rows(buf, HDP, r + o, row, n, HDP, hd, vbytes, threadIdx.x, THREADS);
  rt::stage_rows(buf + tc * HDP, HDP, k + o, row, n, HDP, hd, vbytes, threadIdx.x, THREADS);
  rt::stage_rows(buf + 2 * tc * HDP, HDP, w + o, row, n, HDP, hd, vbytes, threadIdx.x,
                 THREADS);
  rt::stage_rows(buf + 3 * tc * HDP, JC, v + o + j0, row, n, JC, hd - j0, vv_bytes,
                 threadIdx.x, THREADS);
  rt::cp_async_commit();
}

// NT consecutive tokens of a staged run (R, K, W at the first token's row
// and the lane's first key row, V at its first column): the lane's partial
// read-outs of its TJ columns into part, its state tile updated.
template <typename T, int TI, int TJ, int NT>
__device__ __forceinline__ void rwkv_tokens(const T* R, const T* K, const T* W, const T* V,
                                            const float (&uu)[TI], float (&s)[TI][TJ],
                                            float (&part)[NT * TJ]) {
  constexpr int HDP = LANES * TI, JC = GROUPS * TJ;
#pragma unroll
  for (int b = 0; b < NT; ++b) {
    float rr[TI], kk[TI], ww[TI], vv[TJ];
    rt::load_n(R + b * HDP, rr);
    rt::load_n(K + b * HDP, kk);
    rt::load_n(W + b * HDP, ww);
    rt::load_n(V + b * JC, vv);
    float ruk = 0.f;  // sum over the lane's rows of r_i (u_i k_i)
#pragma unroll
    for (int m = 0; m < TI; ++m) ruk = fmaf(rr[m], uu[m] * kk[m], ruk);
#pragma unroll
    for (int c = 0; c < TJ; ++c) {
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < TI; ++m) acc = fmaf(rr[m], s[m][c], acc);
      part[b * TJ + c] = fmaf(vv[c], ruk, acc);
    }
#pragma unroll
    for (int m = 0; m < TI; ++m)
#pragma unroll
      for (int c = 0; c < TJ; ++c) s[m][c] = fmaf(ww[m], s[m][c], kk[m] * vv[c]);
  }
}

// The NT * TJ partials of rwkv_tokens summed over the 16 lanes in one
// scattering tree and stored (yt: y at the first token and the lane's
// first column; `left` columns of the lane lie inside hd).
template <int TJ, int NT>
__device__ __forceinline__ void rwkv_store(float (&part)[NT * TJ], int ig, float* yt, int row,
                                           int left) {
  int first = 0;
  rt::scatter_sum<LANES>(part, ig, first);
  // the lane's sum: token first / TJ, column first % TJ (NT * TJ <= 16:
  // one sum a lane, the first NT * TJ lanes store)
  if (ig < NT * TJ && first % TJ < left) yt[first / TJ * row + first % TJ] = part[0];
}

template <typename T, int TI, int TJ>
__global__ void __launch_bounds__(THREADS, 1)
rwkv_scan_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ w, const void* __restrict__ u, int u_bf16,
                 float* __restrict__ y, float* __restrict__ state, int S, int nh, int hd,
                 int slices, int tc, int vbytes) {
  constexpr int HDP = LANES * TI;          // key rows, padded
  constexpr int JC = GROUPS * TJ;          // value columns of the block
  constexpr int NT = tokens_a_tree(TI, TJ);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int ig = threadIdx.x % LANES, jg = threadIdx.x / LANES;  // row group, column group
  const int i0 = ig * TI, jl = jg * TJ;
  const int bh = blockIdx.x / slices, b = bh / nh, h = bh % nh;
  const int j0 = blockIdx.x % slices * JC;  // the block's first column
  const long long row = static_cast<long long>(nh) * hd;  // one token's stride
  const long long head = static_cast<long long>(b) * S * row + static_cast<long long>(h) * hd;
  const int per_run = run_elems(tc, HDP, JC);
  // v rows are JC wide: copies no wider than a row
  const int vv_bytes = min(vbytes, JC * static_cast<int>(sizeof(T)));
  const int left = hd - j0 - jl;           // the lane's columns inside hd

  float uu[TI], s[TI][TJ];
#pragma unroll
  for (int m = 0; m < TI; ++m) {
    uu[m] = i0 + m < hd ? load_u(u, u_bf16, h * hd + i0 + m) : 0.f;
#pragma unroll
    for (int c = 0; c < TJ; ++c) s[m][c] = 0.f;
  }

  // three buffers: runs 0 and 1 are in flight before the loop, and run + 2
  // is issued once every thread is past run - 1, whose buffer it takes
  const int runs = (S + tc - 1) / tc;
  for (int p = 0; p < 2; ++p) {
    if (p < runs)
      stage_run<T, HDP, JC>(smem + p * per_run, r, k, v, w, head, row, p, S, tc, j0, hd,
                            vbytes, vv_bytes);
    else
      rt::cp_async_commit();
  }
  const int row_i = nh * hd;
  for (int run = 0; run < runs; ++run) {
    rt::cp_async_wait<1>();  // run `run` has landed (run + 1 may be in flight)
    __syncthreads();         // for every thread; and run - 1 is consumed
    if (run + 2 < runs)
      stage_run<T, HDP, JC>(smem + (run + 2) % 3 * per_run, r, k, v, w, head, row, run + 2, S,
                            tc, j0, hd, vbytes, vv_bytes);
    else
      rt::cp_async_commit();
    const T* R = smem + run % 3 * per_run + i0;
    const T* K = R + tc * HDP;
    const T* W = K + tc * HDP;
    const T* V = smem + run % 3 * per_run + 3 * tc * HDP + jl;
    const int t0 = run * tc, n = min(tc, S - t0);
    float* yr = y + head + static_cast<long long>(t0) * row + j0 + jl;
    // software-pipelined: the tree of one batch of tokens is summed after
    // the next batch's partials are formed, so its shuffles' latency
    // overlaps that batch's arithmetic
    int t = 0;
    if (n >= NT) {
      float part[NT * TJ];
      rwkv_tokens<T, TI, TJ, NT>(R, K, W, V, uu, s, part);
      for (t = NT; t + NT <= n; t += NT) {
        float next[NT * TJ];
        rwkv_tokens<T, TI, TJ, NT>(R + t * HDP, K + t * HDP, W + t * HDP, V + t * JC, uu, s,
                                   next);
        rwkv_store<TJ, NT>(part, ig, yr + static_cast<long long>(t - NT) * row, row_i, left);
#pragma unroll
        for (int e = 0; e < NT * TJ; ++e) part[e] = next[e];
      }
      rwkv_store<TJ, NT>(part, ig, yr + static_cast<long long>(t - NT) * row, row_i, left);
    }
    for (; t < n; ++t) {
      float part[TJ];
      rwkv_tokens<T, TI, TJ, 1>(R + t * HDP, K + t * HDP, W + t * HDP, V + t * JC, uu, s, part);
      rwkv_store<TJ, 1>(part, ig, yr + static_cast<long long>(t) * row, row_i, left);
    }
  }

  // the final state, [b, h, i, j]
  float* st = state + static_cast<long long>(bh) * hd * hd;
  const int j = j0 + jl;
#pragma unroll
  for (int m = 0; m < TI; ++m) {
    const int i = i0 + m;
    if (i >= hd || j >= hd) continue;
    float* p = st + static_cast<long long>(i) * hd + j;
#pragma unroll
    for (int c = 0; c < TJ; ++c)
      if (j + c < hd) p[c] = s[m][c];
  }
}

// The instantiated tiles (key rows x value columns a lane), by tile code:
// kernels/rwkv6.py's TILES in order.
constexpr int TILE_ROWS[] = {4, 4, 4, 8, 8, 8, 16, 16, 32};
constexpr int TILE_COLS[] = {2, 4, 8, 2, 4, 8, 2, 4, 2};
constexpr int N_TILES = 9;

template <typename T>
void* pick(int tile) {
  switch (tile) {
    case 0: return reinterpret_cast<void*>(rwkv_scan_kernel<T, 4, 2>);
    case 1: return reinterpret_cast<void*>(rwkv_scan_kernel<T, 4, 4>);
    case 2: return reinterpret_cast<void*>(rwkv_scan_kernel<T, 4, 8>);
    case 3: return reinterpret_cast<void*>(rwkv_scan_kernel<T, 8, 2>);
    case 4: return reinterpret_cast<void*>(rwkv_scan_kernel<T, 8, 4>);
    case 5: return reinterpret_cast<void*>(rwkv_scan_kernel<T, 8, 8>);
    case 6: return reinterpret_cast<void*>(rwkv_scan_kernel<T, 16, 2>);
    case 7: return reinterpret_cast<void*>(rwkv_scan_kernel<T, 16, 4>);
    case 8: return reinterpret_cast<void*>(rwkv_scan_kernel<T, 32, 2>);
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
      3LL * run_elems(tc, LANES * TILE_ROWS[tile], GROUPS * TILE_COLS[tile]) * elem_size(dtype);
  return bytes <= MAX_SMEM ? bytes : -1;
}

}  // namespace

// r, k, v, w: (B, S, nh, hd) contiguous, all float32 or all bfloat16
// (dtype RT_F32 / RT_BF16); u: (nh, hd) contiguous, float32 or bfloat16
// (u_dtype); y: (B, S, nh, hd) float32 output; state: (B, nh, hd, hd)
// float32 output [b, h, k, v]. The geometry comes from kernels/rwkv6.py's
// rwkv_geometry: the lane's tile (TILE_ROWS[tile] key rows x
// TILE_COLS[tile] value columns; 16 * rows >= hd), slices blocks a head
// (each 8 * cols columns; they cover hd, and each holds some), tc tokens a
// staged run, vbytes bytes a staged copy (16, 8, 4, or 0 for element
// copies; the pointers and hd * the element size aligned to it).
extern "C" int rt_rwkv_scan(const void* r, const void* k, const void* v, const void* w,
                            const void* u, void* y, void* state, int B, int S, int nh, int hd,
                            int dtype, int u_dtype, int tile, int slices, int tc, int vbytes,
                            void* stream) {
  const long long smem = smem_for(dtype, tile, tc);
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int jc = GROUPS * TILE_COLS[tile];
  if (B < 0 || S < 0 || nh < 1 || hd < 1 || LANES * TILE_ROWS[tile] < hd || slices < 1 ||
      static_cast<long long>(slices) * jc < hd || (slices - 1) * jc >= hd ||
      (u_dtype != RT_F32 && u_dtype != RT_BF16) ||
      static_cast<long long>(B) * nh * slices > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vbytes != 0) {
    const uintptr_t bits = reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(k) |
                           reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(w) |
                           static_cast<uintptr_t>(hd) * elem_size(dtype);
    if ((vbytes != 4 && vbytes != 8 && vbytes != 16) || bits % vbytes != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return static_cast<int>(cudaGetLastError());
  void* kern = kernel_for(dtype, tile);
  cudaError_t err = rt::allow_smem(kern, static_cast<size_t>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int u_bf16 = u_dtype == RT_BF16;
  void* args[] = {static_cast<void*>(&r),      static_cast<void*>(&k),
                  static_cast<void*>(&v),      static_cast<void*>(&w),
                  static_cast<void*>(&u),      static_cast<void*>(&u_bf16),
                  static_cast<void*>(&y),      static_cast<void*>(&state),
                  static_cast<void*>(&S),      static_cast<void*>(&nh),
                  static_cast<void*>(&hd),     static_cast<void*>(&slices),
                  static_cast<void*>(&tc),     static_cast<void*>(&vbytes)};
  err = cudaLaunchKernel(kern, dim3(static_cast<unsigned>(B * nh * slices)), dim3(THREADS),
                         args, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory of a (dtype, tile, tc) launch and how many of
// its blocks fit on one SM (for the build log).
extern "C" int rt_rwkv_scan_info(int dtype, int tile, int tc, int* smem_bytes,
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
