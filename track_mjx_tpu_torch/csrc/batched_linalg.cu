// Standalone batched Cholesky, cho_solve and SPD solve for sm_90a.
//
// Replaces the TPU kernels of track_mjx_tpu/ops/batched_linalg.py:
//   cholesky_f32  <- _cholesky_kernel  (:86, launched through _cholesky_tpu :286)
//   cho_solve_f32 <- _cho_solve_kernel (:248, launched through _cho_solve_tpu :313)
//   solve_spd_f32 <- _solve_spd_kernel (:263, launched through _solve_spd_tpu :348)
// The plain PyTorch versions are ops/batched_linalg.py::cholesky_plain,
// cho_solve_plain and solve_spd_plain.
//
// What bounds them on Hopper: bytes. Each needs the lower triangle of one
// (n, n) f32 matrix per env (n (n + 1) / 2 floats) and writes an (n, n)
// factor or an n-vector; at B = 4096 and n = 73 that is 44.3 MB in (and
// 87.3 MB out for cholesky), 0.039 ms (cholesky) and 0.014 ms (cho_solve,
// solve_spd) at 3.35 TB/s, against about 0.008 ms of f32 operations for a
// factorization (n^3 / 3 per env) at 67 TFLOP/s. What held the first
// version (one env per CTA factoring a dense n x n copy column by column)
// far from that was its per-env chain: three CTA barriers per column, a
// trailing update over the whole square with a runtime division per entry,
// three shared-memory operations per multiply-add, the whole matrix loaded,
// and 21.9 KB of shared memory per env.
//
// cholesky_f32 and solve_spd_f32 run the tiled factor of
// tiled_cholesky.cuh (shared with the fused CG solve, cg_solve.cu), n <= 128:
// - one env per CTA of 64 threads; its lower triangle is copied with
//   cp.async, a warp per row, into shared memory as 4x4 tiles (Tiles:
//   12.4 KB at n = 73, so registers, not shared memory, cap an SM at 12-14
//   CTAs); nothing above the diagonal is read;
// - a blocked right-looking factor in panels of 8 columns, factored by warp
//   0 in registers, the trailing lower triangle updated one 4x4 register
//   tile at a time by the other warps, with lookahead; one CTA barrier per
//   panel; `factor`'s arithmetic (cholesky.cuh), entry for entry;
// - cholesky writes the dense factor, upper triangle zero, a warp per row;
//   solve_spd runs the exact lower_substitution on the tiles and writes
//   only x.
// What is left (PERF.md, Findings): each env's chain (the panels' shuffles and
// rsqrt, the substitution's divisions) and the trailing update's shared
// loads, not bytes; solve_spd's time is mostly its substitution. Panels of
// 16 and 128 threads per CTA were measured slower (more registers, fewer
// CTAs per SM).
//
// cho_solve_f32 needs no factor, only the substitution, and that is one
// warp's work: one env per CTA of one warp, n <= 128. The warp copies its
// env's lower triangle with cp.async, a row at a time, consecutive lanes on
// consecutive addresses, into tiles (12.7 KB at n = 73, at most 34.9 KB: no
// opt-in) and runs tiled_cholesky.cuh's warp_exact_solve on them: the exact
// panel substitution of the first design (blocked_substitution on the dense
// factor, two CTA barriers per panel) entry for entry, so x is the first
// design's bit for bit, with no CTA barrier at all. Shared memory caps an SM
// at 16 envs; 2 and 4 envs per CTA measured the same on an NVIDIA H100
// (PERF.md, Findings).
//
// C interface (bound with ctypes): each *_f32 launches on the given stream
// and returns cudaGetLastError() (cudaErrorInvalidValue for n > 128); each
// *_smem_bytes(n) gives the dynamic shared memory one CTA needs;
// tiled_kernel_info and cho_solve_kernel_info give the kernels' registers,
// shared memory and resident CTAs per SM.

#include <cuda_runtime.h>

#include "cholesky.cuh"
#include "tiled_cholesky.cuh"

namespace {

constexpr int kTiledThreads = 64;  // the tiled kernels' threads per CTA (one env)

// ---------------------------------------------------------------------------
// cho_solve: one env per warp on its tiles
// ---------------------------------------------------------------------------

// One warp: copies the lower triangle of the row-major n x n matrix a into
// the tiles, a row at a time, consecutive lanes on consecutive addresses;
// the copies run on until the caller's cp.async.wait_all.
__device__ void load_lower_warp(const float* __restrict__ a, const Tiles& L, int n) {
  const int lane = threadIdx.x & 31;
  int col[kLaneRows];  // lane's columns lane + 32 m
#pragma unroll
  for (int m = 0; m < kLaneRows; ++m) col[m] = L.col_part(lane + 32 * m);
  for (int i = 0; i < n; ++i) {
    const int row = L.row_part(i);
#pragma unroll
    for (int m = 0; m < kLaneRows; ++m)
      if (lane + 32 * m <= i) cp_async4(L.s + row + col[m], a + (long)i * n + lane + 32 * m);
  }
}

__global__ void __launch_bounds__(32)
cho_solve_kernel(const float* __restrict__ l, const float* __restrict__ b,
                 float* __restrict__ x, int n) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x;
  const long env = blockIdx.x;
  const Tiles L(smem, n);
  float* out = smem + tiles_floats(n);
  float* y = out + ((n + 3) & ~3);
  load_lower_warp(l + env * n * n, L, n);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
  warp_exact_solve<false>(L, b + env * n, out, y, n);
  for (int i = lane; i < n; i += 32) x[env * n + i] = out[i];
}

// ---------------------------------------------------------------------------
// the tiled factor: cholesky and solve_spd
// ---------------------------------------------------------------------------

// Copies the lower triangle of the row-major n x n matrix a into the tiles,
// a warp per row, consecutive lanes on consecutive addresses.
template <int NT>
__device__ void load_lower(const float* __restrict__ a, const Tiles& L, int n) {
  const int lane = threadIdx.x & 31;
  int col[kLaneRows];  // lane's columns lane + 32 m
#pragma unroll
  for (int m = 0; m < kLaneRows; ++m) col[m] = L.col_part(lane + 32 * m);
  for (int i = threadIdx.x >> 5; i < n; i += NT / 32) {
    const int row = L.row_part(i);
#pragma unroll
    for (int m = 0; m < kLaneRows; ++m)
      if (lane + 32 * m <= i) cp_async4(L.s + row + col[m], a + (long)i * n + lane + 32 * m);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Writes the factor as a dense row-major n x n matrix, upper triangle zero,
// a warp per row.
template <int NT>
__device__ void store_dense(const Tiles& L, float* __restrict__ l, int n) {
  const int lane = threadIdx.x & 31;
  int col[kLaneRows];
#pragma unroll
  for (int m = 0; m < kLaneRows; ++m) col[m] = L.col_part(lane + 32 * m);
  for (int i = threadIdx.x >> 5; i < n; i += NT / 32) {
    const int row = L.row_part(i);
#pragma unroll
    for (int m = 0; m < kLaneRows; ++m) {
      const int k = lane + 32 * m;
      if (k < n) l[(long)i * n + k] = k <= i ? L.s[row + col[m]] : 0.f;
    }
  }
}

// One env per CTA. kSolve: x = A^-1 b into out [B, n]; else the dense
// factor into out [B, n, n], upper triangle zero.
template <bool kSolve>
__global__ void __launch_bounds__(kTiledThreads)
tiled_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out,
             int n) {
  constexpr int NT = kTiledThreads;
  extern __shared__ __align__(16) float smem[];
  const Tiles L(smem, n);
  const long nn = (long)n * n;
  load_lower<NT>(a + blockIdx.x * nn, L, n);
  __syncthreads();
  tiled_factor<NT>(L, n);
  if constexpr (kSolve) {
    float* x = smem + tiles_floats(n);
    float* y = x + n;
    lower_substitution<NT>(L, b + (long)blockIdx.x * n, x, y, n);
    for (int i = threadIdx.x; i < n; i += NT) out[(long)blockIdx.x * n + i] = x[i];
  } else {
    store_dense<NT>(L, out + blockIdx.x * nn, n);
  }
}

long tiled_smem(bool solve, int n) {
  return (tiles_floats(n) + (solve ? 2L * n : 0L)) * (long)sizeof(float);
}

// solve false is cholesky (b unused), true solve_spd.
template <bool kSolve>
int tiled_launch(const float* a, const float* b, float* out, int batch, int n, void* stream) {
  if (batch <= 0 || n <= 0 || n > kMaxN) return (int)cudaErrorInvalidValue;
  // <= 34.9 KB at n = 128: no opt-in
  tiled_kernel<kSolve><<<batch, kTiledThreads, tiled_smem(kSolve, n), (cudaStream_t)stream>>>(
      a, b, out, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" long cholesky_smem_bytes(int n) { return tiled_smem(false, n); }
extern "C" long cho_solve_smem_bytes(int n) {
  return (tiles_floats(n) + 2L * ((n + 3) & ~3)) * (long)sizeof(float);  // tiles, out, y
}
extern "C" long solve_spd_smem_bytes(int n) { return tiled_smem(true, n); }

// info[0..4] = registers per thread, dynamic shared memory per CTA (bytes),
// resident CTAs per SM, threads per CTA, panel width of the tiled kernel of
// cholesky (solve 0) or solve_spd (solve 1) at n.
extern "C" int tiled_kernel_info(int solve, int n, int* info) {
  if (n <= 0 || n > kMaxN) return (int)cudaErrorInvalidValue;
  const void* kernel = solve ? (const void*)tiled_kernel<true> : (const void*)tiled_kernel<false>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, kTiledThreads,
                                                      (size_t)tiled_smem(solve, n));
  if (err != cudaSuccess) return (int)err;
  info[0] = attr.numRegs;
  info[1] = (int)tiled_smem(solve, n);
  info[2] = ctas;
  info[3] = kTiledThreads;
  info[4] = kTiledPanel;
  return 0;
}

// info[0..3] = registers per thread, dynamic shared memory per CTA (bytes),
// resident CTAs per SM and threads per CTA (one env) of cho_solve at n.
extern "C" int cho_solve_kernel_info(int n, int* info) {
  if (n <= 0 || n > kMaxN) return (int)cudaErrorInvalidValue;
  const long smem = cho_solve_smem_bytes(n);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, cho_solve_kernel);
  if (err != cudaSuccess) return (int)err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, cho_solve_kernel, 32, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = attr.numRegs;
  info[1] = (int)smem;
  info[2] = ctas;
  info[3] = 32;
  return 0;
}

extern "C" int cholesky_f32(const float* a, float* l, int batch, int n, void* stream) {
  return tiled_launch<false>(a, nullptr, l, batch, n, stream);
}

extern "C" int cho_solve_f32(const float* l, const float* b, float* x, int batch, int n,
                             void* stream) {
  if (batch <= 0 || n <= 0 || n > kMaxN) return (int)cudaErrorInvalidValue;
  cho_solve_kernel<<<batch, 32, cho_solve_smem_bytes(n), (cudaStream_t)stream>>>(l, b, x, n);
  return (int)cudaGetLastError();
}

extern "C" int solve_spd_f32(const float* a, const float* b, float* x, int batch, int n,
                             void* stream) {
  return tiled_launch<true>(a, b, x, batch, n, stream);
}
