// Standalone batched Cholesky, cho_solve and SPD solve, one env per CTA, for
// sm_90a.
//
// Replaces the TPU kernels of track_mjx_tpu/ops/batched_linalg.py:
//   cholesky_f32  <- _cholesky_kernel  (launched through _cholesky_tpu)
//   cho_solve_f32 <- _cho_solve_kernel (launched through _cho_solve_tpu)
//   solve_spd_f32 <- _solve_spd_kernel (launched through _solve_spd_tpu)
// The plain PyTorch versions are ops/batched_linalg.py::cholesky_plain,
// cho_solve_plain and solve_spd_plain.
//
// What bounds them on Hopper: bytes. Each needs the lower triangle of one
// (n, n) f32 matrix per env (n (n + 1) / 2 floats) and writes an (n, n)
// factor or an n-vector; at B = 4096 and n = 73 that is 44.3 MB in (and
// 87.3 MB out for cholesky), 0.039 ms (cholesky) and 0.014 ms (cho_solve,
// solve_spd) at 3.35 TB/s, against about 0.008 ms of f32 operations for a
// factorization (n^3 / 3 per env) at 67 TFLOP/s.
//
// What the design does about it: one env per CTA loads its whole matrix
// once (the upper triangle too, which a triangle-only load would save),
// coalesced, into shared memory (n^2 + 2n floats, 21.9 KB at n = 73, so
// ten CTAs fit an SM), factors and substitutes there with cholesky.cuh's
// `factor` and exact `blocked_substitution` (the TPU kernel's panel-8
// substitution; L's lower triangle is read by index, so no L^T is stored),
// and writes each output once. solve_spd never writes its factor to device
// memory. What is left is the per-env dependency chain (n factor steps of
// three barriers each, 2 ceil(n/8) panel steps), which many resident CTAs
// overlap; shortening it (a warp per panel, several envs per CTA) is later
// work.
//
// C interface (bound with ctypes): each *_f32 launches on the given stream
// and returns cudaGetLastError(); each *_smem_bytes(n) gives the dynamic
// shared memory one CTA needs.

#include <cuda_runtime.h>

#include "cholesky.cuh"

namespace {

constexpr int kThreads = 128;
constexpr long kDefaultSmem = 48 * 1024;  // above this a kernel must opt in

// the matrix, then the substitution's two n-vectors (out, y)
__host__ __device__ inline long smem_floats(int n) { return (long)n * n + 2L * n; }

__device__ __forceinline__ void load(const float* __restrict__ g, float* s, long count) {
  for (long t = threadIdx.x; t < count; t += kThreads) s[t] = g[t];
}

__global__ void __launch_bounds__(kThreads)
cholesky_kernel(const float* __restrict__ a, float* __restrict__ l, int n) {
  extern __shared__ float L[];
  const long nn = (long)n * n;
  load(a + blockIdx.x * nn, L, nn);  // factor starts with a barrier
  factor<kThreads>(L, n);
  float* out = l + blockIdx.x * nn;
  // the factor leaves the strict upper triangle as it was: write zeros
  for (long t = threadIdx.x; t < nn; t += kThreads) out[t] = t % n <= t / n ? L[t] : 0.f;
}

__global__ void __launch_bounds__(kThreads)
cho_solve_kernel(const float* __restrict__ l, const float* __restrict__ b,
                 float* __restrict__ x, int n) {
  extern __shared__ float L[];
  const long nn = (long)n * n;
  float* out = L + nn;
  float* y = out + n;
  load(l + blockIdx.x * nn, L, nn);  // the substitution's first barrier orders it
  blocked_substitution<kThreads>(L, b + (long)blockIdx.x * n, out, y, n);
  for (int i = threadIdx.x; i < n; i += kThreads) x[(long)blockIdx.x * n + i] = out[i];
}

__global__ void __launch_bounds__(kThreads)
solve_spd_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ x, int n) {
  extern __shared__ float L[];
  const long nn = (long)n * n;
  float* out = L + nn;
  float* y = out + n;
  load(a + blockIdx.x * nn, L, nn);
  factor<kThreads>(L, n);
  blocked_substitution<kThreads>(L, b + (long)blockIdx.x * n, out, y, n);
  for (int i = threadIdx.x; i < n; i += kThreads) x[(long)blockIdx.x * n + i] = out[i];
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int batch, int n) {
  if (batch <= 0 || n <= 0) return cudaErrorInvalidValue;
  const long smem = smem_floats(n) * (long)sizeof(float);
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" long cholesky_smem_bytes(int n) { return smem_floats(n) * (long)sizeof(float); }
extern "C" long cho_solve_smem_bytes(int n) { return smem_floats(n) * (long)sizeof(float); }
extern "C" long solve_spd_smem_bytes(int n) { return smem_floats(n) * (long)sizeof(float); }

extern "C" int cholesky_f32(const float* a, float* l, int batch, int n, void* stream) {
  cudaError_t err = prepare(cholesky_kernel, batch, n);
  if (err != cudaSuccess) return (int)err;
  cholesky_kernel<<<batch, kThreads, cholesky_smem_bytes(n), (cudaStream_t)stream>>>(a, l, n);
  return (int)cudaGetLastError();
}

extern "C" int cho_solve_f32(const float* l, const float* b, float* x, int batch, int n,
                             void* stream) {
  cudaError_t err = prepare(cho_solve_kernel, batch, n);
  if (err != cudaSuccess) return (int)err;
  cho_solve_kernel<<<batch, kThreads, cho_solve_smem_bytes(n), (cudaStream_t)stream>>>(l, b, x, n);
  return (int)cudaGetLastError();
}

extern "C" int solve_spd_f32(const float* a, const float* b, float* x, int batch, int n,
                             void* stream) {
  cudaError_t err = prepare(solve_spd_kernel, batch, n);
  if (err != cudaSuccess) return (int)err;
  solve_spd_kernel<<<batch, kThreads, solve_spd_smem_bytes(n), (cudaStream_t)stream>>>(a, b, x, n);
  return (int)cudaGetLastError();
}
