// Dense device routines of the elliptic CG solve (ell_cg_solve.cu) and the
// standalone cho_solve (batched_linalg.cu), for one env per CTA with every
// operand in shared memory as a row-major n x n matrix; the warp sum and
// constants are shared with every kernel.
//
// They port the device routines of track_mjx_tpu/ops/batched_linalg.py that
// the TPU kernels run inside themselves (no pallas_call of their own):
// factor_in_place (`factor`) and blocked_substitution. The plain PyTorch
// versions are in ops/batched_linalg.py. Beside them: the block reductions,
// the qM build and the J, J^T and M matrix-vector products of the elliptic
// solve. The tiled factor and the panel-inverse solve on its layout
// (invert_diag_blocks, blocked_substitution_pinv), which the scalar CG
// solve and the standalone cholesky and solve_spd run, are in
// tiled_cholesky.cuh; `factor` stays the reference for its arithmetic.
//
// Every routine is a template on the CTA's thread count NT (a multiple of
// 32), ends with a barrier, and leaves its result visible to every thread.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kPanel = 8;
constexpr float kEps = 1e-12f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sums of K per-thread partials; every thread gets the totals,
// summed in the same order, so branches on them are uniform across the CTA.
// `red` holds K * NT / 32 floats.
template <int NT, int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* red) {
  constexpr int kWarps = NT / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  __syncthreads();  // red may still be read by the previous reduction
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[k * kWarps + warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[k * kWarps + w];
    v[k] = s;
  }
}

// In-place right-looking Cholesky of the n x n matrix in L (row-major).
// On exit the lower triangle holds the factor; the strict upper triangle is
// left as it was and never read.
template <int NT>
__device__ void factor(float* L, int n) {
  for (int j = 0; j < n; ++j) {
    __syncthreads();
    const float rs = rsqrtf(L[j * n + j]);
    __syncthreads();  // every thread has read the pivot before it is scaled
    for (int i = j + threadIdx.x; i < n; i += NT) L[i * n + j] *= rs;
    __syncthreads();
    const int m = n - j - 1;
    for (int t = threadIdx.x; t < m * m; t += NT) {
      const int i = j + 1 + t / m, k = j + 1 + t % m;
      if (k <= i) L[i * n + k] -= L[i * n + j] * L[k * n + j];
    }
  }
  __syncthreads();
}

// An n x n row-major matrix as lower_substitution reads it: L(i, j).
struct RowMajor {
  const float* p;
  int n;
  __device__ __forceinline__ float operator()(int i, int j) const { return p[i * n + j]; }
};

// Solves L L^T x = b into out by exact panel forward and back substitution
// (the elliptic kernel's apply): within a panel, warp 0 solves the rows in
// turn, lane r holding row r and each solved value broadcast by a shuffle;
// then every thread takes the panel out of the remaining right-hand side.
// y is scratch; b may be global or shared but must not alias out or y.
// Reads only the lower triangle of L, through L(i, j) (any layout).
template <int NT, typename Mat>
__device__ void lower_substitution(const Mat& L, const float* b, float* out, float* y, int n) {
  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < n; i += NT) out[i] = b[i];
  __syncthreads();
  for (int p0 = 0; p0 < n; p0 += kPanel) {  // forward: L y = b
    const int m = min(kPanel, n - p0);
    if (tid < 32) {
      const int r = lane < m ? lane : 0;  // lanes >= m shadow row 0, write nothing
      const float rp = out[p0 + r], diag = L(p0 + r, p0 + r);
      float s = 0.f, v_own = 0.f;
      for (int jj = 0; jj < m; ++jj) {
        const float v = __shfl_sync(0xffffffffu, (rp - s) / diag, jj);
        if (lane == jj) v_own = v;
        if (lane > jj && lane < m) s += L(p0 + lane, p0 + jj) * v;
      }
      if (lane < m) y[p0 + lane] = v_own;
    }
    __syncthreads();
    for (int i = p0 + m + tid; i < n; i += NT) {
      float s = 0.f;
      for (int c = 0; c < m; ++c) s += L(i, p0 + c) * y[p0 + c];
      out[i] -= s;
    }
    __syncthreads();
  }
  for (int p0 = ((n - 1) / kPanel) * kPanel; p0 >= 0; p0 -= kPanel) {  // L^T x = y
    const int m = min(kPanel, n - p0);
    if (tid < 32) {
      const int r = lane < m ? lane : 0;
      const float rp = y[p0 + r], diag = L(p0 + r, p0 + r);
      float s = 0.f, v_own = 0.f;
      for (int jj = m - 1; jj >= 0; --jj) {
        const float v = __shfl_sync(0xffffffffu, (rp - s) / diag, jj);
        if (lane == jj) v_own = v;
        if (lane < jj) s += L(p0 + jj, p0 + lane) * v;
      }
      if (lane < m) out[p0 + lane] = v_own;
    }
    __syncthreads();
    for (int i = tid; i < p0; i += NT) {
      float s = 0.f;
      for (int r = 0; r < m; ++r) s += L(p0 + r, i) * out[p0 + r];
      y[i] -= s;
    }
    __syncthreads();
  }
}

// lower_substitution on an n x n row-major L.
template <int NT>
__device__ void blocked_substitution(const float* L, const float* b, float* out,
                                     float* y, int n) {
  lower_substitution<NT>(RowMajor{L, n}, b, out, y, n);
}

// y[r] = (J x)[r] - sub[r] (sub may be null); J has row stride ldj. Thread
// per row; an odd ldj puts neighbouring rows in distinct banks.
template <int NT>
__device__ void matv_j(const float* J, int ldj, const float* x, const float* sub,
                       float* y, int e, int n) {
  for (int r = threadIdx.x; r < e; r += NT) {
    float s = 0.f;
    for (int d = 0; d < n; ++d) s += J[r * ldj + d] * x[d];
    y[r] = sub ? s - sub[r] : s;
  }
}

// y[d] = base[d] - (J^T f)[d] (base may be null: y = J^T f).
template <int NT>
__device__ void matv_jt(const float* J, int ldj, const float* f, const float* base,
                        float* y, int e, int n) {
  for (int d = threadIdx.x; d < n; d += NT) {
    float s = 0.f;
    for (int r = 0; r < e; ++r) s += J[r * ldj + d] * f[r];
    y[d] = base ? base[d] - s : s;
  }
}

// y = M v.
template <int NT>
__device__ void matv_m(const float* M, const float* v, float* y, int n) {
  for (int i = threadIdx.x; i < n; i += NT) {
    float s = 0.f;
    for (int j = 0; j < n; ++j) s += M[i * n + j] * v[j];
    y[i] = s;
  }
}

// qM = ancestry-masked buf cdof^T mirrored to the upper triangle, plus
// diag(arm), into M (n x n). No barrier: the caller syncs before reading.
template <int NT>
__device__ void assemble_qm(const float* buf, const float* cdof, const float* anc,
                            const float* arm, float* M, int n) {
  for (int t = threadIdx.x; t < n * n; t += NT) {
    const int i = t / n, j = t % n;
    float v = 0.f;
    const int lo = anc[i * n + j] != 0.f ? i : (anc[j * n + i] != 0.f ? j : -1);
    if (lo >= 0) {
      const int hi = lo == i ? j : i;
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k) s += buf[lo * 6 + k] * cdof[hi * 6 + k];
      v = s;
    }
    if (i == j) v += arm[i];
    M[t] = v;
  }
}

}  // namespace
