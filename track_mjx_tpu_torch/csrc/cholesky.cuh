// The exact panel substitution that solve_spd (batched_linalg.cu) runs on
// its tiles with the CTA's threads, and the warp sum and constants shared
// with every kernel.
//
// lower_substitution ports the device routine blocked_substitution of
// track_mjx_tpu/ops/batched_linalg.py that the TPU kernels run inside
// themselves (no pallas_call of its own); its plain PyTorch version is
// ops/batched_linalg.py's blocked_substitution. The tiled factor, the
// panel-inverse solve and the one-warp exact substitution (the elliptic CG
// solve's and cho_solve's, lower_substitution's arithmetic entry for entry)
// are in tiled_cholesky.cuh.

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

// Solves L L^T x = b into out by exact panel forward and back substitution,
// with the CTA's NT threads (a multiple of 32): within a panel, warp 0
// solves the rows in turn, lane r holding row r and each solved value
// broadcast by a shuffle; then every thread takes the panel out of the
// remaining right-hand side.
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

}  // namespace
