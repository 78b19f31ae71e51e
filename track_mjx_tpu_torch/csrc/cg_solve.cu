// Fused smooth + CG + Euler constraint solve, one env per CTA, for sm_90a.
//
// Replaces the TPU kernel track_mjx_tpu/ops/cg_solver_kernel.py::_cg_kernel
// (launched through _cg_solve_tpu) in its production configuration: qM built
// from the CRB factors, J built from the compact per-contact operands, Euler
// implicit-damping solve fused. The plain PyTorch version of the same
// computation is ops/cg_solver_kernel.py::cg_solve_plain.
//
// What bounds it on Hopper: a serial dependency chain per env. Each env runs
// 2 Cholesky factorizations (n steps each) and about 7 (L L^T)^-1 applies
// (smooth solve, first gradient, one per CG iteration, Euler solve), plus
// `iterations` x (ls_iterations + 1) linesearch reductions; every step is a
// handful of flops behind a block barrier. The bytes are small (about
// 104 KB of shared memory per env for the rodent) and the flops are few, so
// neither bandwidth nor tensor cores matter at n = 73.
//
// What the design does about it: one env per CTA keeps J (e x n), qM and L
// (n x n) and every iterate in shared memory for the whole solve, so device
// memory sees the compact operands once and the outputs once. Rows stay in
// efc order. L^T is never stored: the backward sweep reads L by index. The
// triangular solves go through the inverses of L's 8x8 diagonal panels, so
// an apply is about 2n/8 dependent panel steps instead of 2n row steps.
// Dot products over rows are block reductions (warp shuffles, then one
// shared-memory pass over the 8 warp sums, in a fixed order so every thread
// sees the same value and branches uniformly).
//
// The factorization, the panel inverses, the substitution, the reductions
// and the matrix-vector products are shared with the elliptic kernel
// (cholesky.cuh). C interface (bound with ctypes): cg_solve_f32 launches on
// the given stream and returns cudaGetLastError(); cg_solve_smem_bytes
// gives the dynamic shared memory one CTA needs.

#include <cuda_runtime.h>

#include "cholesky.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__host__ __device__ inline long smem_floats(int n, int e) {
  // J, qM, L, panel inverses, 5 row vectors, 10 dof vectors, reduction scratch
  return (long)e * n + 2L * n * n + (long)n * kPanel + 5L * e + 10L * n + 4L * kWarps;
}

__device__ __forceinline__ float force_of(float jar, float d) {
  return jar < 0.f ? -d * jar : 0.f;
}

__global__ void __launch_bounds__(kThreads)
cg_solve_kernel(const float* __restrict__ g_buf, const float* __restrict__ g_cdof,
                const float* __restrict__ g_fq, const float* __restrict__ g_sw,
                const float* __restrict__ g_ll, const float* __restrict__ g_mu,
                const float* __restrict__ g_aref, const float* __restrict__ g_D,
                const float* __restrict__ g_qfs, const float* __restrict__ g_warm,
                const float* __restrict__ g_hd, const float* __restrict__ g_tolscale,
                const float* __restrict__ anc, const float* __restrict__ arm,
                const float* __restrict__ dm, const float* __restrict__ lim1h,
                float* __restrict__ o_smooth, float* __restrict__ o_qacc,
                float* __restrict__ o_qfrc, float* __restrict__ o_eff,
                float* __restrict__ o_force, int n, int nl, int nc, int iterations,
                int ls_iterations) {
  extern __shared__ float smem[];
  const int e = nl + 4 * nc;
  const long b = blockIdx.x;
  const int tid = threadIdx.x;

  float* J = smem;
  float* M = J + e * n;
  float* L = M + n * n;
  float* dinv = L + n * n;
  float* aref = dinv + n * kPanel;
  float* Dr = aref + e;
  float* jar = Dr + e;
  float* jp = jar + e;
  float* ev = jp + e;
  float* smooth = ev + e;
  float* x = smooth + n;
  float* grad = x + n;
  float* mgrad = grad + n;
  float* p = mgrad + n;
  float* mdx = p + n;
  float* mp = mdx + n;
  float* v0 = mp + n;
  float* v1 = v0 + n;
  float* sy = v1 + n;
  float* red = sy + n;

  const float* buf = g_buf + b * n * 6;
  const float* cdof = g_cdof + b * n * 6;
  const float* fq = g_fq + b * nc * 18;
  const float* sw = g_sw + b * n * 6;
  const float* ll = g_ll + b * nl;
  const float* mu = g_mu + b * nc * 2;
  const float* qfs = g_qfs + b * n;
  const float* hd = g_hd + b * n;
  const float tolscale = g_tolscale[b];

  // 1. qM = anc-masked buf cdof^T mirrored to the upper triangle + diag(arm)
  assemble_qm<kThreads>(buf, cdof, anc, arm, M, n);
  // 2. J in efc row order: limit rows, then per contact +t1, -t1, +t2, -t2
  for (int t = tid; t < nl * n; t += kThreads) J[t] = lim1h[t] * ll[t / n];
  for (int t = tid; t < nc * n; t += kThreads) {
    const int c = t / n, d = t % n;
    const float* f = fq + c * 18;
    const float* s = sw + d * 6;
    float j0 = 0.f, j1 = 0.f, j2 = 0.f;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      j0 += f[k] * s[k];
      j1 += f[6 + k] * s[k];
      j2 += f[12 + k] * s[k];
    }
    const float w = dm[c * n + d];
    j0 *= w;
    j1 *= w;
    j2 *= w;
    const float m0 = mu[2 * c], m1 = mu[2 * c + 1];
    float* row = J + (nl + 4 * c) * n + d;
    row[0] = j0 + m0 * j1;
    row[n] = j0 - m0 * j1;
    row[2 * n] = j0 + m1 * j2;
    row[3 * n] = j0 - m1 * j2;
  }
  for (int r = tid; r < e; r += kThreads) {
    aref[r] = g_aref[b * e + r];
    Dr[r] = g_D[b * e + r];
  }
  __syncthreads();
  for (int t = tid; t < n * n; t += kThreads) L[t] = M[t];

  // 3. factor M, solve qacc_smooth
  factor<kThreads>(L, n);
  invert_diag_blocks<kThreads>(L, dinv, n);
  chosolve<kThreads>(L, dinv, qfs, smooth, sy, n);

  // 4. warm start vs smooth start: the cheaper per env. cost(smooth) has no
  // quadratic term; both candidates' jar and M dx are kept for reuse.
  for (int i = tid; i < n; i += kThreads) {
    v0[i] = g_warm[b * n + i];
    v1[i] = v0[i] - smooth[i];
  }
  __syncthreads();
  matv_m<kThreads>(M, v1, mdx, n);                // M (warm - smooth)
  matv_j<kThreads>(J, n, v0, aref, jar, e, n);    // jar of warm
  matv_j<kThreads>(J, n, smooth, aref, ev, e, n); // jar of smooth
  __syncthreads();
  {
    float s[3] = {0.f, 0.f, 0.f};
    for (int i = tid; i < n; i += kThreads) s[0] += v1[i] * mdx[i];
    for (int r = tid; r < e; r += kThreads) {
      if (jar[r] < 0.f) s[1] += Dr[r] * jar[r] * jar[r];
      if (ev[r] < 0.f) s[2] += Dr[r] * ev[r] * ev[r];
    }
    block_sum<kThreads>(s, red);
    const bool take_warm = 0.5f * s[0] + 0.5f * s[1] < 0.5f * s[2];
    if (take_warm) {
      for (int i = tid; i < n; i += kThreads) x[i] = v0[i];
    } else {
      for (int i = tid; i < n; i += kThreads) {
        x[i] = smooth[i];
        mdx[i] = 0.f;
      }
      for (int r = tid; r < e; r += kThreads) jar[r] = ev[r];
    }
  }
  __syncthreads();
  for (int r = tid; r < e; r += kThreads) ev[r] = force_of(jar[r], Dr[r]);
  __syncthreads();
  matv_jt<kThreads>(J, n, ev, mdx, grad, e, n);  // grad = M dx - J^T force
  __syncthreads();
  chosolve<kThreads>(L, dinv, grad, mgrad, sy, n);
  for (int i = tid; i < n; i += kThreads) p[i] = -mgrad[i];
  float imp = 1.f;
  __syncthreads();

  // 5. PR-CG with Newton linesearch; converged envs take zero-length steps
  for (int it = 0; it < iterations; ++it) {
    matv_m<kThreads>(M, p, mp, n);
    matv_j<kThreads>(J, n, p, nullptr, jp, e, n);
    __syncthreads();
    float pm[2] = {0.f, 0.f};
    for (int i = tid; i < n; i += kThreads) {
      pm[0] += p[i] * mp[i];
      pm[1] += mp[i] * (x[i] - smooth[i]);
    }
    block_sum<kThreads>(pm, red);
    const float pmp = pm[0], dmx = pm[1];
    float alpha = 0.f;
    for (int ls = 0; ls <= ls_iterations; ++ls) {
      float s[2] = {0.f, 0.f};
      for (int r = tid; r < e; r += kThreads) {
        const float jr = jar[r] + alpha * jp[r];
        if (jr < 0.f) {
          s[0] += Dr[r] * jr * jp[r];
          s[1] += Dr[r] * jp[r] * jp[r];
        }
      }
      block_sum<kThreads>(s, red);
      const float d1 = alpha * pmp + dmx + s[0];
      const float d2 = fmaxf(pmp + s[1], kEps);
      alpha = alpha - d1 / d2;
    }
    alpha *= imp;
    for (int i = tid; i < n; i += kThreads) {
      x[i] += alpha * p[i];
      mdx[i] += alpha * mp[i];
    }
    for (int r = tid; r < e; r += kThreads) {
      jar[r] += alpha * jp[r];
      ev[r] = force_of(jar[r], Dr[r]);
    }
    __syncthreads();
    matv_jt<kThreads>(J, n, ev, mdx, v0, e, n);  // new gradient
    __syncthreads();
    chosolve<kThreads>(L, dinv, v0, v1, sy, n);  // new preconditioned gradient
    float s[3] = {0.f, 0.f, 0.f};
    for (int i = tid; i < n; i += kThreads) {
      s[0] += v0[i] * (v1[i] - mgrad[i]);
      s[1] += grad[i] * mgrad[i];
      s[2] += v0[i] * v0[i];
    }
    block_sum<kThreads>(s, red);
    const float beta = fmaxf(0.f, s[0] / fmaxf(s[1], kEps));
    for (int i = tid; i < n; i += kThreads) {
      p[i] = -v1[i] + beta * p[i];
      grad[i] = v0[i];
      mgrad[i] = v1[i];
    }
    imp = sqrtf(s[2]) > tolscale ? imp : 0.f;
    __syncthreads();
  }

  // 6. force and qfrc
  for (int r = tid; r < e; r += kThreads) {
    ev[r] = force_of(jar[r], Dr[r]);
    o_force[b * e + r] = ev[r];
  }
  __syncthreads();
  matv_jt<kThreads>(J, n, ev, nullptr, v0, e, n);
  __syncthreads();

  // 7. Euler: factor M + diag(hd), solve qacc_eff from qfrc_smooth + qfrc
  for (int t = tid; t < n * n; t += kThreads) L[t] = M[t] + (t / n == t % n ? hd[t / n] : 0.f);
  for (int i = tid; i < n; i += kThreads) v1[i] = qfs[i] + v0[i];
  __syncthreads();
  factor<kThreads>(L, n);
  invert_diag_blocks<kThreads>(L, dinv, n);
  chosolve<kThreads>(L, dinv, v1, mp, sy, n);

  for (int i = tid; i < n; i += kThreads) {
    o_smooth[b * n + i] = smooth[i];
    o_qacc[b * n + i] = x[i];
    o_qfrc[b * n + i] = v0[i];
    o_eff[b * n + i] = mp[i];
  }
}

}  // namespace

extern "C" long cg_solve_smem_bytes(int n, int nl, int nc) {
  return smem_floats(n, nl + 4 * nc) * (long)sizeof(float);
}

extern "C" int cg_solve_f32(const float* buf, const float* cdof, const float* fq,
                            const float* sw, const float* ll, const float* mu,
                            const float* aref, const float* D, const float* qfrc_smooth,
                            const float* warm, const float* hd, const float* tolscale,
                            const float* anc, const float* arm, const float* dm,
                            const float* lim1h, float* qacc_smooth, float* qacc,
                            float* qfrc_constraint, float* qacc_eff, float* efc_force,
                            int batch, int n, int nl, int nc, int iterations,
                            int ls_iterations, void* stream) {
  if (batch <= 0 || n <= 0 || nl < 0 || nc < 0 || iterations < 0 || ls_iterations < 0)
    return (int)cudaErrorInvalidValue;
  const long smem = cg_solve_smem_bytes(n, nl, nc);
  cudaError_t err = cudaFuncSetAttribute(
      cg_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cg_solve_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      buf, cdof, fq, sw, ll, mu, aref, D, qfrc_smooth, warm, hd, tolscale, anc, arm, dm,
      lim1h, qacc_smooth, qacc, qfrc_constraint, qacc_eff, efc_force, n, nl, nc,
      iterations, ls_iterations);
  return (int)cudaGetLastError();
}
