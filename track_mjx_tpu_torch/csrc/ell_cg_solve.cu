// Fused smooth + elliptic-cone CG + Euler constraint solve, one env per CTA,
// for sm_90a.
//
// Replaces the TPU kernel
// track_mjx_tpu/ops/cg_solver_kernel.py::_ell_cg_kernel (launched through
// _ell_cg_solve_tpu) in its production configuration: qM built from the CRB
// factors, J built from the compact per-contact operands, Euler
// implicit-damping solve fused. Rows are the limit rows, then one (normal,
// t1, t2) cone block per contact, in efc order; the TPU kernel's row
// permutation into sections and its padding were for the TPU's tiles and
// are gone. The plain PyTorch version of the same computation is
// ops/cg_solver_kernel.py::ell_cg_solve_plain.
//
// Per env: build qM and J, factor qM, solve qacc_smooth; take the cheaper of
// the warm and smooth starts; run `iterations` M-preconditioned
// Polak-Ribiere CG steps, each with a safeguarded, bracketed Newton
// linesearch of `ls_iterations` steps over the three-zone cone projection
// (force, cost and curvature per zone) that refuses a step which does not
// lower the cost; extract force and qfrc; factor M + diag(hd) and solve
// qacc_eff. The numerics follow the TPU kernel on purpose: the exact panel
// substitution (no panel inverses), jar = J x - aref and M (x - smooth)
// recomputed from x every iteration (no incremental updates), and M read
// directly, because the linesearch's bracket decisions (d1 < 0) flip under
// reassociation.
//
// What bounds it on Hopper: a serial dependency chain per env, not bytes or
// flops. Each env runs 2 Cholesky factorizations (n barrier-separated steps
// each), iterations + 3 exact substitutions (2 n / 8 panels, each a warp's
// 8-step shuffle chain and a trailing update between two barriers), and per
// iteration 4 + ls_iterations block reductions. For the fly (n = 42, 117
// rows) J, qM, L and the iterates take about 40 KB of shared memory; the
// flops (about 0.4 MFLOP per env) and the bytes (the compact operands in,
// the outputs out) would take the card microseconds.
//
// What the design does about it: one env per CTA keeps every operand in
// shared memory for the whole solve, so device memory is read and written
// once. 128 threads, one per constraint row or cone block, so a row pass is
// one step; five CTAs share an SM, so while one CTA waits at a barrier the
// others issue. Shortening the chain itself (fewer barriers per panel, a
// blocked factorization) is later work.
//
// C interface (bound with ctypes): ell_cg_solve_f32 launches on the given
// stream and returns cudaGetLastError(); ell_cg_solve_smem_bytes gives the
// dynamic shared memory one CTA needs.

#include <cfloat>
#include <cuda_runtime.h>

#include "cholesky.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__host__ __device__ inline int j_stride(int n) { return n | 1; }

__host__ __device__ inline long smem_floats(int n, int nl, int nc) {
  const long e = nl + 3L * nc;
  // J, qM, L, 6 row vectors, 10 dof vectors, 2 cone vectors, reduction scratch
  return e * j_stride(n) + 2L * n * n + 6L * e + 10L * n + 2L * nc + 4L * kWarps;
}

// Zone geometry of one cone block from its rows' jar values u:
// p = -sqrt(D) u, tangential norm t, bottom (inside the cone: static
// friction), top (separating) and s* for the middle (sliding) zone.
struct Zone {
  float pn, pt1, pt2, t, s;
  bool bottom, top;
};

__device__ __forceinline__ Zone zones(float un, float ut1, float ut2, const float* sq,
                                      float mu, float mu2p1) {
  Zone z;
  z.pn = -sq[0] * un;
  z.pt1 = -sq[1] * ut1;
  z.pt2 = -sq[2] * ut2;
  z.t = sqrtf(fmaxf(z.pt1 * z.pt1 + z.pt2 * z.pt2, kEps * kEps));
  z.bottom = mu * z.pn >= z.t;
  z.top = z.pn <= -mu * z.t;
  z.s = (z.pn + mu * z.t) / mu2p1;
  return z;
}

// Cone projection force of one block.
__device__ __forceinline__ void cone_force(const Zone& z, float un, float ut1, float ut2,
                                           const float* d, const float* sq, float mu,
                                           float* f) {
  if (z.bottom) {
    f[0] = -d[0] * un;
    f[1] = -d[1] * ut1;
    f[2] = -d[2] * ut2;
  } else if (z.top) {
    f[0] = f[1] = f[2] = 0.f;
  } else {
    const float coef = mu * z.s / z.t;
    f[0] = sq[0] * z.s;
    f[1] = sq[1] * coef * z.pt1;
    f[2] = sq[2] * coef * z.pt2;
  }
}

__device__ __forceinline__ float cone_cost(const Zone& z, float mu, float mu2p1) {
  const float quad = 0.5f * (z.pn * z.pn + z.pt1 * z.pt1 + z.pt2 * z.pt2);
  if (z.bottom) return quad;
  if (z.top) return 0.f;
  const float g = z.t - mu * z.pn;
  return quad - 0.5f * g * g / mu2p1;
}

// Per-env constants and row state in shared memory.
struct Rows {
  const float *D, *sq, *mu, *mu2p1;
  int nl, nc;
};

// This thread's share of the constraint cost at jar + alpha jp (jp may be
// null): the limit rows' 0.5 D jar^2 where jar < 0, and the cone blocks'.
__device__ float cost_partial(const Rows& R, const float* jar, const float* jp, float alpha) {
  float s = 0.f;
  for (int k = threadIdx.x; k < R.nl + R.nc; k += kThreads) {
    if (k < R.nl) {
      const float u = jp ? jar[k] + alpha * jp[k] : jar[k];
      if (u < 0.f) s += 0.5f * R.D[k] * u * u;
    } else {
      const int c = k - R.nl, r = R.nl + 3 * c;
      float u[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) u[i] = jp ? jar[r + i] + alpha * jp[r + i] : jar[r + i];
      s += cone_cost(zones(u[0], u[1], u[2], R.sq + r, R.mu[c], R.mu2p1[c]), R.mu[c], R.mu2p1[c]);
    }
  }
  return s;
}

// f = force of jar: -D jar on active limit rows, the cone projection on
// blocks. No barrier.
__device__ void force_rows(const Rows& R, const float* jar, float* f) {
  for (int k = threadIdx.x; k < R.nl + R.nc; k += kThreads) {
    if (k < R.nl) {
      f[k] = jar[k] < 0.f ? -R.D[k] * jar[k] : 0.f;
    } else {
      const int c = k - R.nl, r = R.nl + 3 * c;
      const Zone z = zones(jar[r], jar[r + 1], jar[r + 2], R.sq + r, R.mu[c], R.mu2p1[c]);
      cone_force(z, jar[r], jar[r + 1], jar[r + 2], R.D + r, R.sq + r, R.mu[c], f + r);
    }
  }
}

// phi'(alpha) and phi''(alpha) of the linesearch along p, from the row
// values of jar (at x) and jp = J p; every thread gets both.
__device__ void phi_derivs(const Rows& R, const float* jar, const float* jp, float alpha,
                           float pmp, float dmx, float* red, float& d1, float& d2) {
  // [limit-row d1, cone jp . f, limit-row d2, cone curvature]
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k = threadIdx.x; k < R.nl + R.nc; k += kThreads) {
    if (k < R.nl) {
      const float u = jar[k] + alpha * jp[k];
      if (u < 0.f) {
        s[0] += R.D[k] * u * jp[k];
        s[2] += R.D[k] * jp[k] * jp[k];
      }
    } else {
      const int c = k - R.nl, r = R.nl + 3 * c;
      const float mu = R.mu[c], mu2p1 = R.mu2p1[c];
      const float* sq = R.sq + r;
      const float* d = R.D + r;
      const float jn = jp[r], jt1 = jp[r + 1], jt2 = jp[r + 2];
      const float un = jar[r] + alpha * jn, ut1 = jar[r + 1] + alpha * jt1,
                  ut2 = jar[r + 2] + alpha * jt2;
      const Zone z = zones(un, ut1, ut2, sq, mu, mu2p1);
      float f[3];
      cone_force(z, un, ut1, ut2, d, sq, mu, f);
      s[1] += jn * f[0] + jt1 * f[1] + jt2 * f[2];
      if (z.bottom) {
        s[3] += d[0] * jn * jn + d[1] * jt1 * jt1 + d[2] * jt2 * jt2;
      } else if (!z.top) {
        const float qn = -sq[0] * jn, qt1 = -sq[1] * jt1, qt2 = -sq[2] * jt2;
        const float qq = qn * qn + qt1 * qt1 + qt2 * qt2, qq_t = qt1 * qt1 + qt2 * qt2;
        const float t_p = (z.pt1 * qt1 + z.pt2 * qt2) / z.t;
        const float t_pp = fmaxf(qq_t - t_p * t_p, 0.f) / z.t;
        const float g = t_p - mu * qn;
        s[3] += qq - (g * g + (z.t - mu * z.pn) * t_pp) / mu2p1;
      }
    }
  }
  block_sum<kThreads>(s, red);
  d1 = alpha * pmp + dmx + s[0] - s[1];
  d2 = fmaxf(pmp + s[2] + s[3], kEps);
}

__global__ void __launch_bounds__(kThreads)
ell_cg_solve_kernel(const float* __restrict__ g_buf, const float* __restrict__ g_cdof,
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
  const int e = nl + 3 * nc, ldj = j_stride(n);
  const long b = blockIdx.x;
  const int tid = threadIdx.x;

  float* J = smem;
  float* M = J + e * ldj;
  float* L = M + n * n;
  float* aref = L + n * n;
  float* Dr = aref + e;
  float* sq = Dr + e;
  float* jar = sq + e;
  float* jp = jar + e;
  float* f = jp + e;
  float* smooth = f + e;
  float* x = smooth + n;
  float* grad = x + n;
  float* mgrad = grad + n;
  float* p = mgrad + n;
  float* mp = p + n;
  float* mdx = mp + n;
  float* v0 = mdx + n;
  float* v1 = v0 + n;
  float* sy = v1 + n;
  float* mu = sy + n;
  float* mu2p1 = mu + nc;
  float* red = mu2p1 + nc;
  const Rows R{Dr, sq, mu, mu2p1, nl, nc};

  const float* fq = g_fq + b * nc * 18;
  const float* sw = g_sw + b * n * 6;
  const float* ll = g_ll + b * nl;
  const float* qfs = g_qfs + b * n;
  const float* hd = g_hd + b * n;
  const float tolscale = g_tolscale[b];

  // 1. qM; J in efc row order: limit rows, then per contact the block's
  // frame-projected rows jfr[k][d] = (fq[c, k, :] . sw[d, :]) dm[c, d]
  assemble_qm<kThreads>(g_buf + b * n * 6, g_cdof + b * n * 6, anc, arm, M, n);
  for (int t = tid; t < nl * n; t += kThreads) J[(t / n) * ldj + t % n] = lim1h[t] * ll[t / n];
  for (int t = tid; t < nc * n; t += kThreads) {
    const int c = t / n, d = t % n;
    const float* fc = fq + c * 18;
    const float* s = sw + d * 6;
    const float w = dm[c * n + d];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < 6; ++j) acc += fc[6 * k + j] * s[j];
      J[(nl + 3 * c + k) * ldj + d] = acc * w;
    }
  }
  for (int r = tid; r < e; r += kThreads) {
    aref[r] = g_aref[b * e + r];
    Dr[r] = g_D[b * e + r];
    sq[r] = sqrtf(Dr[r]);
  }
  for (int c = tid; c < nc; c += kThreads) {
    mu[c] = g_mu[b * nc + c];
    mu2p1[c] = 1.f + mu[c] * mu[c];
  }
  __syncthreads();
  for (int t = tid; t < n * n; t += kThreads) L[t] = M[t];

  // 2. factor M, solve qacc_smooth
  factor<kThreads>(L, n);
  blocked_substitution<kThreads>(L, qfs, smooth, sy, n);

  // 3. warm start vs smooth start: the cheaper per env. cost(smooth) has no
  // quadratic term.
  for (int i = tid; i < n; i += kThreads) {
    v0[i] = g_warm[b * n + i];
    v1[i] = v0[i] - smooth[i];
  }
  __syncthreads();
  matv_m<kThreads>(M, v1, mdx, n);                 // M (warm - smooth)
  matv_j<kThreads>(J, ldj, v0, aref, jar, e, n);   // jar of warm
  matv_j<kThreads>(J, ldj, smooth, aref, f, e, n); // jar of smooth
  __syncthreads();
  {
    float s[3] = {cost_partial(R, jar, nullptr, 0.f), cost_partial(R, f, nullptr, 0.f), 0.f};
    for (int i = tid; i < n; i += kThreads) s[2] += v1[i] * mdx[i];
    block_sum<kThreads>(s, red);
    const bool take_warm = 0.5f * s[2] + s[0] < s[1];
    if (take_warm) {
      for (int i = tid; i < n; i += kThreads) x[i] = v0[i];
    } else {
      for (int i = tid; i < n; i += kThreads) {
        x[i] = smooth[i];
        mdx[i] = 0.f;
      }
      for (int r = tid; r < e; r += kThreads) jar[r] = f[r];
    }
  }
  __syncthreads();
  force_rows(R, jar, f);
  __syncthreads();
  matv_jt<kThreads>(J, ldj, f, mdx, grad, e, n);  // grad = M dx - J^T force
  __syncthreads();
  blocked_substitution<kThreads>(L, grad, mgrad, sy, n);
  for (int i = tid; i < n; i += kThreads) p[i] = -mgrad[i];
  float imp = 1.f;
  __syncthreads();

  // 4. PR-CG; converged envs take zero-length steps
  for (int it = 0; it < iterations; ++it) {
    // safeguarded Newton linesearch on phi(alpha): bracket [lo, hi] with
    // phi'(lo) < 0 <= phi'(hi); a Newton step outside it falls back to
    // bisection, or to doubling while no upper end is known
    matv_m<kThreads>(M, p, mp, n);
    matv_j<kThreads>(J, ldj, p, nullptr, jp, e, n);
    __syncthreads();
    float pm[2] = {0.f, 0.f};
    for (int i = tid; i < n; i += kThreads) {
      pm[0] += p[i] * mp[i];
      pm[1] += mp[i] * (x[i] - smooth[i]);
    }
    block_sum<kThreads>(pm, red);
    const float pmp = pm[0], dmx = pm[1];
    float d1, d2;
    phi_derivs(R, jar, jp, 0.f, pmp, dmx, red, d1, d2);
    float alpha = fmaxf(-d1 / d2, 0.f), lo = 0.f, hi = FLT_MAX;
    for (int ls = 0; ls < ls_iterations; ++ls) {
      phi_derivs(R, jar, jp, alpha, pmp, dmx, red, d1, d2);
      if (d1 < 0.f) {
        lo = fmaxf(lo, alpha);
      } else {
        hi = fminf(hi, alpha);
      }
      const float newton = alpha - d1 / d2;
      const float fallback = hi < FLT_MAX ? 0.5f * (lo + hi) : 2.f * alpha + 1e-9f;
      alpha = newton > lo && newton < hi ? newton : fallback;
    }
    {  // never take a step that does not lower phi
      float c[2] = {cost_partial(R, jar, jp, alpha), cost_partial(R, jar, nullptr, 0.f)};
      block_sum<kThreads>(c, red);
      const float dphi = 0.5f * alpha * alpha * pmp + alpha * dmx + c[0] - c[1];
      alpha = dphi < 0.f ? alpha : 0.f;
    }
    alpha *= imp;
    for (int i = tid; i < n; i += kThreads) {
      x[i] += alpha * p[i];
      v0[i] = x[i] - smooth[i];
    }
    __syncthreads();
    // jar and M (x - smooth) afresh from x, not by increments
    matv_j<kThreads>(J, ldj, x, aref, jar, e, n);
    matv_m<kThreads>(M, v0, mdx, n);
    __syncthreads();
    force_rows(R, jar, f);
    __syncthreads();
    matv_jt<kThreads>(J, ldj, f, mdx, v0, e, n);  // new gradient
    __syncthreads();
    blocked_substitution<kThreads>(L, v0, v1, sy, n);  // new preconditioned gradient
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

  // 5. force and qfrc
  force_rows(R, jar, f);
  __syncthreads();
  for (int r = tid; r < e; r += kThreads) o_force[b * e + r] = f[r];
  matv_jt<kThreads>(J, ldj, f, nullptr, v0, e, n);
  __syncthreads();

  // 6. Euler: factor M + diag(hd), solve qacc_eff from qfrc_smooth + qfrc
  for (int t = tid; t < n * n; t += kThreads) L[t] = M[t] + (t / n == t % n ? hd[t / n] : 0.f);
  for (int i = tid; i < n; i += kThreads) v1[i] = qfs[i] + v0[i];
  __syncthreads();
  factor<kThreads>(L, n);
  blocked_substitution<kThreads>(L, v1, mp, sy, n);

  for (int i = tid; i < n; i += kThreads) {
    o_smooth[b * n + i] = smooth[i];
    o_qacc[b * n + i] = x[i];
    o_qfrc[b * n + i] = v0[i];
    o_eff[b * n + i] = mp[i];
  }
}

}  // namespace

extern "C" long ell_cg_solve_smem_bytes(int n, int nl, int nc) {
  return smem_floats(n, nl, nc) * (long)sizeof(float);
}

extern "C" int ell_cg_solve_f32(const float* buf, const float* cdof, const float* fq,
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
  const long smem = ell_cg_solve_smem_bytes(n, nl, nc);
  cudaError_t err = cudaFuncSetAttribute(
      ell_cg_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ell_cg_solve_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      buf, cdof, fq, sw, ll, mu, aref, D, qfrc_smooth, warm, hd, tolscale, anc, arm, dm,
      lim1h, qacc_smooth, qacc, qfrc_constraint, qacc_eff, efc_force, n, nl, nc,
      iterations, ls_iterations);
  return (int)cudaGetLastError();
}
