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
// What bounds it on Hopper: each env's chain of dependent steps, not bytes
// (about 5 KB in and 1 KB out per env at the fly's n = 42, 117 rows) or
// operations (about 0.37 MFLOP per env at 4/4, 0.0225 ms for 4096 envs at
// 67 TFLOP/s; matrix-vector products, nothing for tensor cores). An env runs
// 2 Cholesky factorizations, iterations + 3 exact (L L^T)^-1 substitutions,
// and per iteration an M, J and J^T product and ls_iterations + 3 reductions.
// The first design (dense J, qM and L in 39 KB of shared memory, 5 CTAs per
// SM) paid about 520 CTA barriers per env for them.
//
// The design, for n <= 128, keeps the first design's float32 operations and
// their order, so that its outputs are the first design's bit for bit (the
// linesearch is a knife edge: two float32 solves that differ in one rounding
// part by O(1) on a share of envs):
// - The per-env operands (buf, cdof, sw, fq, ll, mu, aref, D, warm) and the
//   static lim1h are copied into shared memory with cp.async, all copies in
//   flight at once, over the regions that later hold L and jfr; qfrc_smooth,
//   hd, anc, arm and dm, each read once or twice, are read where they are
//   used. 28,096 B of shared memory at the fly's sizes.
// - qM and both factors live in the lower-triangle 4x4 tiles of
//   tiled_cholesky.cuh (4.2 KB each at n = 42). qM is assembled straight
//   into them by tile rows (the diagonal tiles whole, each entry as the
//   first design's dense build), so M(max(i, j), min(i, j)) read in
//   increasing j is the dense row-major read.
// - Both factorizations (qM; M + diag(hd) for Euler) are the tiled factor of
//   the standalone cholesky kernel: `factor`'s arithmetic, one barrier per
//   panel of 8 (`factor` paid 3 per column).
// - The substitutions run on one warp (warp_exact_solve), the exact panel
//   substitution of the first design entry for entry, with no CTA barrier;
//   that warp, which also factors the panels, is another one in consecutive
//   CTAs, so that the resident CTAs' serial phases do not all queue on one
//   scheduler.
// - J is compact: a limit row is its dof and its value lim1h ll (lim1h's
//   rows are one-hot; a row with two nonzeros makes the env's J NaN), a
//   contact its three frame rows jfr at an odd stride. J x skips nothing;
//   J^T f adds each dof's limit rows through a per-dof list in row order,
//   then the contact rows in order: the dense sums less their zero terms,
//   which were exact.
// - A thread takes a limit row or a whole cone block in the row passes, so
//   that jar and the force of a block come out of one pass.
// - Every reduction keeps the first design's order (128 threads, one
//   butterfly per warp, the warps' sums added in order) behind one CTA
//   barrier, a double-buffered array taking the warps' sums; the solo warp
//   replays that order alone for beta after its substitution. A CG iteration
//   pays ls_iterations + 7 CTA barriers (the first design about 50 at 4/4).
// - The substitutions skip the divisions of zero dividends (the gradient of
//   an env at rest is exactly zero, and a zero dividend leaves the division's
//   fast path): the same bits, 41% off the fly main path's solve time on an
//   NVIDIA H100 (PERF.md, Findings).
// - 64 threads per env, 8 envs per SM (kThreads, kMinCtas): 128 threads
//   left a CTA's 168 registers too many for more than 3 CTAs per SM, and 6
//   at 64 threads ran 18% slower than 8 on an NVIDIA H100 (PERF.md, Findings).
// What is left is in PERF.md (Findings).
//
// Two modes of the TPU kernel's that the compact layout cannot take:
// - the dense mode (ell_cg_solve_dense_f32, kDense) replaces _ell_cg_kernel
//   with jb=None: J is a dense [e][n] array per env, e = ns + 3 nc, its
//   first ns rows unilateral scalar rows of any content (limits and
//   condim-1 contacts), then the cone blocks (elliptic plans with condim-1
//   contacts beside the cone blocks: the fly with a condim-1 leg, 113 rows).
//   J stays in device memory and every pass over it walks it in panels of
//   whole items (a cone block's three rows never part) through two slots of
//   shared memory (j_panels.cuh), the next panel's copy in flight; buf and
//   cdof are staged in L's region. In the row passes a thread takes a row
//   (a block's three rows are three sums, each its own), and the cone
//   forces follow the jar pass behind a barrier; J x sums each row in
//   increasing d, J^T f each column in row order with its partial sum
//   carried across panels, as over a resident J, so the outputs are the
//   first dense design's bit for bit. The per-dof limit lists do not apply.
//   Each walk starts on the panels the last one ended on (J p forward, jar
//   backward, J^T f forward) but the J p walk, whose first panel is copied
//   while the solo warp solves. Everything else is the compact mode's code,
//   but for two passes saved: jar of the warm start and of the smooth start
//   are taken in one walk after the smooth solve, and qfrc is the J^T f of
//   the last CG pass (the force has not changed since). A dense J in shared
//   memory (the first dense design) took 19.4 KB beside the CTA's 14.1 KB
//   and held the SM to 6 CTAs; the slots' 13.2 KB (kJRingFloats: 39 rows of
//   42, 3 panels a pass at 113 rows) keep the compact mode's 8. What it
//   costs: a J x pass is 3 rows in series per thread where a resident J took
//   2 items, 8 more CTA barriers a CG iteration (ls_iterations + 7 before),
//   and the waits for copies asked for one step ahead (PERF.md, Findings).
//   Device memory is read once (the resident CTAs' J, 20 MB, stays in L2). A
//   model whose J fits in 2 panels is copied once, whole, and walked
//   without a barrier.
// - with_euler = 0 (plans on RK4 or an implicit integrator, as the TPU
//   kernel's hd=None), in both modes: no factor of M + diag(hd), no
//   qacc_eff; the other four outputs are the with-Euler launch's bits.
//
// C interface (bound with ctypes): ell_cg_solve_f32 and
// ell_cg_solve_dense_f32 launch on the given stream and return
// cudaGetLastError() (cudaErrorInvalidValue for n > 128);
// ell_cg_solve_smem_bytes and ell_cg_solve_dense_smem_bytes give the dynamic
// shared memory one CTA needs; ell_cg_solve_kernel_info and
// ell_cg_solve_dense_kernel_info its registers, shared memory, resident CTAs
// per SM and threads; ell_cg_solve_dense_panels the panels of its walks
// over J; ell_cg_solve_stamps the phase stamps of a build with
// CG_SOLVE_STAMPS.

#include <cfloat>
#include <climits>
#include <cuda_runtime.h>

#include "cholesky.cuh"
#include "j_panels.cuh"
#include "tiled_cholesky.cuh"

namespace {

// Threads per env, and the resident CTAs per SM asked of the register
// allocator: 8 CTAs of 64 threads leave each thread 128 registers, and the
// fly's 28,096 B of shared memory lets 8 CTAs share an SM.
constexpr int kThreads = 64;
constexpr int kMinCtas = 8;
// The dense mode: J's two slots in shared memory, at most 13.3 KB, and the
// dof columns of a J^T f walk per thread.
constexpr int kJRingFloats = 3400;
constexpr int kJtCols = (kMaxN + kThreads - 1) / kThreads;

__host__ __device__ inline int up4(int k) { return (k + 3) & ~3; }

// The reductions keep the first design's order: 128 threads in 4 warps.
constexpr int kOrderThreads = 128;
constexpr int kOrderWarps = kOrderThreads / 32;
constexpr int kMaxSums = 7;  // the most sums one reduction takes

// Phase stamps, for tools/compare_torch_kernels.py: a build with
// CG_SOLVE_STAMPS adds the clock64() cycles of the solo warp's (below) first
// thread since the last stamp to g_stamps[k] at each stamp (a CG
// iteration's phases add up over its iterations); ell_cg_solve_stamps reads
// and clears them. Other builds stamp nothing.
constexpr int kStamps = 20;
#ifdef CG_SOLVE_STAMPS
__device__ unsigned long long g_stamps[kStamps];
#define STAMP(k)                                                                \
  do {                                                                          \
    if (threadIdx.x == 32 * solo) {                                             \
      const long long now = clock64();                                          \
      atomicAdd(&g_stamps[k], (unsigned long long)(now - stamp_last));          \
      stamp_last = now;                                                         \
    }                                                                           \
  } while (0)
#else
#define STAMP(k) \
  do {           \
  } while (0)
#endif

// Shared memory, in floats, each section a multiple of 16 B: M's tiles; L's
// tiles (before the factor, the staged sw and fq); jfr (before it, the
// staged buf, cdof and lim1h); 6 row vectors; the limit-row tables; mu and
// 1 + mu^2; 10 dof vectors; the reductions' two buffers and one flag. The
// dense mode (nl = ns scalar rows) keeps J's slots (j_panels.cuh) where jfr
// lies and stages buf and cdof in L's region.
struct Layout {
  int tiles, lreg, jfr, js, rows, lim, dofs, cons, total;
  __host__ __device__ Layout(int n, int nl, int nc, bool dense = false) {
    tiles = (int)tiles_floats(n);
    lreg = max(tiles, up4(dense ? 12 * n : 6 * n + 18 * nc));
    js = n | 1;  // odd: neighbouring contacts' rows in distinct banks
    jfr = dense ? JPanels(n, nl + 3 * nc, nl, kJRingFloats).floats()
                : up4(max(3 * nc * js, 12 * n + nl * n));
    rows = up4(nl + 3 * nc);
    lim = up4(nl);
    dofs = up4(n);
    cons = up4(nc);
    total = tiles + lreg + jfr + 6 * rows + 3 * lim + dofs + 2 * cons + 10 * dofs +
            2 * kOrderWarps * kMaxSums + 4;
  }
};

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

// One env's operands in shared memory. An item k < nl + nc is scalar row k
// (k < nl) or the cone block of contact k - nl, rows nl + 3 (k - nl) + 0..2.
// Compact: the scalar rows are limit rows, J the limit tables and jfr;
// kDense: J is dense, walked in panels (j_panels.cuh, j_row_at), jfr its
// slots; the limit tables unused.
template <bool kDense>
struct Env {
  Tiles M;
  const float* jfr;    // [nc][3][js]: jfr0, jfr1, jfr2 of each contact
  const float *D, *sq, *mu, *mu2p1;
  const int* ldof;     // limit row -> its dof
  const float* lval;   // limit row -> its J value
  const int* lnext;    // limit row -> the next limit row at its dof, or -1
  const int* lfirst;   // dof -> its first limit row, or -1
  int n, nl, nc, js;

  __device__ int row0(int k) const { return k < nl ? k : nl + 3 * (k - nl); }

  // (M (v - sub))[i] (sub may be null): M(max(i, j), min(i, j)) in
  // increasing j, row i's tiles left of the diagonal as 128-bit reads.
  __device__ __forceinline__ float m_row(const float* v, const float* sub, int i) const {
    const int ti = i >> 2, rp = M.row_part(i);
    float s = 0.f;
    for (int tc = 0; tc < ti; ++tc) {
      const float4 m = *reinterpret_cast<const float4*>(M.s + rp + 4 * tri(M.nt - 1 - tc));
      float4 x = *reinterpret_cast<const float4*>(v + 4 * tc);
      if (sub) {
        const float4 y = *reinterpret_cast<const float4*>(sub + 4 * tc);
        x = make_float4(x.x - y.x, x.y - y.y, x.z - y.z, x.w - y.w);
      }
      s += m.x * x.x;
      s += m.y * x.y;
      s += m.z * x.z;
      s += m.w * x.w;
    }
    const int jd = min(4 * ti + 4, n);
    for (int j = 4 * ti; j < jd; ++j)  // the diagonal tile holds both triangles
      s += M.s[rp + M.col_part(j)] * (sub ? v[j] - sub[j] : v[j]);
    const int cp = M.col_part(i);
    for (int j = jd; j < n; ++j) s += M.s[M.row_part(j) + cp] * (sub ? v[j] - sub[j] : v[j]);
    return s;
  }

  // kDense: out[r] = (J x)[r] - sub[r] (sub may be null) for row r, at row
  // in shared memory, summed in increasing d; where kTwo also out2[r] = (J
  // x2)[r] - sub[r] in the same loop.
  template <bool kTwo>
  __device__ __forceinline__ void j_row_at(const float* row, const float* x, const float* x2,
                                           const float* sub, int r, float* out, float* out2) const {
    float s = 0.f, t = 0.f;
    for (int d = 0; d < n; ++d) {
      s += row[d] * x[d];
      if constexpr (kTwo) t += row[d] * x2[d];
    }
    out[r] = sub ? s - sub[r] : s;
    if constexpr (kTwo) out2[r] = sub ? t - sub[r] : t;
  }

  // out[r] = (J x)[r] - sub[r] (sub may be null) for item k's rows, each
  // row summed in increasing d (compact).
  __device__ __forceinline__ void j_item(const float* x, const float* sub, int k, float* out) const {
    if (k < nl) {
      float s = 0.f;
      s += lval[k] * x[ldof[k]];
      out[k] = sub ? s - sub[k] : s;
    } else {
      const int c = k - nl, r = nl + 3 * c;
      const float* j0 = jfr + 3 * c * js;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
      for (int d = 0; d < n; ++d) {
        s0 += j0[d] * x[d];
        s1 += j0[js + d] * x[d];
        s2 += j0[2 * js + d] * x[d];
      }
      out[r] = sub ? s0 - sub[r] : s0;
      out[r + 1] = sub ? s1 - sub[r + 1] : s1;
      out[r + 2] = sub ? s2 - sub[r + 2] : s2;
    }
  }

  // base[d] - (J^T f)[d] (base may be null: (J^T f)[d]): d's limit rows in
  // row order, then every contact's three rows in order (compact).
  __device__ __forceinline__ float jt_col(const float* f, const float* base, int d) const {
    float s = 0.f;
    for (int r = lfirst[d]; r >= 0; r = lnext[r]) s += lval[r] * f[r];
    for (int c = 0; c < nc; ++c) {
      const float* j0 = jfr + 3 * c * js + d;
      const float* fr = f + nl + 3 * c;
      s += j0[0] * fr[0];
      s += j0[js] * fr[1];
      s += j0[2 * js] * fr[2];
    }
    return base ? base[d] - s : s;
  }

  // f of item k's rows from jar: -D jar on an active scalar row, the cone
  // projection on a block.
  __device__ __forceinline__ void force_item(const float* jar, int k, float* f) const {
    if (k < nl) {
      f[k] = jar[k] < 0.f ? -D[k] * jar[k] : 0.f;
    } else {
      const int c = k - nl, r = nl + 3 * c;
      const Zone z = zones(jar[r], jar[r + 1], jar[r + 2], sq + r, mu[c], mu2p1[c]);
      cone_force(z, jar[r], jar[r + 1], jar[r + 2], D + r, sq + r, mu[c], f + r);
    }
  }

  // Adds item k's share of the constraint cost at jar + alpha jp (jp may
  // be null) to s: 0.5 D jar^2 on an active limit row, the cone cost of a
  // block.
  __device__ __forceinline__ void cost_item(const float* jar, const float* jp, float alpha, int k,
                                            float& s) const {
    if (k < nl) {
      const float u = jp ? jar[k] + alpha * jp[k] : jar[k];
      if (u < 0.f) s += 0.5f * D[k] * u * u;
      return;
    }
    const int c = k - nl, r = nl + 3 * c;
    float u[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) u[i] = jp ? jar[r + i] + alpha * jp[r + i] : jar[r + i];
    s += cone_cost(zones(u[0], u[1], u[2], sq + r, mu[c], mu2p1[c]), mu[c], mu2p1[c]);
  }

  // Item k's terms of phi'(alpha) and phi''(alpha) along p, added to s:
  // [limit-row d1, cone jp . f, limit-row d2, cone curvature].
  __device__ __forceinline__ void phi_item(const float* jar, const float* jp, float alpha, int k,
                                           float* s) const {
    if (k < nl) {
      const float u = jar[k] + alpha * jp[k];
      if (u < 0.f) {
        s[0] += D[k] * u * jp[k];
        s[2] += D[k] * jp[k] * jp[k];
      }
      return;
    }
    const int c = k - nl, r = nl + 3 * c;
    const float m = mu[c], m2p1 = mu2p1[c];
    const float* q = sq + r;
    const float* d = D + r;
    const float jn = jp[r], jt1 = jp[r + 1], jt2 = jp[r + 2];
    const float un = jar[r] + alpha * jn, ut1 = jar[r + 1] + alpha * jt1,
                ut2 = jar[r + 2] + alpha * jt2;
    const Zone z = zones(un, ut1, ut2, q, m, m2p1);
    float f[3];
    cone_force(z, un, ut1, ut2, d, q, m, f);
    s[1] += jn * f[0] + jt1 * f[1] + jt2 * f[2];
    if (z.bottom) {
      s[3] += d[0] * jn * jn + d[1] * jt1 * jt1 + d[2] * jt2 * jt2;
    } else if (!z.top) {
      const float qn = -q[0] * jn, qt1 = -q[1] * jt1, qt2 = -q[2] * jt2;
      const float qq = qn * qn + qt1 * qt1 + qt2 * qt2, qq_t = qt1 * qt1 + qt2 * qt2;
      const float t_p = (z.pt1 * qt1 + z.pt2 * qt2) / z.t;
      const float t_pp = fmaxf(qq_t - t_p * t_p, 0.f) / z.t;
      const float g = t_p - m * qn;
      s[3] += qq - (g * g + (z.t - m * z.pn) * t_pp) / m2p1;
    }
  }
};

// Sums over count indices in the first design's order: 128 threads, thread t
// summing indices t, t + 128, ... one term at a time, each warp's 32
// partials summed by the shuffle butterfly, then the 4 warps' sums in order
// from 0 (a warp with no index sums to +0, which adds nothing, and is
// skipped: a sum that starts at +0 is never -0). Here warp w plays the first design's warps w, w + W, ... (lane l
// as its thread 32 w + l); their sums go through red, one of two buffers of
// 4 kMaxSums floats taken in turn (`parity`), so that one barrier suffices:
// a buffer is written again only two reductions later, after every thread
// has passed the barrier that follows its reads. Every thread gets the same
// bits. term(t, v) adds index t's K terms to v. Every thread calls it.
template <int K, typename Term>
__device__ __forceinline__ void ordered_sums(int count, Term term, float* red, int& parity,
                                             float (&out)[K]) {
  constexpr int W = kThreads / 32, per_warp = kOrderWarps / W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* buf = red + parity * kOrderWarps * kMaxSums;
#pragma unroll
  for (int q = 0; q < per_warp; ++q) {
    const int w = warp + q * W;
    if (32 * w < count) {  // a first-design warp with no index sums to +0, which adds nothing
      float v[K];
#pragma unroll
      for (int k = 0; k < K; ++k) v[k] = 0.f;
      for (int t = 32 * w + lane; t < count; t += kOrderThreads) term(t, v);
#pragma unroll
      for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < K; ++k) buf[w * K + k] = v[k];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kOrderWarps; ++w)
      if (32 * w < count) s += buf[w * K + k];
    out[k] = s;
  }
  parity ^= 1;
}

// ordered_sums' arithmetic on one warp alone, with no barrier: the warp
// plays all 4 of the first design's warps in turn. Every lane gets the sums.
template <int K, typename Term>
__device__ __forceinline__ void warp_ordered_sums(int count, Term term, float (&out)[K]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < K; ++k) out[k] = 0.f;
#pragma unroll
  for (int w = 0; w < kOrderWarps; ++w) {
    if (32 * w < count) {
      float v[K];
#pragma unroll
      for (int k = 0; k < K; ++k) v[k] = 0.f;
      for (int t = 32 * w + lane; t < count; t += kOrderThreads) term(t, v);
#pragma unroll
      for (int k = 0; k < K; ++k) out[k] += warp_sum(v[k]);
    }
  }
}

// kDense: J is g_j [B][nl + 3 nc][n], its first nl rows the scalar rows (the
// compact operands fq, sw, ll, dm and lim1h are not read); else J is built
// from them. with_euler = 0 skips the factor of M + diag(hd) and o_eff.
template <bool kDense>
__global__ void __launch_bounds__(kThreads, kMinCtas)
ell_cg_solve_kernel(const float* __restrict__ g_buf, const float* __restrict__ g_cdof,
                    const float* __restrict__ g_fq, const float* __restrict__ g_sw,
                    const float* __restrict__ g_ll, const float* __restrict__ g_mu,
                    const float* __restrict__ g_j,
                    const float* __restrict__ g_aref, const float* __restrict__ g_D,
                    const float* __restrict__ g_qfs, const float* __restrict__ g_warm,
                    const float* __restrict__ g_hd, const float* __restrict__ g_tolscale,
                    const float* __restrict__ anc, const float* __restrict__ arm,
                    const float* __restrict__ dm, const float* __restrict__ lim1h,
                    float* __restrict__ o_smooth, float* __restrict__ o_qacc,
                    float* __restrict__ o_qfrc, float* __restrict__ o_eff,
                    float* __restrict__ o_force, int n, int nl, int nc, int iterations,
                    int ls_iterations, int with_euler, int arm_stride) {
  constexpr int NT = kThreads;
  extern __shared__ __align__(16) float smem[];
  const Layout lay(n, nl, nc, kDense);
  const int e = nl + 3 * nc, items = nl + nc;
  const long b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // The warp that runs the serial phases (panels, substitutions): one per
  // CTA in turn, so that the resident CTAs' solo warps do not all land on
  // one scheduler of the SM.
  const int solo = blockIdx.x % (NT / 32);
#ifdef CG_SOLVE_STAMPS
  long long stamp_last = clock64();
#endif

  float* M_s = smem;
  float* L_s = M_s + lay.tiles;
  float* jfr = L_s + lay.lreg;
  float* aref = jfr + lay.jfr;
  float* Dr = aref + lay.rows;
  float* sq = Dr + lay.rows;
  float* jar = sq + lay.rows;
  float* jp = jar + lay.rows;
  float* f = jp + lay.rows;
  int* ldof = reinterpret_cast<int*>(f + lay.rows);
  float* lval = reinterpret_cast<float*>(ldof + lay.lim);
  int* lnext = reinterpret_cast<int*>(lval + lay.lim);
  int* lfirst = lnext + lay.lim;
  float* mu = reinterpret_cast<float*>(lfirst + lay.dofs);
  float* mu2p1 = mu + lay.cons;
  float* smooth = mu2p1 + lay.cons;
  float* x = smooth + lay.dofs;
  float* grad = x + lay.dofs;
  float* mgrad = grad + lay.dofs;
  float* p = mgrad + lay.dofs;
  float* mp = p + lay.dofs;
  float* mdx = mp + lay.dofs;
  float* v0 = mdx + lay.dofs;
  float* v1 = v0 + lay.dofs;
  float* y = v1 + lay.dofs;  // the substitutions' scratch
  float* red = y + lay.dofs;
  float* flag = red + 2 * kOrderWarps * kMaxSums;  // the solo warp's |grad|^2
  int parity = 0;
  // staged operands: buf, cdof and lim1h in jfr's region until jfr is
  // built from sw and fq, which are in L's region until L = M (kDense: J in
  // jfr's region, buf and cdof in L's)
  float* s_buf = kDense ? L_s : jfr;
  float* s_cdof = s_buf + 6 * n;
  float* s_lim1h = s_cdof + 6 * n;
  float* s_sw = L_s;
  float* s_fq = s_sw + 6 * n;

  const Env<kDense> env{Tiles(M_s, n), jfr, Dr, sq, mu, mu2p1, ldof, lval, lnext, lfirst,
                        n, nl, nc, lay.js};
  const Tiles& M = env.M;
  const Tiles L(L_s, n);
  const float* qfs = g_qfs + b * n;
  const float* hd = g_hd + b * n;
  const float tolscale = g_tolscale[b];
  // the dense mode: J in device memory, its panels' stream (j_panels.cuh)
  const JPanels jpan(n, e, nl, kJRingFloats);
  const float* gj = kDense ? g_j + b * e * n : nullptr;
  JPanels::Stream jst{};
  // a dense walk of the row passes, backward or forward (`next_backward`:
  // the next walk's way). Each walk starts where the last one ended but the
  // J p walk, which follows the solo warp's solve: the first panel's copy
  // has that long to land. m_row(i) for each of the M rows that go with a
  // panel (JPanels::m_rows), j_row(r, row r in shared memory) for each row
  // of the panel: a thread a row, not a cone block (a block's three rows
  // are three sums of their own; a thread a block left 50 of 64 threads
  // idle in a panel of blocks)
  const auto row_walk = [&](bool backward, bool next_backward, auto m_row, auto j_row) {
    jpan.walk<NT>(jfr, gj, jst, backward, next_backward, [&](int k, int r0, int r1, const float* rows) {
      const int2 mr = jpan.m_rows(k);
      const int m = mr.y - mr.x;
      for (int t = tid; t < m + r1 - r0; t += NT) {
        if (t < m) {
          m_row(mr.x + t);
        } else {
          j_row(r0 + t - m, rows + (t - m) * n);
        }
      }
    });
  };
  // J^T f of the dense walks: out[d] = base[d] - (J^T f)[d], and (J^T f)[d]
  // into o_qfrc (the last pass's is qfrc)
  const auto jt_walk = [&](const float* base, float* out) {
    float s[kJtCols];
#pragma unroll
    for (int q = 0; q < kJtCols; ++q) s[q] = 0.f;
    jpan.walk<NT>(jfr, gj, jst, false, false, [&](int, int r0, int r1, const float* rows) {
#pragma unroll
      for (int q = 0; q < kJtCols; ++q) {
        const int d = tid + q * NT;
        if (d < n)
          for (int r = r0; r < r1; ++r) s[q] += rows[(r - r0) * n + d] * f[r];
      }
    });
#pragma unroll
    for (int q = 0; q < kJtCols; ++q) {
      const int d = tid + q * NT;
      if (d < n) {
        out[d] = base[d] - s[q];
        o_qfrc[b * n + d] = s[q];
      }
    }
  };

  // 1. the per-env operands and lim1h into shared memory, all copies in
  // flight at once (warm into x, ll into lval); kDense: then J's first
  // panel
  {
    auto copy = [&](float* dst, const float* src, int count) {
      for (int t = tid; t < count; t += NT) cp_async4(dst + t, src + t);
    };
    copy(aref, g_aref + b * e, e);
    copy(Dr, g_D + b * e, e);
    copy(mu, g_mu + b * nc, nc);
    if constexpr (!kDense) copy(lval, g_ll + b * nl, nl);
    copy(x, g_warm + b * n, n);
    copy(s_buf, g_buf + b * 6 * n, 6 * n);
    copy(s_cdof, g_cdof + b * 6 * n, 6 * n);
    if constexpr (!kDense) {
      copy(s_sw, g_sw + b * 6 * n, 6 * n);
      copy(s_fq, g_fq + b * 18 * nc, 18 * nc);
      copy(s_lim1h, lim1h, nl * n);
    }
    if constexpr (kDense) jst = jpan.start<NT>(jfr, gj, true);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  __syncthreads();
  STAMP(0);
  // qM = anc-masked buf cdof^T mirrored + diag(arm), into the lower tiles
  // (the diagonal tiles whole; padding zero), each entry as the first
  // design's dense build; a thread per tile row, its 4 entries stored at once.
  // arm is this env's armature: arm_stride 0 where every env shares one
  // (an int product: the launch refuses batch * arm_stride past INT_MAX).
  for (int t = tid; t < 4 * tri(M.nt); t += NT) {
    const int2 ct = untri(t >> 2);  // tile t / 4 in Tiles' order
    const int i = 4 * (M.nt - 1 - ct.y) + (t & 3), j0 = 4 * (M.nt - 1 - ct.x);
    float v[4], a_ij[4], a_ji[4];  // every anc load issued at once
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int ic = min(i, n - 1), jc = min(j0 + c, n - 1);
      a_ij[c] = anc[ic * n + jc];
      a_ji[c] = anc[jc * n + ic];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + c;
      v[c] = 0.f;
      if (i < n && j < n) {
        const int lo = a_ij[c] != 0.f ? i : (a_ji[c] != 0.f ? j : -1);
        if (lo >= 0) {
          const int hi = lo == i ? j : i;
          float s = 0.f;
#pragma unroll
          for (int k = 0; k < 6; ++k) s += s_buf[lo * 6 + k] * s_cdof[hi * 6 + k];
          v[c] = s;
        }
        if (i == j) v[c] += arm[blockIdx.x * arm_stride + i];
      }
    }
    M.row(t >> 2, t & 3) = make_float4(v[0], v[1], v[2], v[3]);
  }
  // limit rows: each one-hot row's dof and J value, a warp per row (not in
  // the dense mode)
  for (int r = warp; r < (kDense ? 0 : nl); r += NT / 32) {
    const float* row = s_lim1h + r * n;
    unsigned nz[kLaneRows];
#pragma unroll
    for (int q = 0; q < kLaneRows; ++q) {
      const int d = 32 * q + lane;
      nz[q] = __ballot_sync(0xffffffffu, d < n && row[d] != 0.f);
    }
    int dof = -1, count = 0;
#pragma unroll
    for (int q = 0; q < kLaneRows; ++q) {
      if (dof < 0 && nz[q]) dof = 32 * q + __ffs(nz[q]) - 1;
      count += __popc(nz[q]);
    }
    dof = max(dof, 0);
    if (lane == 0) {
      ldof[r] = dof;
      lval[r] = count > 1 ? __int_as_float(0x7fc00000) : row[dof] * lval[r];
    }
  }
  for (int r = tid; r < e; r += NT) sq[r] = sqrtf(Dr[r]);
  for (int c = tid; c < nc; c += NT) mu2p1[c] = 1.f + mu[c] * mu[c];
  __syncthreads();
  STAMP(1);
  // jfr[c][k][d] = (fq[c, k, :] . sw[d, :]) dm[c, d] (over buf, cdof and
  // lim1h; not in the dense mode)
  for (int t = tid; t < (kDense ? 0 : nc * n); t += NT) {
    const int c = t / n, d = t % n;
    const float* fc = s_fq + c * 18;
    const float* s = s_sw + d * 6;
    float j0 = 0.f, j1 = 0.f, j2 = 0.f;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      j0 += fc[k] * s[k];
      j1 += fc[6 + k] * s[k];
      j2 += fc[12 + k] * s[k];
    }
    const float w = dm[c * n + d];
    float* row = jfr + 3 * c * lay.js + d;
    row[0] = j0 * w;
    row[lay.js] = j1 * w;
    row[2 * lay.js] = j2 * w;
  }
  __syncthreads();
  STAMP(2);
  // L = M (over the staged operands); each dof's limit rows as a list in
  // row order (not in the dense mode)
  for (int t = tid; t < lay.tiles / 4; t += NT)
    reinterpret_cast<float4*>(L_s)[t] = reinterpret_cast<const float4*>(M_s)[t];
  for (int d = tid; d < (kDense ? 0 : n); d += NT) {
    int r1 = -1;
    for (int r = nl - 1; r >= 0; --r)
      if (ldof[r] == d) r1 = r;
    lfirst[d] = r1;
  }
  for (int r = tid; r < (kDense ? 0 : nl); r += NT) {
    int r1 = -1;
    for (int q = nl - 1; q > r; --q)
      if (ldof[q] == ldof[r]) r1 = q;
    lnext[r] = r1;
  }
  __syncthreads();
  STAMP(3);

  // 2. factor qM; the solo warp solves qacc_smooth while the others take
  // jar of the warm start (dense: in step 3's walk)
  tiled_factor<NT>(L, n, solo);
  STAMP(4);
  if (warp == solo) {
    warp_exact_solve<true>(L, qfs, smooth, y, n);
  } else if constexpr (!kDense) {
    const int other = ((warp - solo - 1 + NT / 32) % (NT / 32)) * 32 + lane;
    for (int k = other; k < items; k += NT - 32) env.j_item(x, aref, k, jar);
  }
  __syncthreads();
  STAMP(5);

  // 3. warm start vs smooth start, the cheaper per env; cost(smooth) has no
  // quadratic term. mdx = M (warm - smooth), jp = jar of smooth.
  if constexpr (kDense) {  // jar and jp of each row at once
    row_walk(true, false, [&](int i) { mdx[i] = env.m_row(x, smooth, i); },
             [&](int r, const float* row) { env.template j_row_at<true>(row, x, smooth, aref, r, jar, jp); });
  } else {
    for (int t = tid; t < n + items; t += NT) {
      if (t < n) {
        mdx[t] = env.m_row(x, smooth, t);
      } else {
        env.j_item(smooth, aref, t - n, jp);
      }
    }
  }
  __syncthreads();
  STAMP(6);
  {
    float s[3];
    ordered_sums(max(n, items), [&](int t, float(&v)[3]) {
      if (t < items) {
        env.cost_item(jar, nullptr, 0.f, t, v[0]);
        env.cost_item(jp, nullptr, 0.f, t, v[1]);
      }
      if (t < n) v[2] += (x[t] - smooth[t]) * mdx[t];
    }, red, parity, s);
    const bool take_warm = 0.5f * s[2] + s[0] < s[1];
    for (int t = tid; t < n + items; t += NT) {
      if (t < n) {
        if (!take_warm) {
          x[t] = smooth[t];
          mdx[t] = 0.f;
        }
      } else {
        const int k = t - n, r = env.row0(k), rows = k < nl ? 1 : 3;
        if (!take_warm)
          for (int q = 0; q < rows; ++q) jar[r + q] = jp[r + q];
        env.force_item(jar, k, f);
      }
    }
  }
  __syncthreads();
  STAMP(7);
  // grad = M dx - J^T force; mgrad = (L L^T)^-1 grad; p = -mgrad
  if constexpr (kDense) {
    jt_walk(mdx, grad);
  } else {
    for (int d = tid; d < n; d += NT) grad[d] = env.jt_col(f, mdx, d);
  }
  __syncthreads();
  STAMP(8);
  if (warp == solo) {
    warp_exact_solve<true>(L, grad, mgrad, y, n);
    for (int i = lane; i < n; i += 32) p[i] = -mgrad[i];
  }
  float imp = 1.f;
  __syncthreads();
  STAMP(9);

  // 4. PR-CG; converged envs take zero-length steps
  for (int it = 0; it < iterations; ++it) {
    if constexpr (kDense) {
      row_walk(false, true, [&](int i) { mp[i] = env.m_row(p, nullptr, i); },
               [&](int r, const float* row) {
                 env.template j_row_at<false>(row, p, nullptr, nullptr, r, jp, nullptr);
               });
    } else {
      for (int t = tid; t < n + items; t += NT) {
        if (t < n) {
          mp[t] = env.m_row(p, nullptr, t);
        } else {
          env.j_item(p, nullptr, t - n, jp);
        }
      }
    }
    __syncthreads();
    STAMP(10);
    // safeguarded Newton linesearch on phi(alpha): bracket [lo, hi] with
    // phi'(lo) < 0 <= phi'(hi); a Newton step outside it falls back to
    // bisection, or to doubling while no upper end is known. The first
    // reduction also takes p M p, M p . (x - smooth) and the cost at x.
    float pmp, dmx, cost0, d1, d2;
    {
      float s[7];
      ordered_sums(max(n, items), [&](int t, float(&v)[7]) {
        if (t < n) {
          v[0] += p[t] * mp[t];
          v[1] += mp[t] * (x[t] - smooth[t]);
        }
        if (t < items) {
          env.phi_item(jar, jp, 0.f, t, v + 2);
          env.cost_item(jar, nullptr, 0.f, t, v[6]);
        }
      }, red, parity, s);
      pmp = s[0];
      dmx = s[1];
      cost0 = s[6];
      const float alpha = 0.f;
      d1 = alpha * pmp + dmx + s[2] - s[3];
      d2 = fmaxf(pmp + s[4] + s[5], kEps);
    }
    STAMP(11);
    float alpha = fmaxf(-d1 / d2, 0.f), lo = 0.f, hi = FLT_MAX;
    for (int ls = 0; ls < ls_iterations; ++ls) {
      float s[4];
      ordered_sums(items, [&](int t, float(&v)[4]) { env.phi_item(jar, jp, alpha, t, v); },
                   red, parity, s);
      d1 = alpha * pmp + dmx + s[0] - s[1];
      d2 = fmaxf(pmp + s[2] + s[3], kEps);
      if (d1 < 0.f) {
        lo = fmaxf(lo, alpha);
      } else {
        hi = fminf(hi, alpha);
      }
      const float newton = alpha - d1 / d2;
      const float fallback = hi < FLT_MAX ? 0.5f * (lo + hi) : 2.f * alpha + 1e-9f;
      alpha = newton > lo && newton < hi ? newton : fallback;
    }
    STAMP(12);
    {  // never take a step that does not lower phi
      float c[1];
      ordered_sums(items, [&](int t, float(&v)[1]) { env.cost_item(jar, jp, alpha, t, v[0]); },
                   red, parity, c);
      const float dphi = 0.5f * alpha * alpha * pmp + alpha * dmx + c[0] - cost0;
      alpha = dphi < 0.f ? alpha : 0.f;
    }
    alpha *= imp;
    for (int i = tid; i < n; i += NT) {
      x[i] += alpha * p[i];
      v0[i] = x[i] - smooth[i];
    }
    __syncthreads();
    STAMP(13);
    // jar and M (x - smooth) afresh from x, not by increments; the force of
    // each item
    if constexpr (kDense) {  // the rows' forces once every row's jar is in
      row_walk(true, false, [&](int i) { mdx[i] = env.m_row(v0, nullptr, i); },
               [&](int r, const float* row) {
                 env.template j_row_at<false>(row, x, nullptr, aref, r, jar, nullptr);
               });
      __syncthreads();
      for (int k = tid; k < items; k += NT) env.force_item(jar, k, f);
    } else {
      for (int t = tid; t < n + items; t += NT) {
        if (t < n) {
          mdx[t] = env.m_row(v0, nullptr, t);
        } else {
          env.j_item(x, aref, t - n, jar);
          env.force_item(jar, t - n, f);
        }
      }
    }
    __syncthreads();
    STAMP(14);
    if constexpr (kDense) {  // new gradient
      jt_walk(mdx, v0);
    } else {
      for (int d = tid; d < n; d += NT) v0[d] = env.jt_col(f, mdx, d);
    }
    __syncthreads();
    STAMP(15);
    // the solo warp: the new preconditioned gradient, beta and p
    if (warp == solo) {
      warp_exact_solve<true>(L, v0, v1, y, n);
      float s[3];
      warp_ordered_sums(n, [&](int i, float(&v)[3]) {
        v[0] += v0[i] * (v1[i] - mgrad[i]);
        v[1] += grad[i] * mgrad[i];
        v[2] += v0[i] * v0[i];
      }, s);
      const float beta = fmaxf(0.f, s[0] / fmaxf(s[1], kEps));
      for (int i = lane; i < n; i += 32) p[i] = -v1[i] + beta * p[i];
      if (lane == 0) *flag = s[2];
    }
    float* t0 = grad;  // grad = v0, mgrad = v1; the old buffers are the next scratch
    grad = v0;
    v0 = t0;
    t0 = mgrad;
    mgrad = v1;
    v1 = t0;
    __syncthreads();
    imp = sqrtf(*flag) > tolscale ? imp : 0.f;
    STAMP(16);
  }

  // 5. force (f = force of jar since its last change), qfrc = J^T force
  // (dense: the last walk's, written to o_qfrc by this thread; the stream's
  // copies beyond it end); Euler: factor M + diag(hd), solve qacc_eff from
  // qfrc_smooth + qfrc
  if constexpr (kDense) asm volatile("cp.async.wait_all;\n" ::: "memory");
  for (int r = tid; r < e; r += NT) o_force[b * e + r] = f[r];
  for (int t = tid; t < lay.tiles / 4; t += NT)
    reinterpret_cast<float4*>(L_s)[t] = reinterpret_cast<const float4*>(M_s)[t];
  for (int d = tid; d < n; d += NT) {
    if constexpr (kDense) {
      v0[d] = o_qfrc[b * n + d];
    } else {
      v0[d] = env.jt_col(f, nullptr, d);
    }
    v1[d] = qfs[d] + v0[d];
    o_smooth[b * n + d] = smooth[d];
    o_qacc[b * n + d] = x[d];
    if constexpr (!kDense) o_qfrc[b * n + d] = v0[d];
  }
  if (!with_euler) return;  // the same for every thread of the CTA
  __syncthreads();
  for (int i = tid; i < n; i += NT) L_s[L.row_part(i) + L.col_part(i)] += hd[i];
  __syncthreads();
  STAMP(17);
  tiled_factor<NT>(L, n, solo);
  STAMP(18);
  if (warp == solo) {
    warp_exact_solve<true>(L, v1, mp, y, n);
    for (int i = lane; i < n; i += 32) o_eff[b * n + i] = mp[i];
  }
  STAMP(19);
}

}  // namespace

extern "C" long ell_cg_solve_smem_bytes(int n, int nl, int nc) {
  return (long)Layout(n, nl, nc).total * (long)sizeof(float);
}

extern "C" long ell_cg_solve_dense_smem_bytes(int n, int ns, int nc) {
  return (long)Layout(n, ns, nc, true).total * (long)sizeof(float);
}

namespace {

// info[0..3] = registers per thread, dynamic shared memory per CTA (bytes),
// resident CTAs per SM and threads per CTA (one env) of
// ell_cg_solve_kernel<kDense> with smem bytes of dynamic shared memory, as
// built.
template <bool kDense>
int kernel_info(long smem, int* info) {
  const auto kernel = ell_cg_solve_kernel<kDense>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, kThreads, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = attr.numRegs;
  info[1] = (int)smem;
  info[2] = ctas;
  info[3] = kThreads;
  return 0;
}

template <bool kDense>
int launch(const float* buf, const float* cdof, const float* fq, const float* sw, const float* ll,
           const float* mu, const float* j, const float* aref, const float* D,
           const float* qfrc_smooth, const float* warm, const float* hd, const float* tolscale,
           const float* anc, const float* arm, const float* dm, const float* lim1h,
           float* qacc_smooth, float* qacc, float* qfrc_constraint, float* qacc_eff,
           float* efc_force, int batch, int n, int nl, int nc, int iterations, int ls_iterations,
           int with_euler, int arm_stride, void* stream) {
  if (batch <= 0 || n <= 0 || n > kMaxN || nl < 0 || nc < 0 || iterations < 0 ||
      ls_iterations < 0 || (kDense && nl + 3 * nc <= 0) || (with_euler && !qacc_eff) ||
      (arm_stride != 0 && arm_stride != n) || (long)batch * arm_stride > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const long smem = kDense ? ell_cg_solve_dense_smem_bytes(n, nl, nc) : ell_cg_solve_smem_bytes(n, nl, nc);
  const auto kernel = ell_cg_solve_kernel<kDense>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      buf, cdof, fq, sw, ll, mu, j, aref, D, qfrc_smooth, warm, hd, tolscale, anc, arm, dm, lim1h,
      qacc_smooth, qacc, qfrc_constraint, qacc_eff, efc_force, n, nl, nc, iterations, ls_iterations,
      with_euler, arm_stride);
  return (int)cudaGetLastError();
}

}  // namespace

// info[0..3] = registers per thread, dynamic shared memory per CTA (bytes),
// resident CTAs per SM and threads per CTA (one env) of ell_cg_solve at (n,
// nl, nc), as built.
extern "C" int ell_cg_solve_kernel_info(int n, int nl, int nc, int* info) {
  if (n <= 0 || n > kMaxN || nl < 0 || nc < 0) return (int)cudaErrorInvalidValue;
  return kernel_info<false>(ell_cg_solve_smem_bytes(n, nl, nc), info);
}

// The same for ell_cg_solve_dense at n, ns scalar rows and nc cone blocks.
extern "C" int ell_cg_solve_dense_kernel_info(int n, int ns, int nc, int* info) {
  if (n <= 0 || n > kMaxN || ns < 0 || nc < 0 || ns + 3 * nc <= 0) return (int)cudaErrorInvalidValue;
  return kernel_info<true>(ell_cg_solve_dense_smem_bytes(n, ns, nc), info);
}

// out[0..2] = rows per panel, panels per pass and 1 if J is copied once,
// whole, of ell_cg_solve_dense's walks over J (j_panels.cuh) at n, ns and nc.
extern "C" int ell_cg_solve_dense_panels(int n, int ns, int nc, int* out) {
  if (n <= 0 || n > kMaxN || ns < 0 || nc < 0 || ns + 3 * nc <= 0) return (int)cudaErrorInvalidValue;
  const JPanels p(n, ns + 3 * nc, ns, kJRingFloats);
  out[0] = p.rows;
  out[1] = p.np;
  out[2] = p.resident;
  return 0;
}

// out[0..kStamps) = the phase stamps' cycles summed over every CTA since the
// last call, then cleared (cudaErrorInvalidDeviceFunction in a build
// without CG_SOLVE_STAMPS).
extern "C" int ell_cg_solve_stamps(unsigned long long* out) {
#ifdef CG_SOLVE_STAMPS
  cudaError_t err = cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[kStamps] = {};
  return (int)cudaMemcpyToSymbol(g_stamps, zero, sizeof(g_stamps));
#else
  (void)out;
  return (int)cudaErrorInvalidDeviceFunction;
#endif
}

extern "C" int ell_cg_solve_f32(const float* buf, const float* cdof, const float* fq,
                                const float* sw, const float* ll, const float* mu,
                                const float* aref, const float* D, const float* qfrc_smooth,
                                const float* warm, const float* hd, const float* tolscale,
                                const float* anc, const float* arm, const float* dm,
                                const float* lim1h, float* qacc_smooth, float* qacc,
                                float* qfrc_constraint, float* qacc_eff, float* efc_force,
                                int batch, int n, int nl, int nc, int iterations,
                                int ls_iterations, int with_euler, int arm_stride,
                                void* stream) {
  return launch<false>(buf, cdof, fq, sw, ll, mu, nullptr, aref, D, qfrc_smooth, warm, hd,
                       tolscale, anc, arm, dm, lim1h, qacc_smooth, qacc, qfrc_constraint,
                       qacc_eff, efc_force, batch, n, nl, nc, iterations, ls_iterations,
                       with_euler, arm_stride, stream);
}

// The dense mode: J [batch][ns + 3 nc][n], its first ns rows the scalar rows;
// no compact operands.
extern "C" int ell_cg_solve_dense_f32(const float* buf, const float* cdof, const float* j,
                                      const float* aref, const float* D, const float* mu,
                                      const float* qfrc_smooth, const float* warm, const float* hd,
                                      const float* tolscale, const float* anc, const float* arm,
                                      float* qacc_smooth, float* qacc, float* qfrc_constraint,
                                      float* qacc_eff, float* efc_force, int batch, int n, int ns,
                                      int nc, int iterations, int ls_iterations, int with_euler,
                                      int arm_stride, void* stream) {
  return launch<true>(buf, cdof, nullptr, nullptr, nullptr, mu, j, aref, D, qfrc_smooth, warm, hd,
                      tolscale, anc, arm, nullptr, nullptr, qacc_smooth, qacc, qfrc_constraint,
                      qacc_eff, efc_force, batch, n, ns, nc, iterations, ls_iterations, with_euler,
                      arm_stride, stream);
}
