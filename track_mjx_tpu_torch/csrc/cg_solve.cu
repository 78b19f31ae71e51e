// Fused smooth + CG + Euler constraint solve, one env per CTA, for sm_90a.
//
// Replaces the TPU kernel track_mjx_tpu/ops/cg_solver_kernel.py::_cg_kernel
// (launched through _cg_solve_tpu) in its production configuration: qM built
// from the CRB factors, J built from the compact per-contact operands, Euler
// implicit-damping solve fused. The plain PyTorch version of the same
// computation is ops/cg_solver_kernel.py::cg_solve_plain.
//
// What bounds it on Hopper: each env's chain of dependent steps, not bytes
// (about 12 KB in and out per env) or operations (about 1 MFLOP per env,
// 0.06 ms for 4096 envs at 67 TFLOP/s; the products are matrix-vector
// products, so tensor cores have nothing to do). An env runs 2 Cholesky
// factorizations, iterations + 3 (L L^T)^-1 applies, an M, J and J^T
// product per iteration and ls_iterations + 1 linesearch reductions. The
// first design (a dense 256-thread CTA per env, 104 KB of shared memory, 2
// CTAs per SM) paid about 870 CTA barriers per env for them.
//
// The design, for n <= 128 (the TPU kernels' documented range), keeps the
// first design's float32 operations and their order, so that its outputs
// are the first design's bit for bit:
// - Every per-env operand, and the static lim1h, is copied into shared
//   memory with cp.async, all copies in flight at once.
// - qM and both factors live in the lower-triangle 4x4 tiles of
//   tiled_cholesky.cuh (12.4 KB each at n = 73). qM is assembled straight
//   into them by tile rows (the diagonal tiles whole); M v reads M(max(i,
//   j), min(i, j)) in increasing j, the row-major read's values in its order.
// - Both factorizations (qM; M + diag(hd) for Euler) are the standalone
//   cholesky kernel's tiled factor: `factor`'s arithmetic, one barrier per
//   panel of 8.
// - J is compact: a limit row is its dof and its value lim1h ll (lim1h's
//   rows are one-hot; a row with two nonzeros makes the env's J NaN), a
//   contact its three frame rows jfr (26 KB at the rodent's 30 contacts);
//   the pyramid rows j0 +- m j1, j0 +- m j2 are formed inside each product
//   by the dense build's expression. J x skips nothing; J^T f adds each
//   dof's limit rows through a per-dof list in row order, then the contact
//   rows in order: the dense sums less their zero terms, which were exact.
// - The (L L^T)^-1 applies run on one warp (warp_pinv_solve) with no CTA
//   barrier, their 8x8 panel steps on shuffles. That warp, which also
//   factors the panels, is another one in consecutive CTAs, so that the
//   resident CTAs' serial phases do not all queue on one scheduler.
// - Every reduction keeps the first design's order (ordered_sums): each warp
//   sums its share of the first design's 32-row blocks by the same
//   butterfly, the block sums meet in a double-buffered shared array behind
//   one barrier, and every thread adds them in order. A CG iteration pays 12
//   CTA barriers (the first design about 60).
// - 128 threads per env (kThreads; 64 and 256 measured slower): the M rows
//   and the contact rows of a product go one per thread. About 62 KB of
//   shared memory per env at the rodent's sizes (the kernel opts in above
//   48 KB) and 168 registers per thread each cap an SM at 3 CTAs.
// What is left (PERF.md, Findings): the panel solves' and the factors'
// chains and the linesearch's ls_iterations + 1 reductions per iteration.
// A fourth CTA per SM needs both at most 128 registers and at most 56 KB of
// shared memory (for instance jfr, 26 KB, recomputed in the products
// instead of stored).
//
// Two modes of the TPU kernel's that the compact layout cannot take:
// - the dense mode (cg_solve_dense_f32, kDense) replaces _cg_kernel with
//   jb_dims None: J is a dense [e][n] array per env, the rows of pyramidal
//   plans with condim-1, -4 or -6 contacts beside the limits (the rodent
//   with mixed condims: 228 rows, 66.6 KB). J stays in device memory and
//   every pass over it walks it in panels of rows through two slots of
//   shared memory (j_panels.cuh), the next panel's copy in flight: J x sums
//   each row in increasing d, J^T f each column in row order with its
//   partial sum carried across panels, as over a resident J, so the
//   outputs are the first dense design's bit for bit. J x walks run
//   backward and J^T f walks forward, so that each starts on the two
//   panels the last one ended on. Everything else is the compact mode's
//   code, but for two passes saved: J of the warm start and of the smooth
//   start are taken in one walk after the smooth solve, and qfrc is the J^T
//   f of the last CG pass (the force has not changed since). A dense J in
//   shared memory (the first dense design) took 66.6 KB beside the CTA's
//   35.6 KB and held the SM to 2 CTAs; the slots' 40 KB (kJRingFloats: 70
//   rows of 73, 4 panels a pass at 228 rows) keep 3, as the compact mode
//   has, at 168 registers (kDenseMinCtas). Device memory is read once
//   (the resident CTAs' J, 26 MB, stays in L2) and each pass copies 2 of the
//   4 panels from L2. What it costs beside the compact mode's chain: a J x
//   pass is 4 rows in series per thread where a resident J took 3 (rows and
//   M rows over 128 threads), 6 more CTA barriers a CG iteration (12 before),
//   and the waits for copies asked for one step ahead (PERF.md, Findings).
//   A model whose J fits in 2 panels is copied once, whole, and walked
//   without a barrier; the rows' vectors grow with e, so a model over 227
//   KB (about 8,000 rows at n = 73) is refused by the wrapper.
// - with_euler = 0 (plans on RK4 or an implicit integrator, as the TPU
//   kernel's hd=None): no factor of M + diag(hd), no qacc_eff.
//
// C interface (bound with ctypes): cg_solve_f32 and cg_solve_dense_f32
// launch on the given stream and return cudaGetLastError()
// (cudaErrorInvalidValue for n > 128); cg_solve_smem_bytes and
// cg_solve_dense_smem_bytes give the dynamic shared memory one CTA needs;
// cg_solve_kernel_info and cg_solve_dense_kernel_info its registers, shared
// memory, resident CTAs per SM and threads; cg_solve_dense_panels the
// panels of its walks over J; cg_solve_stamps the phase stamps of a build
// with CG_SOLVE_STAMPS.

#include <climits>

#include <cuda_runtime.h>

#include "cholesky.cuh"
#include "j_panels.cuh"
#include "tiled_cholesky.cuh"

namespace {

constexpr int kThreads = 128;
// The dense mode: J's two slots in shared memory, at most 40 KB, and the
// resident CTAs per SM asked of the register allocator (168 registers a
// thread; cg_solve_dense_kernel, below).
constexpr int kJRingFloats = 10240;
constexpr int kDenseMinCtas = 3;
static_assert(kThreads >= kMaxN, "a J^T f walk keeps one column per thread");

__host__ __device__ inline int up4(int k) { return (k + 3) & ~3; }

// The reductions keep the first design's order (ordered_sums, below): 256
// threads in 8 warps.
constexpr int kOrderThreads = 256;
constexpr int kOrderWarps = kOrderThreads / 32;

// Phase stamps, for tools/compare_torch_kernels.py: a build with
// CG_SOLVE_STAMPS adds the clock64() cycles of the solo warp's (below) first
// thread since the last stamp to g_stamps[k] at each stamp (a CG
// iteration's phases add up over its iterations); cg_solve_stamps reads and
// clears them. Other builds stamp nothing.
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
// tiles (before the factor, the staged per-env operands: buf, cdof, sw, fq);
// the panel inverses; jfr (before it, a copy of lim1h); 5 row vectors; the
// limit-row tables; mu; 10 dof vectors; the reductions' two buffers. The
// dense mode (e_dense >= 0 rows of a dense J, nl = nc = 0) keeps J's slots
// (j_panels.cuh) where jfr lies and stages only buf and cdof.
struct Layout {
  int tiles, lreg, dinv, jfr, js, rows, lim, dofs, total;
  __host__ __device__ Layout(int n, int nl, int nc, int e_dense = -1) {
    const bool dense = e_dense >= 0;
    const int e = dense ? e_dense : nl + 4 * nc;
    tiles = (int)tiles_floats(n);
    lreg = max(tiles, up4(dense ? 12 * n : 18 * n + 18 * nc));
    dinv = up4(((n + kPanel - 1) / kPanel) * kPanel * kPanel);
    js = n | 1;  // odd: neighbouring contacts' rows in distinct banks
    jfr = dense ? JPanels(n, e, e, kJRingFloats).floats()
                : up4(max(3 * nc * js, nl * n));  // lim1h's copy before jfr
    rows = up4(e);
    lim = up4(nl);
    dofs = up4(n);
    total = tiles + lreg + dinv + jfr + 5 * rows + 3 * lim + dofs + up4(2 * nc) + 10 * dofs +
            2 * kOrderWarps * 4;
  }
};

__device__ __forceinline__ float force_of(float jar, float d) {
  return jar < 0.f ? -d * jar : 0.f;
}

// Sums over count rows in the first design's order: 256 threads, thread t
// summing rows t, t + 256, ... one term at a time, each warp's 32 partials
// summed by the shuffle butterfly, then the 8 warps' sums in order. Here
// warp w plays the first design's warps w, w + W, ... (lane l as its thread
// 32 w + l); their sums go through red, one of two buffers of 8 K floats
// taken in turn (`parity`), so that one barrier suffices: a buffer is
// written again only two reductions later, after every thread has passed
// the barrier that follows its reads. Every thread gets the same bits.
// term(r, v) adds row r's K terms to v. Every thread of the CTA calls it.
template <int K, typename Term>
__device__ __forceinline__ void ordered_sums(int count, Term term, float* red, int& parity,
                                             float (&out)[K]) {
  constexpr int W = kThreads / 32, per_warp = (kOrderWarps + W - 1) / W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* buf = red + parity * kOrderWarps * K;
  float v[per_warp][K];  // this warp's blocks, their butterflies interleaved
#pragma unroll
  for (int q = 0; q < per_warp; ++q) {
    const int w = warp + q * W;
#pragma unroll
    for (int k = 0; k < K; ++k) v[q][k] = 0.f;
    if (w < kOrderWarps)
      for (int r = 32 * w + lane; r < count; r += kOrderThreads) term(r, v[q]);
  }
#pragma unroll
  for (int q = 0; q < per_warp; ++q) {
    const int w = warp + q * W;
    if (w < kOrderWarps && 32 * w < count) {
#pragma unroll
      for (int k = 0; k < K; ++k) v[q][k] = warp_sum(v[q][k]);
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < K; ++k) buf[w * K + k] = v[q][k];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) out[k] = 0.f;
#pragma unroll
  for (int w = 0; w < kOrderWarps; ++w) {
    if (32 * w < count) {
#pragma unroll
      for (int k = 0; k < K; ++k) out[k] += buf[w * K + k];
    }
  }
  parity ^= 1;
}

// (M (v - sub))[i] (sub may be null): M(max(i, j), min(i, j)) in
// increasing j, row i's tiles left of the diagonal as 128-bit reads.
__device__ __forceinline__ float m_row_of(const Tiles& M, int n, const float* v, const float* sub, int i) {
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

// One env's operands in shared memory, J compact.
struct Env {
  Tiles M;
  const float* jfr;  // [nc][3][js]: jfr0, jfr1, jfr2 of each contact
  const float* mu;   // [nc][2]
  const int* ldof;   // limit row -> its dof
  const float* lval; // limit row -> its J value
  const int* lnext;  // limit row -> the next limit row at its dof, or -1
  const int* lfirst; // dof -> its first limit row, or -1
  int n, nl, nc, js;

  __device__ float m_row(const float* v, const float* sub, int i) const {
    return m_row_of(M, n, v, sub, i);
  }

  // (J x)[r] - sub[r] (sub may be null), rows in efc order.
  __device__ float j_row(const float* x, const float* sub, int r) const {
    float s = 0.f;
    if (r < nl) {
      s += lval[r] * x[ldof[r]];
    } else {
      const int c = (r - nl) >> 2, q = (r - nl) & 3, k = 1 + (q >> 1);
      const float m = (q & 1) ? -mu[2 * c + k - 1] : mu[2 * c + k - 1];
      const float* j0 = jfr + 3 * c * js;
      const float* jk = j0 + k * js;
      for (int d = 0; d < n; ++d) s += (j0[d] + m * jk[d]) * x[d];
    }
    return sub ? s - sub[r] : s;
  }

  // base[d] - (J^T f)[d] (base may be null: (J^T f)[d]): d's limit rows in
  // row order, then every contact's four rows in order.
  __device__ float jt_col(const float* f, const float* base, int d) const {
    float s = 0.f;
    for (int r = lfirst[d]; r >= 0; r = lnext[r]) s += lval[r] * f[r];
    for (int c = 0; c < nc; ++c) {
      const float* j0 = jfr + 3 * c * js + d;
      const float a = j0[0], b1 = j0[js], b2 = j0[2 * js];
      const float m0 = mu[2 * c], m1 = mu[2 * c + 1];
      const float* fr = f + nl + 4 * c;
      s += (a + m0 * b1) * fr[0];
      s += (a - m0 * b1) * fr[1];
      s += (a + m1 * b2) * fr[2];
      s += (a - m1 * b2) * fr[3];
    }
    return base ? base[d] - s : s;
  }
};

// One env's operands in shared memory, J dense: walked in panels
// (j_panels.cuh), each row summed by row_dot.
struct DenseEnv {
  Tiles M;
  int n;

  __device__ float m_row(const float* v, const float* sub, int i) const {
    return m_row_of(M, n, v, sub, i);
  }
};

// sum_d row[d] x[d], d in increasing order (and the same of x2 in the same
// loop, where kTwo).
template <bool kTwo>
__device__ __forceinline__ void row_dot(const float* row, const float* x, const float* x2, int n,
                                        float& s, float& s2) {
  s = 0.f;
  s2 = 0.f;
  for (int d = 0; d < n; ++d) {
    s += row[d] * x[d];
    if constexpr (kTwo) s2 += row[d] * x2[d];
  }
}

// The kernels' parameters, and their names as arguments.
#define CG_SOLVE_PARAMS                                                                          \
  const float *__restrict__ g_buf, const float *__restrict__ g_cdof,                             \
      const float *__restrict__ g_fq, const float *__restrict__ g_sw,                            \
      const float *__restrict__ g_ll, const float *__restrict__ g_mu,                            \
      const float *__restrict__ g_j, const float *__restrict__ g_aref,                           \
      const float *__restrict__ g_D, const float *__restrict__ g_qfs,                            \
      const float *__restrict__ g_warm, const float *__restrict__ g_hd,                          \
      const float *__restrict__ g_tolscale, const float *__restrict__ anc,                       \
      const float *__restrict__ arm, const float *__restrict__ dm,                               \
      const float *__restrict__ lim1h, float *__restrict__ o_smooth,                             \
      float *__restrict__ o_qacc, float *__restrict__ o_qfrc, float *__restrict__ o_eff,         \
      float *__restrict__ o_force, int n, int nl, int nc, int e_dense, int iterations,           \
      int ls_iterations, int with_euler, int arm_stride
#define CG_SOLVE_ARGS                                                                            \
  g_buf, g_cdof, g_fq, g_sw, g_ll, g_mu, g_j, g_aref, g_D, g_qfs, g_warm, g_hd, g_tolscale, anc, \
      arm, dm, lim1h, o_smooth, o_qacc, o_qfrc, o_eff, o_force, n, nl, nc, e_dense, iterations,  \
      ls_iterations, with_euler, arm_stride

// One env's solve, the body of both kernels below. kDense: J is g_j
// [B][e_dense][n] (the compact operands fq, sw, ll, mu, dm and lim1h are not
// read, nl = nc = 0); else J is built from them. with_euler = 0 skips the
// factor of M + diag(hd) and o_eff.
template <bool kDense>
__device__ __forceinline__ void cg_solve_body(CG_SOLVE_PARAMS) {
  constexpr int NT = kThreads;
  extern __shared__ __align__(16) float smem[];
  const Layout lay = kDense ? Layout(n, 0, 0, e_dense) : Layout(n, nl, nc);
  const int e = kDense ? e_dense : nl + 4 * nc;
  const long b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // The warp that runs the serial phases (panels, solves, linesearch): one
  // per CTA in turn, so that the resident CTAs' solo warps do not all land
  // on one scheduler of the SM.
  const int solo = blockIdx.x % (NT / 32);
#ifdef CG_SOLVE_STAMPS
  long long stamp_last = clock64();
#endif

  float* M_s = smem;
  float* L_s = M_s + lay.tiles;
  float* dinv = L_s + lay.lreg;
  float* jfr = dinv + lay.dinv;
  float* aref = jfr + lay.jfr;
  float* Dr = aref + lay.rows;
  float* jar = Dr + lay.rows;
  float* jp = jar + lay.rows;
  float* f = jp + lay.rows;
  int* ldof = reinterpret_cast<int*>(f + lay.rows);
  float* lval = reinterpret_cast<float*>(ldof + lay.lim);
  int* lnext = reinterpret_cast<int*>(lval + lay.lim);
  int* lfirst = lnext + lay.lim;
  float* mu = reinterpret_cast<float*>(lfirst + lay.dofs);
  float* smooth = mu + up4(2 * nc);
  float* x = smooth + lay.dofs;
  float* p = x + lay.dofs;
  float* mp = p + lay.dofs;
  float* mdx = mp + lay.dofs;
  float* grad = mdx + lay.dofs;
  float* mgrad = grad + lay.dofs;
  float* v0 = mgrad + lay.dofs;
  float* v1 = v0 + lay.dofs;
  float* y = v1 + lay.dofs;  // the solves' scratch
  float* red = y + lay.dofs;
  int parity = 0;
  // staged per-env operands, in L's region until L = M
  float* s_buf = L_s;
  float* s_cdof = s_buf + 6 * n;
  float* s_sw = s_cdof + 6 * n;
  float* s_fq = s_sw + 6 * n;

  const auto env = [&]() {
    if constexpr (kDense) {
      return DenseEnv{Tiles(M_s, n), n};
    } else {
      return Env{Tiles(M_s, n), jfr, mu, ldof, lval, lnext, lfirst, n, nl, nc, lay.js};
    }
  }();
  const Tiles& M = env.M;
  const Tiles L(L_s, n);

  const float* qfs = g_qfs + b * n;
  const float* hd = g_hd + b * n;
  const float tolscale = g_tolscale[b];
  // the dense mode: J in device memory, its panels' stream (j_panels.cuh)
  const JPanels jpan(n, e, e, kJRingFloats);
  const float* gj = kDense ? g_j + b * e * n : nullptr;
  JPanels::Stream jst{};
  // The walks alternate: J x backward, J^T f forward, each starting on the
  // panel the last one ended on. J^T f of the dense walks: out[d] = base[d]
  // - (J^T f)[d], and (J^T f)[d] into o_qfrc (the last pass's is qfrc)
  const auto jt_walk = [&](const float* base, float* out) {
    float s = 0.f;
    jpan.walk<NT>(jfr, gj, jst, false, true, [&](int, int r0, int r1, const float* rows) {
      if (tid < n)
        for (int r = r0; r < r1; ++r) s += rows[(r - r0) * n + tid] * f[r];
    });
    if (tid < n) {
      out[tid] = base[tid] - s;
      o_qfrc[b * n + tid] = s;
    }
  };

  // 1. every per-env operand and lim1h into shared memory, all copies in
  // flight at once (ll into lval); dense: then J's first panel
  {
    auto copy = [&](float* dst, const float* src, int count) {
      for (int t = tid; t < count; t += NT) cp_async4(dst + t, src + t);
    };
    copy(aref, g_aref + b * e, e);
    copy(Dr, g_D + b * e, e);
    copy(x, g_warm + b * n, n);
    copy(s_buf, g_buf + b * 6 * n, 6 * n);
    copy(s_cdof, g_cdof + b * 6 * n, 6 * n);
    if constexpr (!kDense) {
      copy(mu, g_mu + b * 2 * nc, 2 * nc);
      copy(lval, g_ll + b * nl, nl);
      copy(s_sw, g_sw + b * 6 * n, 6 * n);
      copy(s_fq, g_fq + b * 18 * nc, 18 * nc);
      copy(jfr, lim1h, nl * n);
    }
    if constexpr (kDense) jst = jpan.start<NT>(jfr, gj, true);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  __syncthreads();
  STAMP(0);
  // limit rows: each one-hot row's dof and J value, a warp per row (nl = 0
  // in the dense mode)
  for (int r = warp; r < nl; r += NT / 32) {
    const float* row = jfr + r * n;
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
  __syncthreads();
  STAMP(1);
  // jfr[c][k][d] = (fq[c, k, :] . sw[d, :]) dm[c, d] (nc = 0 in the dense
  // mode)
  for (int t = tid; t < nc * n; t += NT) {
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
  // row order
  for (int t = tid; t < lay.tiles / 4; t += NT)
    reinterpret_cast<float4*>(L_s)[t] = reinterpret_cast<const float4*>(M_s)[t];
  for (int d = tid; d < n; d += NT) {
    int r1 = -1;
    for (int r = nl - 1; r >= 0; --r)
      if (ldof[r] == d) r1 = r;
    lfirst[d] = r1;
  }
  for (int r = tid; r < nl; r += NT) {
    int r1 = -1;
    for (int q = nl - 1; q > r; --q)
      if (ldof[q] == ldof[r]) r1 = q;
    lnext[r] = r1;
  }
  __syncthreads();
  STAMP(3);

  // 2. factor qM, its panel inverses; the solo warp solves qacc_smooth
  // while the others take jar of the warm start (dense: in step 3's walk)
  tiled_factor<NT>(L, n, solo);
  STAMP(4);
  invert_diag_blocks<NT>(L, dinv, n);
  __syncthreads();
  STAMP(5);
  if (warp == solo) {
    warp_pinv_solve(L, dinv, qfs, smooth, y, n);
  } else if constexpr (!kDense) {
    const int other = ((warp - solo - 1 + NT / 32) % (NT / 32)) * 32 + lane;
    for (int r = other; r < e; r += NT - 32) jar[r] = env.j_row(x, aref, r);
  }
  __syncthreads();
  STAMP(6);

  // 3. warm start vs smooth start, the cheaper per env; cost(smooth) has no
  // quadratic term. mdx = M (warm - smooth), jp = jar of smooth.
  if constexpr (kDense) {  // jar and jp of each row at once
    jpan.walk<NT>(jfr, gj, jst, true, false, [&](int k, int r0, int r1, const float* rows) {
      const int2 mr = jpan.m_rows(k);
      const int m = mr.y - mr.x;
      for (int t = tid; t < m + r1 - r0; t += NT) {
        if (t < m) {
          mdx[mr.x + t] = env.m_row(x, smooth, mr.x + t);
        } else {
          const int r = r0 + t - m;
          float sx, ss;
          row_dot<true>(rows + (t - m) * n, x, smooth, n, sx, ss);
          jar[r] = sx - aref[r];
          jp[r] = ss - aref[r];
        }
      }
    });
  } else {
    for (int t = tid; t < n + e; t += NT) {
      if (t < n) {
        mdx[t] = env.m_row(x, smooth, t);
      } else {
        jp[t - n] = env.j_row(smooth, aref, t - n);
      }
    }
  }
  __syncthreads();
  STAMP(7);
  {
    float s[3];
    ordered_sums(max(n, e), [&](int r, float(&v)[3]) {
      if (r < n) v[0] += (x[r] - smooth[r]) * mdx[r];
      if (r < e) {
        if (jar[r] < 0.f) v[1] += Dr[r] * jar[r] * jar[r];
        if (jp[r] < 0.f) v[2] += Dr[r] * jp[r] * jp[r];
      }
    }, red, parity, s);
    const bool take_warm = 0.5f * s[0] + 0.5f * s[1] < 0.5f * s[2];
    if (!take_warm) {
      for (int i = tid; i < n; i += NT) {
        x[i] = smooth[i];
        mdx[i] = 0.f;
      }
    }
    for (int r = tid; r < e; r += NT) {
      if (!take_warm) jar[r] = jp[r];
      f[r] = force_of(jar[r], Dr[r]);
    }
  }
  __syncthreads();
  STAMP(8);
  // grad = M dx - J^T force; mgrad = (L L^T)^-1 grad; p = -mgrad
  if constexpr (kDense) {
    jt_walk(mdx, grad);
  } else {
    for (int d = tid; d < n; d += NT) grad[d] = env.jt_col(f, mdx, d);
  }
  __syncthreads();
  STAMP(9);
  float imp = 1.f;
  if (warp == solo) {
    warp_pinv_solve(L, dinv, grad, mgrad, y, n);
    for (int i = lane; i < n; i += 32) p[i] = -mgrad[i];
  }
  __syncthreads();
  STAMP(10);

  // 4. PR-CG with Newton linesearch; converged envs take zero-length steps.
  for (int it = 0; it < iterations; ++it) {
    if constexpr (kDense) {
      jpan.walk<NT>(jfr, gj, jst, true, false, [&](int k, int r0, int r1, const float* rows) {
        const int2 mr = jpan.m_rows(k);
        const int m = mr.y - mr.x;
        for (int t = tid; t < m + r1 - r0; t += NT) {
          if (t < m) {
            mp[mr.x + t] = env.m_row(p, nullptr, mr.x + t);
          } else {
            float s, unused;
            row_dot<false>(rows + (t - m) * n, p, nullptr, n, s, unused);
            jp[r0 + t - m] = s;
          }
        }
      });
    } else {
      for (int t = tid; t < n + e; t += NT) {
        if (t < n) {
          mp[t] = env.m_row(p, nullptr, t);
        } else {
          jp[t - n] = env.j_row(p, nullptr, t - n);
        }
      }
    }
    __syncthreads();
    STAMP(11);
    float alpha = 0.f, pmp, dmx;
    for (int ls = 0; ls <= ls_iterations; ++ls) {
      // the first pass also takes p M p and M p . (x - smooth)
      float s[4];
      const int count = ls == 0 ? max(n, e) : e;
      ordered_sums(count, [&](int r, float(&v)[4]) {
        if (ls == 0 && r < n) {
          v[2] += p[r] * mp[r];
          v[3] += mp[r] * (x[r] - smooth[r]);
        }
        if (r < e) {
          const float jr = jar[r] + alpha * jp[r];
          if (jr < 0.f) {
            v[0] += Dr[r] * jr * jp[r];
            v[1] += Dr[r] * jp[r] * jp[r];
          }
        }
      }, red, parity, s);
      if (ls == 0) {
        pmp = s[2];
        dmx = s[3];
      }
      const float d1 = alpha * pmp + dmx + s[0];
      const float d2 = fmaxf(pmp + s[1], kEps);
      alpha = alpha - d1 / d2;
    }
    alpha *= imp;
    STAMP(12);
    for (int i = tid; i < n; i += NT) {
      x[i] += alpha * p[i];
      mdx[i] += alpha * mp[i];
    }
    for (int r = tid; r < e; r += NT) {
      jar[r] += alpha * jp[r];
      f[r] = force_of(jar[r], Dr[r]);
    }
    __syncthreads();
    STAMP(13);
    if constexpr (kDense) {  // new gradient
      jt_walk(mdx, v0);
    } else {
      for (int d = tid; d < n; d += NT) v0[d] = env.jt_col(f, mdx, d);
    }
    __syncthreads();
    STAMP(14);
    if (warp == solo) warp_pinv_solve(L, dinv, v0, v1, y, n);  // new preconditioned gradient
    __syncthreads();
    STAMP(15);
    float s[3];
    ordered_sums(n, [&](int i, float(&v)[3]) {
      v[0] += v0[i] * (v1[i] - mgrad[i]);
      v[1] += grad[i] * mgrad[i];
      v[2] += v0[i] * v0[i];
    }, red, parity, s);
    const float beta = fmaxf(0.f, s[0] / fmaxf(s[1], kEps));
    for (int i = tid; i < n; i += NT) p[i] = -v1[i] + beta * p[i];
    imp = sqrtf(s[2]) > tolscale ? imp : 0.f;
    float* t0 = grad;  // grad = v0, mgrad = v1; the old buffers are the next scratch
    grad = v0;
    v0 = t0;
    t0 = mgrad;
    mgrad = v1;
    v1 = t0;
    __syncthreads();
    STAMP(16);
  }

  // 5. force (f = force of jar since the last update), qfrc = J^T force
  // (dense: the last walk's, written to o_qfrc by this thread; the stream's
  // copies beyond it end); Euler: factor M + diag(hd), solve qacc_eff from
  // qfrc_smooth + qfrc
  if constexpr (kDense) asm volatile("cp.async.wait_all;\n" ::: "memory");
  for (int r = tid; r < e; r += NT) o_force[b * e + r] = f[r];
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
  for (int t = tid; t < lay.tiles / 4; t += NT)
    reinterpret_cast<float4*>(L_s)[t] = reinterpret_cast<const float4*>(M_s)[t];
  __syncthreads();
  for (int i = tid; i < n; i += NT) L_s[L.row_part(i) + L.col_part(i)] += hd[i];
  __syncthreads();
  STAMP(17);
  tiled_factor<NT>(L, n, solo);
  STAMP(18);
  invert_diag_blocks<NT>(L, dinv, n);
  __syncthreads();
  if (warp == solo) {
    warp_pinv_solve(L, dinv, v1, mp, y, n);
    for (int i = lane; i < n; i += 32) o_eff[b * n + i] = mp[i];
  }
  STAMP(19);
}

// The compact mode keeps ptxas's own register choice (168 registers, with
// 56 B of spills); the dense mode asks for kDenseMinCtas CTAs per SM of the
// register allocator. On an NVIDIA H100: left to ptxas, the dense mode
// spilled 92 B and ran 7% slower; asked of the compact mode, 3 CTAs ran
// 1.5% slower and 1 took 209 registers (2 CTAs per SM, 36% slower).
__global__ void __launch_bounds__(kThreads) cg_solve_kernel(CG_SOLVE_PARAMS) {
  cg_solve_body<false>(CG_SOLVE_ARGS);
}

__global__ void __launch_bounds__(kThreads, kDenseMinCtas) cg_solve_dense_kernel(CG_SOLVE_PARAMS) {
  cg_solve_body<true>(CG_SOLVE_ARGS);
}

#undef CG_SOLVE_PARAMS
#undef CG_SOLVE_ARGS

template <bool kDense>
constexpr auto kernel_of() {
  if constexpr (kDense) {
    return cg_solve_dense_kernel;
  } else {
    return cg_solve_kernel;
  }
}

}  // namespace

extern "C" long cg_solve_smem_bytes(int n, int nl, int nc) {
  return (long)Layout(n, nl, nc).total * (long)sizeof(float);
}

extern "C" long cg_solve_dense_smem_bytes(int n, int e) {
  return (long)Layout(n, 0, 0, e).total * (long)sizeof(float);
}

namespace {

// info[0..3] = registers per thread, dynamic shared memory per CTA (bytes),
// resident CTAs per SM and threads per CTA (one env) of the kDense mode's
// kernel with smem bytes of dynamic shared memory, as built.
template <bool kDense>
int kernel_info(long smem, int* info) {
  const auto kernel = kernel_of<kDense>();
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
           float* efc_force, int batch, int n, int nl, int nc, int e_dense, int iterations,
           int ls_iterations, int with_euler, int arm_stride, void* stream) {
  if (batch <= 0 || n <= 0 || n > kMaxN || nl < 0 || nc < 0 || iterations < 0 ||
      ls_iterations < 0 || (kDense && e_dense <= 0) || (with_euler && !qacc_eff) ||
      (arm_stride != 0 && arm_stride != n) || (long)batch * arm_stride > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const long smem = kDense ? cg_solve_dense_smem_bytes(n, e_dense) : cg_solve_smem_bytes(n, nl, nc);
  const auto kernel = kernel_of<kDense>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      buf, cdof, fq, sw, ll, mu, j, aref, D, qfrc_smooth, warm, hd, tolscale, anc, arm, dm,
      lim1h, qacc_smooth, qacc, qfrc_constraint, qacc_eff, efc_force, n, nl, nc, e_dense,
      iterations, ls_iterations, with_euler, arm_stride);
  return (int)cudaGetLastError();
}

}  // namespace

// info[0..3] = registers per thread, dynamic shared memory per CTA (bytes),
// resident CTAs per SM and threads per CTA (one env) of cg_solve at (n, nl,
// nc), as built.
extern "C" int cg_solve_kernel_info(int n, int nl, int nc, int* info) {
  if (n <= 0 || n > kMaxN || nl < 0 || nc < 0) return (int)cudaErrorInvalidValue;
  return kernel_info<false>(cg_solve_smem_bytes(n, nl, nc), info);
}

// The same for cg_solve_dense at n and e rows.
extern "C" int cg_solve_dense_kernel_info(int n, int e, int* info) {
  if (n <= 0 || n > kMaxN || e <= 0) return (int)cudaErrorInvalidValue;
  return kernel_info<true>(cg_solve_dense_smem_bytes(n, e), info);
}

// out[0..2] = rows per panel, panels per pass and 1 if J is copied once,
// whole, of cg_solve_dense's walks over J (j_panels.cuh) at n and e rows.
extern "C" int cg_solve_dense_panels(int n, int e, int* out) {
  if (n <= 0 || n > kMaxN || e <= 0) return (int)cudaErrorInvalidValue;
  const JPanels p(n, e, e, kJRingFloats);
  out[0] = p.rows;
  out[1] = p.np;
  out[2] = p.resident;
  return 0;
}

// out[0..kStamps) = the phase stamps' cycles summed over every CTA since the
// last call, then cleared (cudaErrorInvalidDeviceFunction in a build
// without CG_SOLVE_STAMPS).
extern "C" int cg_solve_stamps(unsigned long long* out) {
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

extern "C" int cg_solve_f32(const float* buf, const float* cdof, const float* fq,
                            const float* sw, const float* ll, const float* mu,
                            const float* aref, const float* D, const float* qfrc_smooth,
                            const float* warm, const float* hd, const float* tolscale,
                            const float* anc, const float* arm, const float* dm,
                            const float* lim1h, float* qacc_smooth, float* qacc,
                            float* qfrc_constraint, float* qacc_eff, float* efc_force,
                            int batch, int n, int nl, int nc, int iterations,
                            int ls_iterations, int with_euler, int arm_stride, void* stream) {
  return launch<false>(buf, cdof, fq, sw, ll, mu, nullptr, aref, D, qfrc_smooth, warm, hd,
                       tolscale, anc, arm, dm, lim1h, qacc_smooth, qacc, qfrc_constraint,
                       qacc_eff, efc_force, batch, n, nl, nc, -1, iterations, ls_iterations,
                       with_euler, arm_stride, stream);
}

// The dense mode: J [batch][e][n], no compact operands.
extern "C" int cg_solve_dense_f32(const float* buf, const float* cdof, const float* j,
                                  const float* aref, const float* D, const float* qfrc_smooth,
                                  const float* warm, const float* hd, const float* tolscale,
                                  const float* anc, const float* arm, float* qacc_smooth,
                                  float* qacc, float* qfrc_constraint, float* qacc_eff,
                                  float* efc_force, int batch, int n, int e, int iterations,
                                  int ls_iterations, int with_euler, int arm_stride,
                                  void* stream) {
  return launch<true>(buf, cdof, nullptr, nullptr, nullptr, nullptr, j, aref, D, qfrc_smooth,
                      warm, hd, tolscale, anc, arm, nullptr, nullptr, qacc_smooth, qacc,
                      qfrc_constraint, qacc_eff, efc_force, batch, n, 0, 0, e, iterations,
                      ls_iterations, with_euler, arm_stride, stream);
}
