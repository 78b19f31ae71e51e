// The tiled Cholesky factor and the solves on its layout, for one env per
// CTA (or per warp) with the matrix in shared memory, n <= kMaxN.
//
// Shared by the standalone cholesky, cho_solve and solve_spd kernels
// (batched_linalg.cu) and the fused CG solves (cg_solve.cu,
// ell_cg_solve.cu). They port the device routines of
// track_mjx_tpu/ops/batched_linalg.py that the TPU kernels run inside
// themselves: factor_in_place (`tiled_factor`), invert_diag_blocks
// (`invert_diag_blocks`), blocked_substitution_pinv (`warp_pinv_solve`) and
// blocked_substitution (`warp_exact_solve`). The plain PyTorch versions are
// ops/batched_linalg.py's factor, invert_diag_blocks,
// blocked_substitution_pinv and blocked_substitution.
//
// - Tiles: only the lower triangle, as 4x4 tiles ordered by tile column from
//   the last, so that the tiles right of any panel are a prefix; row r of
//   every tile lies in plane r, so that rows 0..3 of a tile fall in distinct
//   bank quads and row r of consecutive tiles is consecutive.
// - tiled_factor: a blocked right-looking factor in panels of 8 columns.
//   One warp factors a panel in registers (lane l holds rows p0 + l + 32 q),
//   pivots and columns broadcast by shuffles; the other warps update the
//   trailing lower triangle one 4x4 tile at a time in registers, while that
//   warp updates the next panel's tiles and factors it (lookahead). One CTA
//   barrier per panel. Each entry receives `factor`'s float32 operations in
//   `factor`'s order (pivot rsqrtf, column scaled by multiplication, updates
//   L_ik -= L_ij L_kj one multiply-add at a time in increasing j), so L is
//   the same bit for bit whatever the thread count; tests/test_torch_linalg.py
//   mirrors the schedule in torch and holds it bit for bit against `factor`.
// - warp_pinv_solve: L L^T x = b through the inverses of L's 8x8 diagonal
//   panels, by one warp alone, with no CTA barrier: each panel's 8x8 apply on 8
//   lanes with the panel's values broadcast by shuffles, the update of the
//   remaining right-hand side over the warp. tests/test_torch_cg_kernel.py
//   mirrors it.
// - warp_exact_solve: L L^T x = b by exact panel substitution (no panel
//   inverses), by one warp alone, with no CTA barrier: cholesky.cuh's
//   lower_substitution entry for entry, read through the tiles.
//   tests/test_torch_ell_kernel.py mirrors it and holds it bit for bit
//   against blocked_substitution with its sums taken one term at a time.

#pragma once

#include <cuda_runtime.h>

#include "cholesky.cuh"

namespace {

constexpr int kMaxN = 128;            // the TPU kernels' documented range
constexpr int kLaneRows = kMaxN / 32;  // panel rows per lane of warp 0
constexpr int kTiledPanel = 8;         // the tiled factor's panel width

__host__ __device__ __forceinline__ int tri(int c) { return c * (c + 1) / 2; }

// Floats of one plane (below): 4 per tile, rounded up to 8 mod 32 so that
// rows 0..3 of a tile fall in distinct bank quads.
__host__ __device__ inline int plane_floats(int n) {
  const int p = 4 * tri((n + 3) / 4);
  return p + ((8 - p) & 31);
}
__host__ __device__ inline long tiles_floats(int n) { return 4L * plane_floats(n); }

// The lower triangle of an n x n matrix as 4x4 tiles in shared memory, nt =
// ceil(n / 4) tile rows. Tile (ti, tk), tk <= ti, has index tri(nt - 1 -
// tk) + (nt - 1 - ti), tri(c) = c (c + 1) / 2: ordered by tile column from
// the last, so the tiles right of any panel are a prefix, indices 0 ..
// tri(m) - 1 for their m columns. Row r of every tile lies in plane r, 4
// floats per tile: row r of consecutive tiles is consecutive, and entry
// (i, k) is at row_part(i) + col_part(k). L(i, k) reads it (the accessor
// lower_substitution takes).
struct Tiles {
  float* s;
  int nt, plane;
  __device__ Tiles(float* s_, int n) : s(s_), nt((n + 3) >> 2), plane(plane_floats(n)) {}
  __device__ __forceinline__ int index(int ti, int tk) const { return tri(nt - 1 - tk) + (nt - 1 - ti); }
  __device__ __forceinline__ float4& row(int idx, int r) const {
    return *reinterpret_cast<float4*>(s + r * plane + 4 * idx);
  }
  __device__ __forceinline__ int row_part(int i) const { return (i & 3) * plane + 4 * (nt - 1 - (i >> 2)); }
  __device__ __forceinline__ int col_part(int k) const { return 4 * tri(nt - 1 - (k >> 2)) + (k & 3); }
  __device__ __forceinline__ float operator()(int i, int k) const { return s[row_part(i) + col_part(k)]; }
};

// One float from global to shared memory without a register: the copy
// runs on while the thread issues more; cp.async.wait_all ends them.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

// (c, t - tri(c)) for the largest c with tri(c) <= t: tile t's column and
// row counted from the last.
__device__ __forceinline__ int2 untri(int t) {
  int c = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  if (tri(c + 1) <= t) ++c;
  if (tri(c) > t) --c;
  return make_int2(c, t - tri(c));
}

// Warp 0: factors columns p0 .. p0 + P - 1 (those < n) of the rows >= p0.
// Entries above the diagonal are zero in registers and their tile slots
// are written with values nothing reads.
template <int P>
__device__ void factor_panel(const Tiles& L, int n, int p0) {
  const int lane = threadIdx.x & 31;
  float v[kLaneRows][P];
#pragma unroll
  for (int q = 0; q < kLaneRows; ++q) {
    const int i = p0 + lane + 32 * q;
#pragma unroll
    for (int c = 0; c < P; c += 4) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < n && i >= p0 + c) x = L.row(L.index(i >> 2, (p0 + c) >> 2), i & 3);
      v[q][c] = x.x;
      v[q][c + 1] = i >= p0 + c + 1 ? x.y : 0.f;
      v[q][c + 2] = i >= p0 + c + 2 ? x.z : 0.f;
      v[q][c + 3] = i >= p0 + c + 3 ? x.w : 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < P; ++j) {
    if (p0 + j < n) {
      // row p0 + k lives on lane k; its entry of column j is shuffled
      // unscaled, so the shuffles need not wait for the pivot, and scaled
      // on arrival: the same product as the scaled column
      const float rs = rsqrtf(__shfl_sync(0xffffffffu, v[0][j], j));
      float u[P];
#pragma unroll
      for (int k = j + 1; k < P; ++k) u[k] = __shfl_sync(0xffffffffu, v[0][j], k);
#pragma unroll
      for (int q = 0; q < kLaneRows; ++q) v[q][j] *= rs;
#pragma unroll
      for (int k = j + 1; k < P; ++k) {
        const float lkj = u[k] * rs;
#pragma unroll
        for (int q = 0; q < kLaneRows; ++q) v[q][k] -= v[q][j] * lkj;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kLaneRows; ++q) {
    const int i = p0 + lane + 32 * q;
#pragma unroll
    for (int c = 0; c < P; c += 4) {
      if (i < n && i >= p0 + c)
        L.row(L.index(i >> 2, (p0 + c) >> 2), i & 3) =
            make_float4(v[q][c], v[q][c + 1], v[q][c + 2], v[q][c + 3]);
    }
  }
}

// Applies the P columns of the panel at p0 to tiles first, first + stride,
// ... < end of those right of it (indices 0 .. tri(m) - 1 for its m tile
// columns), one 4x4 tile at a time in registers, columns in increasing
// order.
template <int P>
__device__ void update_tiles(const Tiles& L, int p0, int first, int end, int stride) {
  for (int t = first; t < end; t += stride) {
    const int2 ct = untri(t);  // the tile's index is t
    const int tk = L.nt - 1 - ct.x, ti = L.nt - 1 - ct.y;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 x = L.row(t, r);
      acc[r][0] = x.x, acc[r][1] = x.y, acc[r][2] = x.z, acc[r][3] = x.w;
    }
#pragma unroll
    for (int g = 0; g < P / 4; ++g) {
      const int tc = (p0 >> 2) + g;
      const int ia = L.index(ti, tc), ib = L.index(tk, tc);
      float a[4][4];  // L[4 ti + r][4 tc + jj]
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 x = L.row(ia, r);
        a[r][0] = x.x, a[r][1] = x.y, a[r][2] = x.z, a[r][3] = x.w;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4 x = L.row(ib, c);  // L[4 tk + c][4 tc + jj]
        const float b[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) acc[r][c] -= a[r][jj] * b[jj];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) L.row(t, r) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

// Factors the lower triangle held in L in place, with the CTA's NT threads
// (a multiple of 32, at least 64); warp `lead` factors the panels. The
// caller syncs before (the matrix is in place); the factor is visible to
// every thread on return.
template <int NT>
__device__ void tiled_factor(const Tiles& L, int n, int lead = 0) {
  constexpr int P = kTiledPanel, W = NT / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == lead) factor_panel<P>(L, n, 0);
  __syncthreads();
  // With lookahead: while the other warps apply the panel at p0 to the
  // tiles right of the next panel, the lead warp applies it to the next
  // panel's own tiles (the last indices, split on) and factors that panel.
  // Every entry still takes the panels in order; one barrier per panel.
  for (int p0 = 0; p0 < n; p0 += P) {
    const int m = L.nt - ((p0 + P) >> 2);  // tile columns right of the panel
    if (m <= 0) break;  // the last panel; else p0 + P < n, the next exists
    const int split = tri(max(m - P / 4, 0));
    if (warp == lead) {
      update_tiles<P>(L, p0, split + lane, tri(m), 32);
      __syncwarp();
      factor_panel<P>(L, n, p0 + P);
    } else {
      update_tiles<P>(L, p0, ((warp - lead - 1 + W) % W) * 32 + lane, split, NT - 32);
    }
    __syncthreads();
  }
}

// dinv[(p0 + r) * kPanel + c] = inv(L[p0:p0+m, p0:p0+m])[r][c] for every
// panel, through the accessor L(i, k) (lower triangle only); 8 lanes per
// panel, lane c solving column c by forward substitution. No barrier.
template <int NT, typename Mat>
__device__ void invert_diag_blocks(const Mat& L, float* dinv, int n) {
  const int group = threadIdx.x >> 3, c = threadIdx.x & 7;
  const int npan = (n + kPanel - 1) / kPanel;
  for (int pi = group; pi < npan; pi += NT / kPanel) {
    const int p0 = pi * kPanel, m = min(kPanel, n - p0);
    float x[kPanel];
#pragma unroll
    for (int r = 0; r < kPanel; ++r) {
      x[r] = 0.f;
      if (r < m) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < r; ++k) s += L(p0 + r, p0 + k) * x[k];
        x[r] = ((r == c ? 1.f : 0.f) - s) / L(p0 + r, p0 + r);
        dinv[(p0 + r) * kPanel + c] = c < m ? x[r] : 0.f;
      }
    }
  }
}

// One warp alone: solves L L^T x = b into out through the panel inverses dinv
// (invert_diag_blocks), with y as scratch, the arithmetic of
// blocked_substitution_pinv entry for entry: forward, y_p = inv(L_pp) r_p
// (s += dinv[r][c] r[c], c in order) and the rows below take r_i -= sum_c
// L_ic y_c (c in order); backward, x_p = inv(L_pp)^T y_p (r in order) and
// the rows above take y_i -= sum_r L_ri x_r. A whole panel's 8x8 step is
// unrolled: its 8 values broadcast by shuffles, dinv's row or column loaded
// at once. b (global or shared) must not alias out or y. The caller syncs
// before (b ready) and after (out ready).
__device__ void warp_pinv_solve(const Tiles& L, const float* dinv, const float* b, float* out,
                                float* y, int n) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, r8 = lane & 7;
  for (int i = lane; i < n; i += 32) out[i] = b[i];
  __syncwarp();
  for (int p0 = 0; p0 < n; p0 += kPanel) {  // forward: L y = b
    const int m = min(kPanel, n - p0);
    const float own = lane < m ? out[p0 + lane] : 0.f;
    const float* dr = dinv + (p0 + r8) * kPanel;  // row r8 (lanes >= m write nothing)
    float s = 0.f;
    if (m == kPanel) {
      const float4 da = *reinterpret_cast<const float4*>(dr);
      const float4 db = *reinterpret_cast<const float4*>(dr + 4);
      float o[kPanel];
#pragma unroll
      for (int c = 0; c < kPanel; ++c) o[c] = __shfl_sync(full, own, c);
      s += da.x * o[0];
      s += da.y * o[1];
      s += da.z * o[2];
      s += da.w * o[3];
      s += db.x * o[4];
      s += db.y * o[5];
      s += db.z * o[6];
      s += db.w * o[7];
    } else {
      for (int c = 0; c < m; ++c) {
        const float oc = __shfl_sync(full, own, c);
        s += dr[c] * oc;
      }
    }
    if (lane < m) y[p0 + lane] = s;
    __syncwarp();
    if (p0 + m < n) {  // a full panel: columns p0 .. p0 + 7 are two tile columns
      const float4 ya = *reinterpret_cast<const float4*>(y + p0);
      const float4 yb = *reinterpret_cast<const float4*>(y + p0 + 4);
      for (int i = p0 + m + lane; i < n; i += 32) {
        const float4 a = L.row(L.index(i >> 2, p0 >> 2), i & 3);
        const float4 c = L.row(L.index(i >> 2, (p0 >> 2) + 1), i & 3);
        float t = 0.f;
        t += a.x * ya.x;
        t += a.y * ya.y;
        t += a.z * ya.z;
        t += a.w * ya.w;
        t += c.x * yb.x;
        t += c.y * yb.y;
        t += c.z * yb.z;
        t += c.w * yb.w;
        out[i] -= t;
      }
    }
    __syncwarp();
  }
  for (int p0 = ((n - 1) / kPanel) * kPanel; p0 >= 0; p0 -= kPanel) {  // L^T x = y
    const int m = min(kPanel, n - p0);
    const float own = lane < m ? y[p0 + lane] : 0.f;
    const float* dc = dinv + p0 * kPanel + r8;  // column r8
    float s = 0.f;
    if (m == kPanel) {
      float yr[kPanel], d[kPanel];
#pragma unroll
      for (int r = 0; r < kPanel; ++r) {
        yr[r] = __shfl_sync(full, own, r);
        d[r] = dc[r * kPanel];
      }
#pragma unroll
      for (int r = 0; r < kPanel; ++r) s += d[r] * yr[r];
    } else {
      for (int r = 0; r < m; ++r) {
        const float yr = __shfl_sync(full, own, r);
        s += dc[r * kPanel] * yr;
      }
    }
    if (lane < m) out[p0 + lane] = s;
    __syncwarp();
    if (m == kPanel) {
      const float4 xa = *reinterpret_cast<const float4*>(out + p0);
      const float4 xb = *reinterpret_cast<const float4*>(out + p0 + 4);
      const float xv[kPanel] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      int rp[kPanel];
#pragma unroll
      for (int r = 0; r < kPanel; ++r) rp[r] = L.row_part(p0 + r);
      for (int i = lane; i < p0; i += 32) {
        const int cp = L.col_part(i);
        float t = 0.f;
#pragma unroll
        for (int r = 0; r < kPanel; ++r) t += L.s[rp[r] + cp] * xv[r];
        y[i] -= t;
      }
    } else {
      for (int i = lane; i < p0; i += 32) {
        const int cp = L.col_part(i);
        float t = 0.f;
        for (int r = 0; r < m; ++r) t += L.s[L.row_part(p0 + r) + cp] * out[p0 + r];
        y[i] -= t;
      }
    }
    __syncwarp();
  }
}

// The diagonal panel of L at p0 (m <= kPanel rows), as every lane reads it:
// a[r][k] = L(p0 + r, p0 + k) for k <= r < m, the panel's three tiles as
// 128-bit reads (entries above the diagonal are read and never used).
__device__ __forceinline__ void diag_panel(const Tiles& L, int p0, int m, float (&a)[kPanel][kPanel]) {
  const int tp = p0 >> 2;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float4 t = L.row(L.index(tp, tp), r);
    a[r][0] = t.x, a[r][1] = t.y, a[r][2] = t.z, a[r][3] = t.w;
    float4 u = make_float4(0.f, 0.f, 0.f, 0.f), w = u;
    if (m > 4) {
      u = L.row(L.index(tp + 1, tp), r);
      w = L.row(L.index(tp + 1, tp + 1), r);
    }
    a[4 + r][0] = u.x, a[4 + r][1] = u.y, a[4 + r][2] = u.z, a[4 + r][3] = u.w;
    a[4 + r][4] = w.x, a[4 + r][5] = w.y, a[4 + r][6] = w.z, a[4 + r][7] = w.w;
  }
}

// x / y for a positive (or NaN) y: a zero x gives x itself, as the division
// would (0 / y keeps x's sign), without dividing: a zero dividend leaves the
// division's fast path. A NaN, zero or negative y divides.
__device__ __forceinline__ float div_pos(float x, float y) {
  return x == 0.f && y > 0.f ? x : x / y;
}

// One warp alone: solves L L^T x = b into out by exact panel forward and
// back substitution, with y as scratch; the arithmetic of
// lower_substitution entry for entry. Forward, each panel's rows in turn,
// v_j = (r_j - s) / L_jj with s = sum_{k < j} L_jk v_k one multiply-add at
// a time in increasing k, then every row below takes r_i -= sum_c L_ic v_c
// (c in increasing order); backward, v_j = (y_j - s) / L_jj with s summed
// over k = m - 1 down to j + 1 of L_kj v_k, then every row above takes y_i
// -= sum_r L_ri x_r. Where lower_substitution's lane j solves row j and
// broadcasts it by a shuffle, every lane here holds the whole panel in
// registers and solves all its rows alike, so no step waits for a shuffle;
// the rows below or above go one per lane, their tile addresses formed once
// per panel. kZeroDividends: a caller whose right-hand sides are often zero
// (the gradient of an env at rest) skips the divisions of zero dividends
// (div_pos, the same bits), which costs the others a compare each. Reads
// only L's lower triangle. b (global or shared) must not alias out or y.
// The caller syncs before (b ready) and after (out ready).
template <bool kZeroDividends>
__device__ void warp_exact_solve(const Tiles& L, const float* b, float* out, float* y, int n) {
  const auto divide = [](float x, float d) { return kZeroDividends ? div_pos(x, d) : x / d; };
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < n; i += 32) out[i] = b[i];
  int cpl[kLaneRows];  // col_part of the lane's columns lane + 32 q
#pragma unroll
  for (int q = 0; q < kLaneRows; ++q) cpl[q] = L.col_part(lane + 32 * q);
  __syncwarp();
  float a[kPanel][kPanel], v[kPanel];
  for (int p0 = 0; p0 < n; p0 += kPanel) {  // forward: L y = b
    const int m = min(kPanel, n - p0);
    float mine = 0.f;
    diag_panel(L, p0, m, a);
#pragma unroll
    for (int j = 0; j < kPanel; ++j) {
      v[j] = 0.f;
      if (j < m) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < j; ++k) s += a[j][k] * v[k];
        v[j] = divide(out[p0 + j] - s, a[j][j]);
        if (lane == j) mine = v[j];
      }
    }
    if (lane < m) y[p0 + lane] = mine;
    if (p0 + m < n) {  // a full panel: columns p0 .. p0 + 7 are two tile columns
      const int tp = p0 >> 2;
      const float* ca = L.s + 4 * tri(L.nt - 1 - tp);
      const float* cb = L.s + 4 * tri(L.nt - 2 - tp);
      int rp = L.row_part(p0 + m + lane);  // row i + 32 is 8 tiles, 32 floats, earlier
      for (int i = p0 + m + lane; i < n; i += 32, rp -= 32) {
        const float4 u = *reinterpret_cast<const float4*>(ca + rp);
        const float4 w = *reinterpret_cast<const float4*>(cb + rp);
        float t = 0.f;
        t += u.x * v[0];
        t += u.y * v[1];
        t += u.z * v[2];
        t += u.w * v[3];
        t += w.x * v[4];
        t += w.y * v[5];
        t += w.z * v[6];
        t += w.w * v[7];
        out[i] -= t;
      }
    }
    __syncwarp();
  }
  for (int p0 = ((n - 1) / kPanel) * kPanel; p0 >= 0; p0 -= kPanel) {  // L^T x = y
    const int m = min(kPanel, n - p0);
    float mine = 0.f;
    diag_panel(L, p0, m, a);
#pragma unroll
    for (int j = kPanel - 1; j >= 0; --j) {
      v[j] = 0.f;
      if (j < m) {
        float s = 0.f;
#pragma unroll
        for (int k = kPanel - 1; k > j; --k)
          if (k < m) s += a[k][j] * v[k];
        v[j] = divide(y[p0 + j] - s, a[j][j]);
        if (lane == j) mine = v[j];
      }
    }
    if (lane < m) out[p0 + lane] = mine;
    const float* r0 = L.s + L.row_part(p0);      // rows p0 .. p0 + 3, a plane apart
    const float* r4 = L.s + L.row_part(p0 + 4);  // rows p0 + 4 .. p0 + 7
#pragma unroll
    for (int q = 0; q < kLaneRows; ++q) {
      if (32 * q + lane < p0) {
        const int cp = cpl[q];
        float t = 0.f;
#pragma unroll
        for (int r = 0; r < kPanel; ++r)
          if (r < m) t += (r < 4 ? r0 : r4)[(r & 3) * L.plane + cp] * v[r];
        y[32 * q + lane] -= t;
      }
    }
    __syncwarp();
  }
}

}  // namespace
