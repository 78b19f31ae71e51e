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
// cholesky_f32 and solve_spd_f32 (the tiled factor below), n <= 128:
// - one env per CTA of 64 threads; its lower triangle is copied with
//   cp.async, a warp per row, into shared memory as 4x4 tiles (Tiles:
//   12.4 KB at n = 73, so registers, not shared memory, cap an SM at 12-14
//   CTAs); nothing above the diagonal is read;
// - a blocked right-looking factor in panels of 8 columns: warp 0 factors
//   the panel in registers (lane l holds rows p0 + l + 32 q), pivots and
//   columns broadcast by shuffles; the other warps update the trailing
//   lower triangle one 4x4 tile at a time in registers, with 128-bit shared
//   loads of the panel's tiles, while warp 0 updates the next panel's tiles
//   and factors it (lookahead). One CTA barrier per panel; no tile above
//   the diagonal is visited;
// - the arithmetic is `factor`'s (cholesky.cuh): pivot rsqrtf, column
//   scaled by multiplication, and each entry receives its updates
//   L_ik -= L_ij L_kj one multiply-add at a time in increasing j (the torch
//   mirror of this schedule in tests/test_torch_linalg.py equals `factor`
//   bit for bit);
// - cholesky writes the dense factor, upper triangle zero, a warp per row;
//   solve_spd runs the exact lower_substitution on the tiles and writes
//   only x.
// What is left (PERF.md, Findings): each env's chain (the panels' shuffles and
// rsqrt, the substitution's divisions) and the trailing update's shared
// loads, not bytes; solve_spd's time is mostly its substitution. Panels of
// 16 and 128 threads per CTA were measured slower (more registers, fewer
// CTAs per SM).
// cho_solve_f32 keeps the first design: one env per CTA, the dense factor
// in shared memory (n^2 + 2n floats), blocked_substitution.
//
// C interface (bound with ctypes): each *_f32 launches on the given stream
// and returns cudaGetLastError(); each *_smem_bytes(n) gives the dynamic
// shared memory one CTA needs; tiled_kernel_info gives the tiled kernels'
// registers, shared memory and resident CTAs per SM.

#include <cuda_runtime.h>

#include "cholesky.cuh"

namespace {

constexpr int kThreads = 128;             // cho_solve
constexpr long kDefaultSmem = 48 * 1024;  // above this a kernel must opt in
constexpr int kMaxN = 128;                // the TPU kernels' documented range
constexpr int kLaneRows = kMaxN / 32;     // panel rows per lane of warp 0
constexpr int kTiledPanel = 8;            // the tiled factor's panel width
constexpr int kTiledThreads = 64;         // and threads per CTA (one env)

// ---------------------------------------------------------------------------
// cho_solve: dense factor in shared memory
// ---------------------------------------------------------------------------

// the matrix, then the substitution's two n-vectors (out, y)
__host__ __device__ inline long smem_floats(int n) { return (long)n * n + 2L * n; }

__global__ void __launch_bounds__(kThreads)
cho_solve_kernel(const float* __restrict__ l, const float* __restrict__ b,
                 float* __restrict__ x, int n) {
  extern __shared__ float L[];
  const long nn = (long)n * n;
  float* out = L + nn;
  float* y = out + n;
  for (long t = threadIdx.x; t < nn; t += kThreads) L[t] = l[blockIdx.x * nn + t];
  // the substitution's first barrier orders the load
  blocked_substitution<kThreads>(L, b + (long)blockIdx.x * n, out, y, n);
  for (int i = threadIdx.x; i < n; i += kThreads) x[(long)blockIdx.x * n + i] = out[i];
}

// ---------------------------------------------------------------------------
// the tiled factor: cholesky and solve_spd
// ---------------------------------------------------------------------------

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

// (c, t - tri(c)) for the largest c with tri(c) <= t: tile t's column and
// row counted from the last.
__device__ __forceinline__ int2 untri(int t) {
  int c = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  if (tri(c + 1) <= t) ++c;
  if (tri(c) > t) --c;
  return make_int2(c, t - tri(c));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

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

// One env per CTA. kSolve: x = A^-1 b into out [B, n]; else the dense
// factor into out [B, n, n], upper triangle zero.
template <bool kSolve>
__global__ void __launch_bounds__(kTiledThreads)
tiled_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out,
             int n) {
  constexpr int P = kTiledPanel, NT = kTiledThreads;
  extern __shared__ __align__(16) float smem[];
  const Tiles L(smem, n);
  const long nn = (long)n * n;
  load_lower<NT>(a + blockIdx.x * nn, L, n);
  __syncthreads();
  if (threadIdx.x < 32) factor_panel<P>(L, n, 0);
  __syncthreads();
  // With lookahead: while the other warps apply the panel at p0 to the
  // tiles right of the next panel, warp 0 applies it to the next panel's
  // own tiles (the last indices, split on) and factors that panel. Every
  // entry still takes the panels in order; one barrier per panel.
  for (int p0 = 0; p0 < n; p0 += P) {
    const int m = L.nt - ((p0 + P) >> 2);  // tile columns right of the panel
    if (m <= 0) break;  // the last panel; else p0 + P < n, the next exists
    const int split = tri(max(m - P / 4, 0));
    if (threadIdx.x < 32) {
      update_tiles<P>(L, p0, split + threadIdx.x, tri(m), 32);
      __syncwarp();
      factor_panel<P>(L, n, p0 + P);
    } else {
      update_tiles<P>(L, p0, threadIdx.x - 32, split, NT - 32);
    }
    __syncthreads();
  }
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
extern "C" long cho_solve_smem_bytes(int n) { return smem_floats(n) * (long)sizeof(float); }
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

extern "C" int cholesky_f32(const float* a, float* l, int batch, int n, void* stream) {
  return tiled_launch<false>(a, nullptr, l, batch, n, stream);
}

extern "C" int cho_solve_f32(const float* l, const float* b, float* x, int batch, int n,
                             void* stream) {
  if (batch <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const long smem = cho_solve_smem_bytes(n);
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(cho_solve_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cho_solve_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(l, b, x, n);
  return (int)cudaGetLastError();
}

extern "C" int solve_spd_f32(const float* a, const float* b, float* x, int batch, int n,
                             void* stream) {
  return tiled_launch<true>(a, b, x, batch, n, stream);
}
