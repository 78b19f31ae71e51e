// A dense J [e][n] per env walked in panels of rows through two slots of
// shared memory: the dense-J modes of cg_solve.cu and ell_cg_solve.cu.
//
// A dense J does not fit in shared memory beside the solve's other operands
// at the occupancy the compact modes reach (the rodent's 228 x 73 is 66.6 KB,
// the fly's 113 x 42 19.4 KB), so it stays in device memory (the resident
// CTAs' J stays in L2 between passes) and each pass over it, J x by rows or
// J^T f by columns, walks it in panels of at most P rows: while a CTA works
// on the panel in one slot, the next one's copy is in flight into the other.
// A panel's rows are one run of device memory, copied as it lies (rows n
// floats apart) with 16-byte cp.async.cg, its first float at the same
// offset mod 16 bytes as in device memory; only the run's ends take 4-byte
// copies.
//
// A J^T f walk runs forward (panel 0 first); a J x walk, whose rows do not
// depend on each other, runs either way, and the kernels turn back at each
// walk where they can: a walk that starts where the last one ended finds its
// first two panels in the slots, with no copy and no wait. Each step but
// the last copies the walk's next panel, and the last one copies the next
// walk's first panel that the slots do not hold, so that copy overlaps the
// work between walks. A step whose panel was copied passes one CTA barrier
// (its wait, and the freeing of the slot that the next copy reuses). Each
// J x walk takes the n M rows beside panel np - 1, the smallest: an M row's
// chain is 2-3 times a J row's (its column part reads the tiles term by
// term), so one step pays for it and the others for a J row.
//
// Panels hold whole items: rows 0 .. ns - 1 are items of one row, every
// later item is 3 rows (an elliptic cone block), so P is a multiple of 3
// when ns < e and a panel boundary falls at min(e, k P) rounded down to an
// item boundary. A sum over a row runs in increasing d within one thread;
// a sum over a column runs in row order, its partial sum carried in a
// register from panel to panel: the float operations and their order are
// those of a walk over the whole J. Rows n floats apart meet in one bank
// where a warp's threads read one row each at the same d only if n is odd;
// at even n two threads share a bank.
//
// What was measured on an NVIDIA H100 (PERF.md, Findings): 4-byte copies,
// one a lane, ran at about 4 bytes a cycle per CTA, slower than the passes;
// M rows spread over the panels put one in every step's chain; three slots
// (a copy two steps ahead) made more and smaller panels and cost more than
// the waits they saved. The copies that are still waited for (a step's
// panel asked for one step before) are what is left: without them the
// kernels would run 17-18% faster.
//
// With np <= kJSlots panels J is copied once, panel k into slot k, and the
// walks pass no barrier and copy nothing.

#pragma once

#include <cuda_runtime.h>

#include "tiled_cholesky.cuh"

namespace {

constexpr int kJSlots = 2;

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// 16 bytes from global to shared memory through L2 alone, both addresses
// 16-byte aligned.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

// Floats from the last 16-byte boundary to p.
__device__ __forceinline__ int floats_past_16(const float* p) {
  return (int)((reinterpret_cast<unsigned long long>(p) >> 2) & 3);
}

struct JPanels {
  int n, e, ns, rows, np, slot;  // rows: P, the most rows a panel holds; slot: floats of a slot
  bool resident;

  // The panels of e rows of n (the first ns of one row each, the rest cone
  // blocks of 3) in a ring of at most ring_floats floats.
  __host__ __device__ JPanels(int n_, int e_, int ns_, int ring_floats) : n(n_), e(e_), ns(ns_) {
    const int step = ns < e ? 3 : 1;
    rows = max(step, (ring_floats / kJSlots - 4) / n / step * step);
    slot = (rows * n + 3 + 3) & ~3;  // a panel, and up to 3 floats before it
    np = (e + rows - 1) / rows;
    resident = np <= kJSlots;
  }

  // Floats of the ring in shared memory, a multiple of 4.
  __host__ __device__ int floats() const { return min(np, kJSlots) * slot; }

  // The first row of panel k (k = np: e).
  __host__ __device__ int cut(int k) const {
    const int r = min(e, k * rows);
    return r <= ns ? r : ns + (r - ns) / 3 * 3;
  }

  // The M rows a row pass takes beside panel k, [x, y): all n beside the
  // last panel, the smallest.
  __device__ __forceinline__ int2 m_rows(int k) const {
    return make_int2(0, k == np - 1 ? n : 0);
  }

  // Slot `slot` holding the run of rows from src on: its first row, at
  // src's offset mod 16 bytes.
  __device__ __forceinline__ float* at(float* ring, int slot, const float* src) const {
    return ring + slot * this->slot + floats_past_16(src);
  }

  // Copies panel k from this env's J in device memory into slot `slot` (16
  // bytes a copy between 4-byte ends) and commits the copies as one group.
  template <int NT>
  __device__ __forceinline__ void issue(float* ring, const float* gj, int k, int slot) const {
    const int count = (cut(k + 1) - cut(k)) * n;
    const float* src = gj + (long)cut(k) * n;
    float* dst = at(ring, slot, src);
    const int head = min(count, (4 - floats_past_16(src)) & 3);
    const int body = (count - head) >> 2;
    const int t = threadIdx.x;
    if (t < head) cp_async4(dst + t, src + t);
    for (int c = t; c < body; c += NT) cp_async16(dst + head + 4 * c, src + head + 4 * c);
    for (int c = head + 4 * body + t; c < count; c += NT) cp_async4(dst + c, src + c);
    cp_async_commit();
  }

  // The stream's state, the same in every thread: the panel last walked
  // over and its slot, the panel the other slot holds (-1: none yet, or a
  // copy into it), and whether the other slot holds or is receiving the
  // next panel.
  struct Stream {
    int panel, slot, other;
    bool pending;
  };

  // Before the first walk: resident, every panel; else the first walk's
  // first panel (the last one if it runs backward). The caller waits for
  // every copy and passes a barrier.
  template <int NT>
  __device__ __forceinline__ Stream start(float* ring, const float* gj, bool backward) const {
    if (resident) {
      for (int k = 0; k < np; ++k) issue<NT>(ring, gj, k, k);
      return Stream{0, 0, -1, false};
    }
    const int first = backward ? np - 1 : 0;
    issue<NT>(ring, gj, first, 0);
    return Stream{first, 0, -1, false};
  }

  // One walk over J: body(k, r0, r1, rows) for each panel k, rows r0 ..
  // r1 - 1, row r at rows + (r - r0) n, panel 0 first, or panel np - 1
  // first if `backward`; `next_backward` tells the way of the next walk,
  // whose first panel (or second, where it starts with this walk's last)
  // this walk's last step starts to copy, unless the other slot holds it
  // still (a walk that turns back: its first two panels are this one's
  // last two). Every thread calls it, after a barrier that follows the last
  // walk.
  template <int NT, typename Body>
  __device__ __forceinline__ void walk(float* ring, const float* gj, Stream& st, bool backward,
                                       bool next_backward, Body body) const {
    for (int i = 0; i < np; ++i) {
      const int k = backward ? np - 1 - i : i;
      if (!resident) {
        if (k != st.panel) {  // the other slot's panel: wait for its copy, and free this slot
          cp_async_wait_all();
          __syncthreads();
          st = Stream{k, st.slot ^ 1, st.panel, false};
        }
        if (!st.pending) {
          int next = i + 1 < np ? (backward ? k - 1 : k + 1) : (next_backward ? np - 1 : 0);
          if (next == k) next = next_backward ? np - 2 : 1;
          if (next != st.other) {  // (a walk that turns back finds its second panel there)
            issue<NT>(ring, gj, next, st.slot ^ 1);
            st.other = -1;
          }
          st.pending = true;
        }
      }
      body(k, cut(k), cut(k + 1), at(ring, resident ? k : st.slot, gj + (long)cut(k) * n));
    }
  }
};

}  // namespace
