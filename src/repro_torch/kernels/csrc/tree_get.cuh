// The USR GET for Hopper: a walk of the packed int32 index by tiles of
// probes, the device code of tree_get.cu.
//
// Replaces tree_probe (with tree_walk and _descend), _paged_launches and
// _paged_dma of src/repro/kernels/tree_probe.py. It computes what tree_walk
// computes: int32 probe positions -> the row of every slot, bit for bit.
//
// What bounds it. Each level of the walk is a search of one non-decreasing
// vector (the root prefix, or an edge's cumw_excl) followed by gathers. A
// lane that walks alone makes ~log2(len) dependent loads a level, each one
// waiting the full L2 or HBM latency (tree_walk.cuh). The bytes bound is
// ~9x lower. So the design cuts dependent global loads, not bytes:
//
//  1. Tile bracketing. A block takes a tile of TG_THREADS x ITEMS probes.
//     For each searched vector it reduces the tile's min and max query
//     and two warps find their positions d(qmin), d(qmax) by a 32-ary
//     search (a ballot a round: 5 bits of the answer per dependent load).
//     For a non-decreasing vector, d(q) for any q in [qmin, qmax] lies in
//     [d(qmin), d(qmax)], repeated values included, so when that slice is
//     at most TG_SPAN wide the block stages it (and the perm slice beside
//     it) in shared memory with coalesced loads, and every lane finishes
//     its search there. The clamps of tree_walk stay where they are: the
//     slice starts at min(d(qmin), n - 1) so that the clamped row is in
//     it. Sorted probes (the full join, the sampled GET) give narrow
//     slices. The child_start / child_w gathers of an edge are staged the
//     same way over the tile's parent rows.
//  2. A fallback for wide slices (shuffled or sparse probes, or an edge
//     whose parent rows are scattered): a per-lane descent whose first
//     TG_LEVELS steps read a pivot table in shared memory, the values at
//     m * 2^(steps - TG_LEVELS), which are all that those steps of the
//     branchless descent touch; ITEMS lanes a thread keep their loads in
//     flight together. The pivots also bound each bracket before it is
//     searched: a tile whose pivot interval already exceeds TG_SPAN skips
//     the warp search.
//  3. A persistent grid: as many blocks as are resident (occupancy at the
//     dynamic shared memory), each loading the pivot tables once and then
//     striding over tiles.
//  4. No local-memory arrays: rows and locals stay in registers, indexed
//     only at compile time. Edge k's child is slot k + 1 (the arena's
//     pre-order packing; the wrapper checks it), so only an edge's parent
//     slot is a run-time value, selected by an unrolled compare.
//  5. One kernel for three operands: every searched vector carries a base
//     that is added to the layout's offsets, so the same kernel walks the
//     whole arena (base 0), a paged arena's buffer (base 0: its pages are
//     views of it) and the stacked pages ((k + 1) * P - cs_off for edge k).
//
// Exact for any probes: a staged search and the fallback both return
// max j with a[j] <= q (0 if none) for non-decreasing a, which is what the
// branchless descent of tree_walk returns. Division and remainder act on
// the same non-negative values as there.
//
// The search of one vector (TgVec, TgShared, tg_search and what it calls)
// is also the device code of bsearch_probe.cu, over a bare prefix vector.
#pragma once

#include <cuda_runtime.h>

#include "tree_walk.cuh"

#define TG_THREADS 256
#define TG_WARPS (TG_THREADS / 32)
// The widest bracket a tile stages (words), and the descent steps a pivot
// table holds (2^TG_LEVELS values).
#define TG_SPAN 2048
#define TG_LEVELS 10
// Probes a thread of the builtin tile (tuning's block_rows 8: 256 x 4 =
// 1,024 probes a tile).
#define TG_ITEMS 4

// The most probes a thread a tree of `slots` nodes walks: its rows and
// locals (2 x slots x items words) stay in registers.
static inline int tg_max_items(int slots) {
  return slots <= 4 ? 8 : slots <= 8 ? 2 : 1;
}

// A store of a row that the checked build (tree_get.cu, TG_CHECK_BOUNDS)
// holds against the operands; always made otherwise.
#ifndef TG_STORE_OK
#define TG_STORE_OK(p) true
#endif

// The walk's table (tree_walk.cuh) and, after it, a base per searched
// vector (0 the root prefix, k + 1 edge k's columns) added to the layout's
// offsets.
struct TgLayout : RtLayout {
  int base[RT_MAX_SLOTS];
};

// The table is [root_len, n_root, root_steps, num_edges, edges...,
// bases...].
static inline TgLayout tg_layout_from_table(const int* t) {
  TgLayout L;
  static_cast<RtLayout&>(L) = rt_layout_from_table(t);
  for (int s = 0; s <= L.num_edges; ++s)
    L.base[s] = t[4 + RT_EDGE_FIELDS * L.num_edges + s];
  return L;
}

__host__ __device__ __forceinline__ int tg_pivot_shift(int steps) {
  return steps > TG_LEVELS ? steps - TG_LEVELS : 0;
}

__host__ __device__ __forceinline__ int tg_pivot_count(int steps) {
  return 1 << (steps - tg_pivot_shift(steps));
}

__host__ __device__ __forceinline__ int tg_steps(const TgLayout& L, int s) {
  return s == 0 ? L.root_steps : L.e[s - 1][E_STEPS];
}

// Shared memory of one block: the pivot tables, two staging buffers of
// TG_SPAN words, the double-buffered reduction words and the bracket.
static inline size_t tg_smem_bytes(const TgLayout& L) {
  int words = 2 * TG_SPAN + 4 * TG_WARPS + 2;
  for (int s = 0; s <= L.num_edges; ++s) words += tg_pivot_count(tg_steps(L, s));
  return (size_t)words * sizeof(int);
}

struct TgShared {
  int* buf0;
  int* buf1;
  int* red;      // [2][2][TG_WARPS]: min and max, two phases
  int* bracket;  // [2]
};

// One searched vector: element 0 at `a`, its perm column at `perm` (edges
// only), its pivot table, length, descent steps, pivot shift and the clamp
// of the row it yields.
struct TgVec {
  const int* a;
  const int* perm;
  const int* piv;
  int len, steps, sh, cap;
};

// Vector s of the walk: 0 the root prefix, k + 1 edge k's cumw_excl.
__device__ __forceinline__ TgVec tg_vec(const int* arena, const TgLayout& L,
                                        int s, const int* pivots) {
  int off = 0;
  for (int t = 0; t < s; ++t) off += tg_pivot_count(tg_steps(L, t));
  TgVec v;
  if (s == 0) {
    v.a = arena + L.base[0];
    v.perm = nullptr;
    v.len = L.root_len;
    v.cap = L.n_root - 1;
  } else {
    const int* e = L.e[s - 1];
    const int* A = arena + L.base[s];
    v.a = A + e[E_CE];
    v.perm = A + e[E_PERM];
    v.len = e[E_NCHILD] + 1;
    v.cap = e[E_NCHILD] - 1;
  }
  v.steps = tg_steps(L, s);
  v.sh = tg_pivot_shift(v.steps);
  v.piv = pivots + off;
  return v;
}

// The tile's min and max of v, in every thread (one barrier). The words
// alternate between two phases, so that the next reduction's writes never
// meet this one's reads.
template <int ITEMS>
__device__ __forceinline__ void tg_block_minmax(const int (&v)[ITEMS],
                                                const TgShared& sm, int& phase,
                                                int& vmin, int& vmax) {
  int lo = v[0], hi = v[0];
#pragma unroll
  for (int it = 1; it < ITEMS; ++it) {
    lo = min(lo, v[it]);
    hi = max(hi, v[it]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  int* r = sm.red + phase * 2 * TG_WARPS;
  phase ^= 1;
  if ((threadIdx.x & 31) == 0) {
    r[threadIdx.x >> 5] = lo;
    r[TG_WARPS + (threadIdx.x >> 5)] = hi;
  }
  __syncthreads();
  vmin = r[0];
  vmax = r[TG_WARPS];
#pragma unroll
  for (int w = 1; w < TG_WARPS; ++w) {
    vmin = min(vmin, r[w]);
    vmax = max(vmax, r[TG_WARPS + w]);
  }
}

// The first steps of the branchless descent for N queries at once, from
// the pivot table: each answer then lies in [p, p + 2^sh - 1].
template <int N>
__device__ __forceinline__ void tg_pivot_descend(const TgVec& v,
                                                 const int (&q)[N],
                                                 int (&p)[N]) {
#pragma unroll
  for (int it = 0; it < N; ++it) p[it] = 0;
  for (int k = v.steps - 1; k >= v.sh; --k) {
#pragma unroll
    for (int it = 0; it < N; ++it) {
      const int cand = p[it] + (1 << k);
      if (cand < v.len && v.piv[cand >> v.sh] <= q[it]) p[it] = cand;
    }
  }
}

// max j in [lo, hi] with a[j] <= q (lo if none), by the whole warp: lanes
// 1..31 test evenly spaced points and a ballot keeps one segment.
__device__ __forceinline__ int tg_warp_search(const int* a, int lo, int hi,
                                              int q) {
  const int lane = threadIdx.x & 31;
  while (hi > lo) {
    const int stride = (hi - lo) / 32 + 1;
    const long long pos = lo + (long long)lane * stride;
    const bool le = lane > 0 && pos <= hi && __ldg(a + pos) <= q;
    const int c = __popc(__ballot_sync(0xffffffffu, le));
    hi = (int)min((long long)hi, lo + (long long)(c + 1) * stride - 1);
    lo += c * stride;
  }
  return lo;
}

// Copy n words of src (and n2 of src2, TWO) into shared memory.
template <bool TWO>
__device__ __forceinline__ void tg_stage(int* dst, const int* src, int n,
                                         int* dst2, const int* src2, int n2) {
  const int m = TWO ? max(n, n2) : n;
  for (int i = threadIdx.x; i < m; i += TG_THREADS) {
    if (i < n) dst[i] = __ldg(src + i);
    if (TWO && i < n2) dst2[i] = __ldg(src2 + i);
  }
}

// One level of the walk for the tile: per item j = min(max j' with
// v.a[j'] <= q, v.cap), v.a[j] and (PERM) v.perm[j]. Warps 0 and 1 find the
// tile's bracket [d(qmin), d(qmax)] (pivots, then a warp search each,
// skipped when the pivots already show it wider than TG_SPAN); the tile
// stages it when it fits TG_SPAN, else takes the per-lane fallback.
// Returns whether the tile staged (the same in every thread).
template <int ITEMS, bool PERM>
__device__ __forceinline__ bool tg_search(const TgVec& v, const int (&q)[ITEMS],
                                          const TgShared& sm, int& phase,
                                          int (&j)[ITEMS],
                                          int (&aj)[ITEMS], int (&pj)[ITEMS]) {
  int qmin, qmax;
  tg_block_minmax<ITEMS>(q, sm, phase, qmin, qmax);
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int ends[2] = {qmin, qmax};
    int p[2];
    tg_pivot_descend<2>(v, ends, p);
    // The true bracket is [p[0] + x, p[1] + y] with 0 <= x, y < w.
    const long long w = 1LL << v.sh;
    int d = -1;
    if (p[1] - p[0] - w + 2 <= TG_SPAN) {
      d = warp ? p[1] : p[0];
      if (v.sh > 0)
        d = tg_warp_search(v.a, d, (int)min(d + w - 1, (long long)v.len - 1),
                           warp ? qmax : qmin);
    }
    if ((threadIdx.x & 31) == 0) sm.bracket[warp] = d;
  }
  __syncthreads();
  const int dlo = sm.bracket[0], dhi = sm.bracket[1];
  const int lo = min(dlo, v.cap);
  const int width = dhi - lo + 1;
  if (dlo >= 0 && width <= TG_SPAN) {
    tg_stage<PERM>(sm.buf0, v.a + lo, width, sm.buf1,
                   PERM ? v.perm + lo : nullptr, min(dhi, v.cap) - lo + 1);
    __syncthreads();
    const int steps = width > 1 ? 32 - __clz(width - 1) : 0;
    int p[ITEMS];
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) p[it] = 0;
    for (int k = steps - 1; k >= 0; --k) {
#pragma unroll
      for (int it = 0; it < ITEMS; ++it) {
        const int cand = p[it] + (1 << k);
        if (cand < width && sm.buf0[cand] <= q[it]) p[it] = cand;
      }
    }
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int r = min(lo + p[it], v.cap) - lo;
      j[it] = lo + r;
      aj[it] = sm.buf0[r];
      if (PERM) pj[it] = sm.buf1[r];
    }
    return true;
  }
  int p[ITEMS];
  tg_pivot_descend<ITEMS>(v, q, p);
  for (int k = v.sh - 1; k >= 0; --k) {
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int cand = p[it] + (1 << k);
      const int val = __ldg(v.a + min(cand, v.len - 1));
      if (cand < v.len && val <= q[it]) p[it] = cand;
    }
  }
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    j[it] = min(p[it], v.cap);
    aj[it] = __ldg(v.a + j[it]);
    if (PERM) pj[it] = __ldg(v.perm + j[it]);
  }
  return false;
}

// x[idx] and y[idx] per item, through shared memory when the tile's index
// range fits TG_SPAN.
template <int ITEMS>
__device__ __forceinline__ void tg_gather2(const int* x, const int* y,
                                           const int (&idx)[ITEMS],
                                           const TgShared& sm, int& phase,
                                           int (&xv)[ITEMS],
                                           int (&yv)[ITEMS]) {
  int lo, hi;
  tg_block_minmax<ITEMS>(idx, sm, phase, lo, hi);
  const long long width = (long long)hi - lo + 1;
  if (width <= TG_SPAN) {
    tg_stage<true>(sm.buf0, x + lo, (int)width, sm.buf1, y + lo, (int)width);
    __syncthreads();
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      xv[it] = sm.buf0[idx[it] - lo];
      yv[it] = sm.buf1[idx[it] - lo];
    }
  } else {
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      xv[it] = __ldg(x + idx[it]);
      yv[it] = __ldg(y + idx[it]);
    }
  }
}

// Edge K of the walk for the tile, then the edges after it: the parent's
// row and local, the peel, the child_start / child_w gathers and the
// search of the child's cumw_excl. A template a level, so that every index
// into rows and locs is a compile-time constant whatever the unroller does.
template <int MAXS, int ITEMS, int K>
__device__ __forceinline__ void tg_edges(const int* __restrict__ arena,
                                         const TgLayout& L, const int* pivots,
                                         const TgShared& sm, int& phase,
                                         int (&rows)[MAXS][ITEMS],
                                         int (&locs)[MAXS][ITEMS]) {
  if constexpr (K < MAXS - 1) {
    if (K >= L.num_edges) return;
    const int* e = L.e[K];
    const int* A = arena + L.base[K + 1];
    const int par = e[E_PARENT];
    int prow[ITEMS], lp[ITEMS];
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      prow[it] = rows[0][it];
      lp[it] = locs[0][it];
#pragma unroll
      for (int s = 1; s <= K; ++s)
        if (par == s) {
          prow[it] = rows[s][it];
          lp[it] = locs[s][it];
        }
    }
    int w[ITEMS], start[ITEMS], tgt[ITEMS];
    tg_gather2<ITEMS>(A + e[E_CW], A + e[E_CS], prow, sm, phase, w, start);
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int ws = max(w[it], 1);
      const int lnew = lp[it] / ws;
      const int idx = lp[it] - lnew * ws;
#pragma unroll
      for (int s = 0; s <= K; ++s)
        if (par == s) locs[s][it] = lnew;
      tgt[it] = __ldg(A + e[E_CE] + start[it]) + idx;
    }
    int j[ITEMS], cej[ITEMS], pj[ITEMS];
    tg_search<ITEMS, true>(tg_vec(arena, L, K + 1, pivots), tgt, sm, phase,
                           j, cej, pj);
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      rows[K + 1][it] = pj[it];
      locs[K + 1][it] = tgt[it] - cej[it];
    }
    tg_edges<MAXS, ITEMS, K + 1>(arena, L, pivots, sm, phase, rows, locs);
  }
}

// The walk of one tile of probes; rows of every slot written slot-major,
// out[s * n + i]. A thread's items are i = base + it * TG_THREADS + tid;
// items past n walk q[n - 1] (a probe of the same tile) and write nothing.
template <int MAXS, int ITEMS>
__device__ __forceinline__ void tg_tile(const int* __restrict__ arena,
                                        const TgLayout& L,
                                        const int* __restrict__ q,
                                        int* __restrict__ out, long long n,
                                        long long base, const int* pivots,
                                        const TgShared& sm, int& phase) {
  int qv[ITEMS];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it)
    qv[it] = __ldg(q + min(base + it * TG_THREADS + threadIdx.x, n - 1));
  int rows[MAXS][ITEMS], locs[MAXS][ITEMS];
  {
    int j[ITEMS], aj[ITEMS], unused[ITEMS];
    tg_search<ITEMS, false>(tg_vec(arena, L, 0, pivots), qv, sm, phase, j,
                            aj, unused);
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      rows[0][it] = j[it];
      locs[0][it] = qv[it] - aj[it];
    }
  }
  tg_edges<MAXS, ITEMS, 0>(arena, L, pivots, sm, phase, rows, locs);
#pragma unroll
  for (int s = 0; s < MAXS; ++s) {
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const long long i = base + it * TG_THREADS + threadIdx.x;
      if (s <= L.num_edges && i < n && TG_STORE_OK(out + s * n + i))
        out[s * n + i] = rows[s][it];
    }
  }
}
