// The USR walk over the packed int32 arena, one thread a probe: the device
// code of the fused draw's walk (fused_draw.cu) and of the per-page GET
// (tree_probe_paged.cu). The GET over the whole arena is tree_get.cu.
//
// Replaces tree_walk and _descend of src/repro/kernels/tree_probe.py. One
// thread walks one probe position: root locate in root_prefE, then per tree
// edge (pre-order) the mixed-radix peel, a branchless power-of-two descent
// into the child's cumw_excl, and the perm lookup. Every step is a dependent
// load from the arena, so a lane is bound by memory latency, not bandwidth:
// the arena stays in device memory and its hot top levels in L2 and L1
// (read-only loads). The layout is a small table passed by value, so one
// build of each kernel serves every query shape.
#pragma once

#define RT_MAX_SLOTS 16
#define RT_EDGE_FIELDS 8

// Edge fields: parent slot, child slot, child_start / child_w / cumw_excl /
// perm offsets, child row count, descent steps over cumw_excl.
enum { E_PARENT, E_SLOT, E_CS, E_CW, E_CE, E_PERM, E_NCHILD, E_STEPS };

struct RtLayout {
  int root_len, n_root, root_steps, num_edges;
  int e[RT_MAX_SLOTS - 1][RT_EDGE_FIELDS];
};

// The table is [root_len, n_root, root_steps, num_edges, edges...].
static inline RtLayout rt_layout_from_table(const int* table) {
  RtLayout L;
  L.root_len = table[0];
  L.n_root = table[1];
  L.root_steps = table[2];
  L.num_edges = table[3];
  for (int k = 0; k < L.num_edges; ++k)
    for (int f = 0; f < RT_EDGE_FIELDS; ++f)
      L.e[k][f] = table[4 + RT_EDGE_FIELDS * k + f];
  return L;
}

// max j in [0, len-1] with a[off + j] <= q; needs a[off] <= q.
__device__ __forceinline__ int rt_descend(const int* __restrict__ a, int off,
                                          int len, int steps, int q) {
  int p = 0;
  for (int k = steps - 1; k >= 0; --k) {
    const int cand = p + (1 << k);
    const int val = __ldg(a + off + min(cand, len - 1));
    if (cand < len && val <= q) p = cand;
  }
  return p;
}

// Rows of every slot for one probe position (non-negative, < join size).
// `%` and `/` act on non-negative ints with a divisor >= 1, where C's
// truncation agrees with the reference's floor semantics.
__device__ __forceinline__ void rt_tree_walk(const int* __restrict__ arena,
                                             const RtLayout& L, int pos,
                                             int* rows) {
  int locs[RT_MAX_SLOTS];
  int j = rt_descend(arena, 0, L.root_len, L.root_steps, pos);
  j = min(j, L.n_root - 1);
  rows[0] = j;
  locs[0] = pos - __ldg(arena + j);
  for (int k = 0; k < L.num_edges; ++k) {
    const int* e = L.e[k];
    const int par = e[E_PARENT];
    const int prow = rows[par];
    const int w_safe = max(__ldg(arena + e[E_CW] + prow), 1);
    const int lp = locs[par];
    const int idx = lp % w_safe;
    locs[par] = lp / w_safe;
    const int start = __ldg(arena + e[E_CS] + prow);
    const int target = __ldg(arena + e[E_CE] + start) + idx;
    const int n_child = e[E_NCHILD];
    int jj = rt_descend(arena, e[E_CE], n_child + 1, e[E_STEPS], target);
    jj = min(jj, n_child - 1);
    rows[e[E_SLOT]] = __ldg(arena + e[E_PERM] + jj);
    locs[e[E_SLOT]] = target - __ldg(arena + e[E_CE] + jj);
  }
}
