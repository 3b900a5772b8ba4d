// Paged USR GET: the walk of tree_walk.cuh, one page of the index at a time.
//
// Replaces tree_probe_paged of src/repro/kernels/tree_probe.py: its
// per-page form _paged_launches (the root-page pallas_call and the
// edge-page pallas_call, over _root_page_step and _edge_page_step) and its
// one-launch form _paged_dma (_dma_paged_kernel). A page is one contiguous
// slice of the arena: page 0 the root prefix, page k + 1 edge k's
// child_start, child_w, cumw_excl and perm columns. In-page offsets are the
// layout's offsets minus the page start (child_start leads its page, so its
// rebased offset is 0).
//
//  * Per-page form: one launch per page. tpp_root_kernel locates each
//    probe in page 0 and writes (row, local); tpp_edge_kernel takes the
//    parent's (row, local) and writes (child row, child local, the parent's
//    local after the mixed-radix peel). The caller threads that third
//    output into the parent's next child, as tree_walk updates its locals
//    in place. Each launch reads one page, so that page alone is what the
//    launch keeps hot in L2 (a page of the paged regime is at most a few
//    MB; the whole paged arena may be over the 50 MB L2).
//  * One-launch form: tpp_stacked_kernel walks every page of the stacked
//    (npages, P) buffer, one thread per probe, locals in registers.
//
// Bound on the card: like tree_probe, by the latency of the dependent loads
// of each lane's descents (bytes are a small multiple of one read of the
// pages). The per-page form adds a write and a read of 3 int32 per lane
// per edge and one launch per page. Staging pages in shared memory is
// later work.
#include <cuda_runtime.h>

#include "tree_walk.cuh"

struct TppEdge {
  int f[RT_EDGE_FIELDS];
};

// Root locate against page 0 (no rebase: the root prefix is the arena's
// start).
__device__ __forceinline__ void tpp_root_step(const int* __restrict__ page,
                                              int root_len, int n_root,
                                              int steps, int pos, int& row,
                                              int& local) {
  const int j = min(rt_descend(page, 0, root_len, steps, pos), n_root - 1);
  row = j;
  local = pos - __ldg(page + j);
}

// One edge of rt_tree_walk against its own page, offsets rebased by the
// page start e[E_CS].
__device__ __forceinline__ void tpp_edge_step(const int* __restrict__ page,
                                              const int* e, int prow,
                                              int plocal, int& crow,
                                              int& clocal, int& pnew) {
  const int base = e[E_CS];
  const int w_safe = max(__ldg(page + (e[E_CW] - base) + prow), 1);
  const int idx = plocal % w_safe;
  pnew = plocal / w_safe;
  const int start = __ldg(page + prow);
  const int ce = e[E_CE] - base;
  const int target = __ldg(page + ce + start) + idx;
  const int n_child = e[E_NCHILD];
  const int jj =
      min(rt_descend(page, ce, n_child + 1, e[E_STEPS], target), n_child - 1);
  crow = __ldg(page + (e[E_PERM] - base) + jj);
  clocal = target - __ldg(page + ce + jj);
}

__global__ void tpp_root_kernel(const int* __restrict__ page, int root_len,
                                int n_root, int steps,
                                const int* __restrict__ q,
                                int* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int row, local;
    tpp_root_step(page, root_len, n_root, steps, q[i], row, local);
    out[i] = row;
    out[n + i] = local;
  }
}

__global__ void tpp_edge_kernel(const int* __restrict__ page,
                                const __grid_constant__ TppEdge E,
                                const int* __restrict__ prow,
                                const int* __restrict__ ploc,
                                int* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int crow, clocal, pnew;
    tpp_edge_step(page, E.f, prow[i], ploc[i], crow, clocal, pnew);
    out[i] = crow;
    out[n + i] = clocal;
    out[2 * n + i] = pnew;
  }
}

__global__ void tpp_stacked_kernel(const int* __restrict__ pages,
                                   long long P,
                                   const __grid_constant__ RtLayout L,
                                   const int* __restrict__ q,
                                   int* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int slots = L.num_edges + 1;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int rows[RT_MAX_SLOTS], locs[RT_MAX_SLOTS];
    tpp_root_step(pages, L.root_len, L.n_root, L.root_steps, q[i], rows[0],
                  locs[0]);
    for (int k = 0; k < L.num_edges; ++k) {
      const int* e = L.e[k];
      const int par = e[E_PARENT];
      tpp_edge_step(pages + (k + 1) * P, e, rows[par], locs[par],
                    rows[e[E_SLOT]], locs[e[E_SLOT]], locs[par]);
    }
    for (int s = 0; s < slots; ++s) out[(long long)s * n + i] = rows[s];
  }
}

static inline int tpp_blocks(long long n, int threads) {
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  return (int)blocks;
}

extern "C" int tpp_root_launch(const int* page, int root_len, int n_root,
                               int steps, const int* q, int* out, long long n,
                               void* stream) {
  if (n == 0) return (int)cudaGetLastError();
  tpp_root_kernel<<<tpp_blocks(n, 256), 256, 0, (cudaStream_t)stream>>>(
      page, root_len, n_root, steps, q, out, n);
  return (int)cudaGetLastError();
}

// `edge` holds the RT_EDGE_FIELDS fields of one layout edge.
extern "C" int tpp_edge_launch(const int* page, const int* edge,
                               const int* prow, const int* ploc, int* out,
                               long long n, void* stream) {
  TppEdge E;
  for (int f = 0; f < RT_EDGE_FIELDS; ++f) E.f[f] = edge[f];
  if (n == 0) return (int)cudaGetLastError();
  tpp_edge_kernel<<<tpp_blocks(n, 256), 256, 0, (cudaStream_t)stream>>>(
      page, E, prow, ploc, out, n);
  return (int)cudaGetLastError();
}

extern "C" int tpp_stacked_launch(const int* pages, long long P,
                                  const int* table, const int* q, int* out,
                                  long long n, void* stream) {
  const RtLayout L = rt_layout_from_table(table);
  if (n == 0) return (int)cudaGetLastError();
  tpp_stacked_kernel<<<tpp_blocks(n, 256), 256, 0, (cudaStream_t)stream>>>(
      pages, P, L, q, out, n);
  return (int)cudaGetLastError();
}
