// Paged USR GET, per-page form: the walk of tree_walk.cuh, one page of the
// index at a time.
//
// Replaces _paged_launches of src/repro/kernels/tree_probe.py (the
// root-page pallas_call and the edge-page pallas_call, over
// _root_page_step and _edge_page_step), as the explicit per-page form
// (tree_probe_paged(..., dma=False)). The paged GET's default on CUDA and
// its dma=True form are one launch of tree_get.cu. A page is one
// contiguous slice of the arena: page 0 the root prefix, page k + 1 edge
// k's child_start, child_w, cumw_excl and perm columns. In-page offsets are
// the layout's offsets minus the page start (child_start leads its page, so
// its rebased offset is 0).
//
// One launch per page. tpp_root_kernel locates each probe in page 0 and
// writes (row, local); tpp_edge_kernel takes the parent's (row, local) and
// writes (child row, child local, the parent's local after the mixed-radix
// peel). The caller threads that third output into the parent's next
// child, as tree_walk updates its locals in place. Each launch reads one
// page, so that page alone is what the launch keeps hot in L2.
//
// Bound on the card: by the latency of the dependent loads of each lane's
// descents (bytes are a small multiple of one read of the pages), plus a
// write and a read of 3 int32 per lane per edge and one launch per page.
//
// The checked build (-DTPP_CHECK_BOUNDS; tree_probe.paged_out_of_bounds)
// holds every load of a page (rt_descend's included), of a probe and of a
// parent's (row, local), and every store, against the launch's operands:
// its own page alone, not the buffer that holds it (bounds_check.cuh).
#include <cuda_runtime.h>

#ifdef TPP_CHECK_BOUNDS
#define BC_CHECK_BOUNDS
#endif
#include "bounds_check.cuh"
#include "tree_walk.cuh"

BC_CHECK_ENTRIES(tree_probe_paged)

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
    tpp_root_step(page, root_len, n_root, steps, BC_LD(q + i), row, local);
    BC_ST(out + i, row);
    BC_ST(out + n + i, local);
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
    tpp_edge_step(page, E.f, BC_LD(prow + i), BC_LD(ploc + i), crow, clocal,
                  pnew);
    BC_ST(out + i, crow);
    BC_ST(out + n + i, clocal);
    BC_ST(out + 2 * n + i, pnew);
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
