// Bulk binary search of int32 probes into a sorted int32 prefix vector.
//
// Replaces bsearch_probe of src/repro/kernels/bsearch_probe.py: for each
// query q, the largest j with pref[j] <= q (0 if none), what the
// reference's branchless power-of-two descent returns.
//
// What bounds it. A lane that searches alone makes ceil(log2 NP) dependent
// loads (22 over the root prefix of JOB's 2.5 M titles), each waiting the
// L2 or HBM latency; the bytes bound (each query read and each answer
// written once, the vector once) is several times lower. So the design
// cuts dependent global loads: it is the GET's search of one vector
// (tree_get.cuh tg_search) over a bare prefix vector.
//
//  1. A persistent grid, as many blocks as are resident, each loading the
//     vector's pivot table (2^TG_LEVELS values) into shared memory once and
//     then striding over tiles of TG_THREADS x ITEMS queries. ITEMS is the
//     tile (the tuning's block_rows / 2): an instance each of 1, 2, 4 and
//     8 queries a thread; BP_ITEMS is the builtin tile's.
//  2. Per tile: the block reduces its min and max query; warps 0 and 1
//     find both ends' answers (pivots, then a 32-ary ballot search),
//     skipped when the pivots already show the bracket wider than TG_SPAN.
//     A bracket of at most TG_SPAN words is staged in shared memory with
//     coalesced loads and every lane descends there; a wider one takes the
//     per-lane descent whose top TG_LEVELS steps read the pivot table.
//
// The bracket comes from the tile's own min and max, so the answer is exact
// for queries in any order; sorted queries (every caller on the main path)
// make the brackets narrow: a tile of 1,024 sorted queries at JOB scale
// spans a few hundred words of the root prefix.
//
// The checked build (-DBP_CHECK_BOUNDS; bsearch_probe.out_of_bounds) holds
// every load (the pivot table, the queries, tg_search's warp searches,
// staged slices and descents) and every store of an answer or a count
// against the launch's operands (bounds_check.cuh).
#include <cuda_runtime.h>

#ifdef BP_CHECK_BOUNDS
#define BC_CHECK_BOUNDS
#endif
#include "bounds_check.cuh"
#include "tree_get.cuh"

BC_CHECK_ENTRIES(bsearch_probe)

// Queries a thread of the builtin tile (block_rows 8).
#define BP_ITEMS 4
// Words of dynamic shared memory: the largest pivot table and one staging
// buffer with the reduction words (tg_search over a vector without perm).
#define BP_SMEM_WORDS ((1 << TG_LEVELS) + TG_SPAN + 4 * TG_WARPS + 2)

// stats, when not null, counts the tiles that staged ([0]) and that fell
// back ([1]).
template <int ITEMS>
__global__ void __launch_bounds__(TG_THREADS)
    bsearch_probe_kernel(const int* __restrict__ pref, int np_len, int steps,
                         const int* __restrict__ q, int* __restrict__ out,
                         long long n, int* __restrict__ stats) {
  // tree_get.cu tg_run's set-up for one bare vector: its pivot table, then
  // one staging buffer (no perm column to stage), the reduction words and
  // the bracket.
  extern __shared__ int bp_smem[];
  TgVec v;
  v.a = pref;
  v.perm = nullptr;
  v.piv = bp_smem;
  v.len = np_len;
  v.steps = steps;
  v.sh = tg_pivot_shift(steps);
  v.cap = np_len - 1;
  const int count = tg_pivot_count(steps);
  for (int i = threadIdx.x; i < count; i += TG_THREADS)
    bp_smem[i] = __ldg(pref + min(i << v.sh, np_len - 1));
  TgShared sm;
  sm.buf0 = bp_smem + count;
  sm.buf1 = nullptr;
  sm.red = sm.buf0 + TG_SPAN;
  sm.bracket = sm.red + 4 * TG_WARPS;
  __syncthreads();
  const long long tile = TG_THREADS * ITEMS;
  const long long tiles = (n + tile - 1) / tile;
  int phase = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long base = t * tile;
    // items past n search q[n - 1], a query of the same tile
    int qv[ITEMS], j[ITEMS], aj[ITEMS], unused[ITEMS];
#pragma unroll
    for (int it = 0; it < ITEMS; ++it)
      qv[it] = __ldg(q + min(base + it * TG_THREADS + threadIdx.x, n - 1));
    const bool staged =
        tg_search<ITEMS, false>(v, qv, sm, phase, j, aj, unused);
    if (stats != nullptr && threadIdx.x == 0 &&
        BC_OK(stats + (staged ? 0 : 1), 4))
      atomicAdd(stats + (staged ? 0 : 1), 1);
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const long long i = base + it * TG_THREADS + threadIdx.x;
      if (i < n) BC_ST(out + i, j[it]);
    }
  }
}

using BpKernel = decltype(&bsearch_probe_kernel<BP_ITEMS>);

// The instance for `items` queries a thread, or null.
static BpKernel bp_instance(int items) {
  switch (items) {
    case 1: return bsearch_probe_kernel<1>;
    case 2: return bsearch_probe_kernel<2>;
    case 4: return bsearch_probe_kernel<4>;
    case 8: return bsearch_probe_kernel<8>;
  }
  return nullptr;
}

// The launch shape on the current device for `items` queries a thread:
// cfg = [queries a tile, blocks an SM, SMs, shared memory bytes]. A launch
// takes at most blocks an SM x SMs blocks. Returns a CUDA error code
// (cudaErrorInvalidValue for items with no instance).
extern "C" int bsearch_probe_config(int* cfg, int items) {
  const BpKernel kern = bp_instance(items);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = BP_SMEM_WORDS * sizeof(int);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        TG_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  cfg[0] = TG_THREADS * items;
  cfg[1] = per_sm;
  cfg[2] = sms;
  cfg[3] = (int)smem;
  return 0;
}

// One launch of `blocks` blocks (at most the resident grid of
// bsearch_probe_config, at most one a tile) over n queries, `items`
// queries a thread (the tile comes last in both entries).
extern "C" int bsearch_probe_launch(const int* pref, int np_len, int steps,
                                    const int* q, int* out, long long n,
                                    int blocks, int* stats, void* stream,
                                    int items) {
  if (n == 0) return (int)cudaGetLastError();
  const BpKernel kern = bp_instance(items);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  if (blocks < 1 || steps < 1 || steps > 30)
    return (int)cudaErrorInvalidConfiguration;
  kern<<<blocks, TG_THREADS, BP_SMEM_WORDS * sizeof(int),
         (cudaStream_t)stream>>>(pref, np_len, steps, q, out, n, stats);
  return (int)cudaGetLastError();
}
