// The USR GET kernel (tree_get.cuh has the design and what bounds it).
//
// Replaces tree_probe, _paged_launches (the port's default on CUDA) and
// _paged_dma of src/repro/kernels/tree_probe.py. One launch resolves every
// probe to the row of every slot, over the whole arena, a paged arena's
// buffer or its stacked pages (the table's bases say which).
//
// The kernel is instantiated by the number of slots it keeps in registers:
// a tree of up to 4 slots walks 4 probes a thread, up to 8 slots 2, up to
// 16 slots 1, so that rows and locals stay in registers.
#include <cuda_runtime.h>

#include "tree_get.cuh"

// Every tile by a persistent grid: the pivot tables once, then the tiles.
template <int MAXS, int ITEMS>
__device__ __forceinline__ void tg_run(const int* __restrict__ arena,
                                       const TgLayout& L,
                                       const int* __restrict__ q,
                                       int* __restrict__ out, long long n) {
  extern __shared__ int tg_smem[];
  int words = 0;
  for (int s = 0; s <= L.num_edges; ++s) {
    const TgVec v = tg_vec(arena, L, s, tg_smem);
    const int count = tg_pivot_count(v.steps);
    for (int i = threadIdx.x; i < count; i += TG_THREADS)
      tg_smem[words + i] = __ldg(v.a + min(i << v.sh, v.len - 1));
    words += count;
  }
  TgShared sm;
  sm.buf0 = tg_smem + words;
  sm.buf1 = sm.buf0 + TG_SPAN;
  sm.red = sm.buf1 + TG_SPAN;
  sm.bracket = sm.red + 4 * TG_WARPS;
  __syncthreads();
  const long long tile = TG_THREADS * ITEMS;
  const long long tiles = (n + tile - 1) / tile;
  int phase = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x)
    tg_tile<MAXS, ITEMS>(arena, L, q, out, n, t * tile, tg_smem, sm, phase);
}

// An instance for MAXS slots at MINB resident blocks an SM at least, which
// bounds its registers (65,536 / (MINB x 256)): 5 blocks at 48 registers
// for up to 4 slots, 4 at 64 for 8, 1 for 16, whose 32 rows and locals
// would spill under a tighter bound. ptxas's own choice without MINB is
// 40 registers for 3 slots, which runs A's full join 5% slower.
template <int MAXS, int ITEMS, int MINB>
__global__ void __launch_bounds__(TG_THREADS, MINB)
    tree_get_kernel(const int* __restrict__ arena,
                    const __grid_constant__ TgLayout L,
                    const int* __restrict__ q, int* __restrict__ out,
                    long long n) {
  tg_run<MAXS, ITEMS>(arena, L, q, out, n);
}

using TgKernel = decltype(&tree_get_kernel<2, 4, 5>);

// The instance for `slots` tree nodes and the probes a thread it walks.
static TgKernel tg_instance(int slots, int& items) {
  items = slots <= 4 ? 4 : slots <= 8 ? 2 : 1;
  if (slots <= 2) return tree_get_kernel<2, 4, 5>;
  if (slots <= 3) return tree_get_kernel<3, 4, 5>;
  if (slots <= 4) return tree_get_kernel<4, 4, 5>;
  if (slots <= 8) return tree_get_kernel<8, 2, 4>;
  return tree_get_kernel<16, 1, 1>;
}

// The launch shape on the current device: cfg = [probes a thread, blocks
// an SM, SMs, shared memory bytes]. A launch takes at most blocks an SM x
// SMs blocks (the persistent grid). Returns a CUDA error code.
extern "C" int tree_get_config(const int* table, int* cfg) {
  const TgLayout L = tg_layout_from_table(table);
  int items;
  const TgKernel kern = tg_instance(L.num_edges + 1, items);
  const size_t smem = tg_smem_bytes(L);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        TG_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  cfg[0] = items;
  cfg[1] = per_sm;
  cfg[2] = sms;
  cfg[3] = (int)smem;
  return 0;
}

// One launch of `blocks` blocks (the caller's share of tree_get_config's
// resident grid, at most one a tile) over n probes.
extern "C" int tree_get_launch(const int* arena, const int* table,
                               const int* q, int* out, long long n,
                               int blocks, void* stream) {
  if (n == 0) return (int)cudaGetLastError();
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  const TgLayout L = tg_layout_from_table(table);
  int items;
  const TgKernel kern = tg_instance(L.num_edges + 1, items);
  const size_t smem = tg_smem_bytes(L);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<blocks, TG_THREADS, smem, (cudaStream_t)stream>>>(arena, L, q, out,
                                                          n);
  return (int)cudaGetLastError();
}
