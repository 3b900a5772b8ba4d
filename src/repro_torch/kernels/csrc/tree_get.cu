// The USR GET kernel (tree_get.cuh has the design and what bounds it).
//
// Replaces tree_probe, _paged_launches (the port's default on CUDA) and
// _paged_dma of src/repro/kernels/tree_probe.py. One launch resolves every
// probe to the row of every slot, over the whole arena, a paged arena's
// buffer or its stacked pages (the table's bases say which).
//
// The kernel is instantiated by the number of slots it keeps in registers
// and the probes a thread walks (the tile: TG_THREADS x items probes, the
// tuning's block_rows / 2 items). A tree of up to 4 slots takes 1, 2, 4 or
// 8 probes a thread, up to 8 slots 1 or 2, up to 16 slots 1, so that rows
// and locals stay in registers; a launch asks for its items, the wrapper
// having cut them to tg_max_items(slots).
#include <cuda_runtime.h>

// The checked build (-DTG_CHECK_BOUNDS; tree_probe.py out_of_bounds): every
// __ldg of the launch (the pivot tables, the warp searches, the staged
// slices, the per-lane descents and gathers, the probes) and every store of
// a row is held against the byte ranges of the launch's operands, which the
// host sets before it (tree_get_check_set). An access outside them is not
// made (a load reads 0) but counted, and the first TG_CHECK_RECORDS are kept
// as (address, bytes, source line) (tree_get_check_get). The kernel is
// otherwise this one: the same instances, tiles and launch shapes.
#ifdef TG_CHECK_BOUNDS
#define TG_CHECK_RANGES 8
#define TG_CHECK_RECORDS 64
__device__ unsigned long long tg_check_lo[TG_CHECK_RANGES];
__device__ unsigned long long tg_check_hi[TG_CHECK_RANGES];
__device__ int tg_check_n;
__device__ unsigned tg_check_count;
__device__ unsigned long long tg_check_rec[TG_CHECK_RECORDS][3];

__device__ __noinline__ void tg_check_fail(const void* p, int bytes,
                                           int line) {
  const unsigned k = atomicAdd(&tg_check_count, 1u);
  if (k < TG_CHECK_RECORDS) {
    tg_check_rec[k][0] = (unsigned long long)p;
    tg_check_rec[k][1] = (unsigned long long)bytes;
    tg_check_rec[k][2] = (unsigned long long)line;
  }
}

__device__ __forceinline__ bool tg_check(const void* p, int bytes, int line) {
  const unsigned long long a = (unsigned long long)p;
  for (int i = 0; i < tg_check_n; ++i)
    if (a >= tg_check_lo[i] && a + bytes <= tg_check_hi[i]) return true;
  tg_check_fail(p, bytes, line);
  return false;
}

template <typename T>
__device__ __forceinline__ T tg_checked_ldg(const T* p, int line) {
  return tg_check(p, sizeof(T), line) ? (__ldg)(p) : T();
}

#define __ldg(p) tg_checked_ldg((p), __LINE__)
#define TG_STORE_OK(p) tg_check((p), 4, __LINE__)

// The operands' byte ranges [lo, hi) of the next launch, and a zero count.
extern "C" int tree_get_check_set(const unsigned long long* lo,
                                  const unsigned long long* hi, int n) {
  if (n < 0 || n > TG_CHECK_RANGES) return (int)cudaErrorInvalidValue;
  const unsigned zero = 0;
  cudaError_t e = cudaMemcpyToSymbol(tg_check_lo, lo, 8 * n);
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(tg_check_hi, hi, 8 * n);
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(tg_check_n, &n, sizeof(int));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(tg_check_count, &zero, sizeof(unsigned));
  // landed before the launch, whatever stream it takes
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return (int)e;
}

// The last launch's count of accesses outside the ranges and its records
// (TG_CHECK_RECORDS x 3 words), after the launch has finished.
extern "C" int tree_get_check_get(unsigned* count, unsigned long long* rec) {
  cudaError_t e =
      cudaMemcpyFromSymbol(count, tg_check_count, sizeof(unsigned));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(rec, tg_check_rec, sizeof(tg_check_rec));
  return (int)e;
}
#endif

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

// An instance for MAXS slots and ITEMS probes a thread at MINB resident
// blocks an SM at least, which bounds its registers (65,536 / (MINB x
// 256)): 5 blocks at 48 registers for up to 4 slots and 4 items, 2 at 128
// for 8 items, 4 at 64 for 1 or 2 items (3 slots and 2 items spill at 48)
// and for 8 slots, 1 for 16, whose 32 rows and locals would spill under a
// tighter bound. ptxas's own choice without
// MINB is 40 registers for 3 slots, which runs A's full join 5% slower.
template <int MAXS, int ITEMS, int MINB>
__global__ void __launch_bounds__(TG_THREADS, MINB)
    tree_get_kernel(const int* __restrict__ arena,
                    const __grid_constant__ TgLayout L,
                    const int* __restrict__ q, int* __restrict__ out,
                    long long n) {
  tg_run<MAXS, ITEMS>(arena, L, q, out, n);
}

using TgKernel = decltype(&tree_get_kernel<2, TG_ITEMS, 5>);

// The instance for MAXS slots and `items` probes a thread (null if none).
template <int MAXS>
static TgKernel tg_items(int items) {
  constexpr int MINB = MAXS <= 8 ? 4 : 1;
  if (items == 1) return tree_get_kernel<MAXS, 1, MINB>;
  if constexpr (MAXS <= 8) {
    if (items == 2) return tree_get_kernel<MAXS, 2, MINB>;
  }
  if constexpr (MAXS <= 4) {
    if (items == 4) return tree_get_kernel<MAXS, 4, 5>;
    if (items == 8) return tree_get_kernel<MAXS, 8, 2>;
  }
  return nullptr;
}

// The instance for `slots` tree nodes walking `items` probes a thread, or
// null when that tree takes no such tile (items above tg_max_items).
static TgKernel tg_instance(int slots, int items) {
  if (items > tg_max_items(slots)) return nullptr;
  if (slots <= 2) return tg_items<2>(items);
  if (slots <= 3) return tg_items<3>(items);
  if (slots <= 4) return tg_items<4>(items);
  if (slots <= 8) return tg_items<8>(items);
  return tg_items<16>(items);
}

// The launch shape on the current device for `items` probes a thread:
// cfg = [probes a thread, blocks an SM, SMs, shared memory bytes]. A launch
// takes at most blocks an SM x SMs blocks (the persistent grid). Returns a
// CUDA error code (cudaErrorInvalidValue for a tile the tree cannot take).
extern "C" int tree_get_config(const int* table, int* cfg, int items) {
  const TgLayout L = tg_layout_from_table(table);
  const TgKernel kern = tg_instance(L.num_edges + 1, items);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
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
// resident grid, at most one a tile of TG_THREADS x items) over n probes
// (the tile comes last in both entries).
extern "C" int tree_get_launch(const int* arena, const int* table,
                               const int* q, int* out, long long n,
                               int blocks, void* stream, int items) {
  if (n == 0) return (int)cudaGetLastError();
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  const TgLayout L = tg_layout_from_table(table);
  const TgKernel kern = tg_instance(L.num_edges + 1, items);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
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
