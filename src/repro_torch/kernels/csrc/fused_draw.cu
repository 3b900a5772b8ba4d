// One launch from Threefry keys to the compacted sample rows: the sort-free
// EXPRACE draw (or flat PTBERN) plus the tree walk of every sampled
// position, for one key or a batch of B keys.
//
// Replaces fused_draw of src/repro/kernels/fused_draw.py (its _kernel,
// draw_core, _exprace_core, _ptbern_core and _count_le), which runs as
// grid=(1,), and fused_sample of the same file (its _sample_kernel: the
// draw without the walk, the paged draw's front end). Both are one kernel
// body here, fused_draw_kernel<WALK, ...>: fused_sample is the instance that
// writes each position and skips the walk, so the two give bit-equal
// positions under one key. The reference batches by vmapping the launch
// over its keys (QueryEngine.sample_batch); here a batch is one launch of
// the same kernel.
//
// The kernel runs on the whole card in one cooperative launch
// (cudaLaunchCooperativeKernel): the grid is the occupancy limit at the
// kernel's dynamic shared memory, cut to the blocks the batch's tiles can
// use. Every stage of the draw is a grid-wide phase; blocks loop over work
// items, each a (key, tile) pair of FD_TILE lanes of one key in key-major
// order, and phases are separated by fd_grid_sync, a barrier on one counter
// (cooperative groups' own barrier, written out so that the one set of
// build flags needs no -rdc). A single draw is the batch of one, its key
// passed by value. EXPRACE runs five barriers (six with the walk),
// whatever the batch:
//   1. Exp(1) gaps from the Threefry uniforms, each tile scanned in the
//      float32 order of scan.cuh: the tile-local prefixes, tile totals and
//      largest local prefixes;
//   2. one block a key: the tile carries (the chunked scan of the totals)
//      and the running max of the tiles before each tile;
//   3. arrivals = running max of (carry + prefix), cell placement, dedupe
//      (the cell before the tile is the previous tile's last, which it
//      publishes as soon as its cells are placed), and the unsigned and
//      signed counts U and S: their tile totals published and the totals of
//      the tiles before read back (a look-back);
//   4. per-root output and hit prefixes (outE, hitsE) over B x (R + 1)
//      root lanes;
//   5. the complement's carry-forward values, a running max with the same
//      look-back;
//   6. output slots; lane 0 of a key writes its count and overflow;
//   7. (WALK) the walk of each output lane, a phase of its own so that its
//      rows and locals are all that is live (the instance's registers).
// Flat PTBERN is one barrier (two with the walk): trials and the running
// count with its look-back, then compaction, then the walk.
//
// What bounds it, and the design. The draw reads a few parameter vectors
// and writes cap lanes a key, so its bytes bound is microseconds; what it
// takes is latency. Every search of the draw is a batch of ascending
// queries into an ascending vector (arrivals into the mass prefix, root
// boundaries into the cells, output lanes into the output prefix, hit
// ranks into U, complement ranks into gc; flat PTBERN's positions into the
// root prefix), and a lane that searches alone makes ~17 dependent loads
// that miss L2 once a batch's scratch outgrows it. So a tile searches
// together, as tree_get.cuh walks sorted probes:
//   * it reduces its used queries' min and max (not its first and last: a
//     lane whose result is not used, a padding lane or a complement root's
//     rank, is left out), two warps find their counts by a 32-ary search (a
//     ballot a round), and the slice between them, at most FD_SPAN words, is
//     copied into shared memory with cp.async (16-byte chunks through L2);
//     every lane then finishes its search there. A wider bracket (a sparse
//     draw, roots far apart) falls back to a per-lane descent bounded by
//     the bracket.
//   * a tile's first search whose queries are known before the tile (the
//     root boundaries of phase 4, the output lanes of phase 6) is bracketed
//     before the previous tile's last step (in phase 6 in one round with
//     that tile's last searches) and staged while that tile finishes, into
//     a buffer of its own. The read-only mass and root
//     prefixes have pivot tables in shared memory, so their brackets take
//     one round of the warp search.
//   * the walk of phase 7 is tree_get.cuh's tile walk (tg_search and
//     tg_edges) over the tile's ascending positions, with its pivot tables
//     loaded once a block; padding lanes take the rows of position n32 - 1,
//     walked once a block when first needed.
//   * integer carries across tiles are a look-back over the tiles' published
//     totals (exact in any order), so they cost no barrier of their own.
// Coherence: gid, U, S, gc, outE and hitsE are written by earlier phases of
// the same launch, so every load of them goes through L2 (__ldcg, cp.async
// .cg, relaxed loads of the look-back words), never the non-coherent path.
// The arena and the parameter vectors are read-only in the launch.
//
// Scratch is one allocation of fused_draw_scratch_words int32 words: a slab
// of the same layout for each key (offsets in 64 bits; every vector 16-byte
// aligned and padded to 4 words for the chunked copies), then the batch's
// look-back words and the barrier counter, zeroed by one memset before the
// launch. If the cooperative launch is refused, the launch function returns
// the error; nothing falls back to a smaller grid or to one launch a key.
//
// The float32 arrival sum is the only order-sensitive step. Its order is
// scan.cuh's at FD_THREADS x FD_ITEMS, which the plain version repeats
// (prefix_sum.py scan_order, called by fused_draw.py arrivals); it depends
// on the tile and never on the grid or the batch, and no work item mixes
// two keys, so lane b of a batch is bit-equal to a single launch under
// keys[b]. Built with -fmad=false and explicit round-to-nearest operations,
// so the kernel and the plain version agree bit for bit on the card. That
// order is not monotone: at a thread or tile boundary an element's sum is
// rounded along another path than its predecessor's, and after a tiny gap
// it can land an ulp below it. Arrivals must ascend (a dip places two
// arrivals' cells out of order), so a running max follows the sum; max, the
// integer sums and every search are exact in any order and any tiling.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

// The checked build (-DFD_CHECK_BOUNDS; fused_draw.py out_of_bounds): every
// __ldg and __ldcg of the launch, the walk's in tree_get.cuh included, and
// every cp.async source is held against the byte ranges of the launch's
// operands, which the host sets before it (fused_draw_check_set). A load
// outside them is not made (it reads 0) but counted, and the first
// FD_CHECK_RECORDS are kept as (address, bytes, source line)
// (fused_draw_check_get). The card has no tool here that catches an
// overread, and one past the end of its allocation faults only where the
// next page is unmapped, so it shows only now and then.
#ifdef FD_CHECK_BOUNDS
#define FD_CHECK_RANGES 24
#define FD_CHECK_RECORDS 64
__device__ unsigned long long fd_check_lo[FD_CHECK_RANGES];
__device__ unsigned long long fd_check_hi[FD_CHECK_RANGES];
__device__ int fd_check_n;
__device__ unsigned fd_check_count;
__device__ unsigned long long fd_check_rec[FD_CHECK_RECORDS][3];

__device__ __noinline__ void fd_check_fail(const void* p, int bytes,
                                           int line) {
  const unsigned k = atomicAdd(&fd_check_count, 1u);
  if (k < FD_CHECK_RECORDS) {
    fd_check_rec[k][0] = (unsigned long long)p;
    fd_check_rec[k][1] = (unsigned long long)bytes;
    fd_check_rec[k][2] = (unsigned long long)line;
  }
}

__device__ __forceinline__ bool fd_check(const void* p, int bytes, int line) {
  const unsigned long long a = (unsigned long long)p;
  for (int i = 0; i < fd_check_n; ++i)
    if (a >= fd_check_lo[i] && a + bytes <= fd_check_hi[i]) return true;
  fd_check_fail(p, bytes, line);
  return false;
}

template <typename T>
__device__ __forceinline__ T fd_checked_ldg(const T* p, int line) {
  return fd_check(p, sizeof(T), line) ? (__ldg)(p) : T();
}

template <typename T>
__device__ __forceinline__ T fd_checked_ldcg(const T* p, int line) {
  return fd_check(p, sizeof(T), line) ? (__ldcg)(p) : T();
}

#define __ldg(p) fd_checked_ldg((p), __LINE__)
#define __ldcg(p) fd_checked_ldcg((p), __LINE__)
#define FD_CHECKED(p, bytes) if (fd_check((p), (bytes), __LINE__))

// The operands' byte ranges [lo, hi) of the next launch, and a zero count.
extern "C" int fused_draw_check_set(const unsigned long long* lo,
                                    const unsigned long long* hi, int n) {
  if (n < 0 || n > FD_CHECK_RANGES) return (int)cudaErrorInvalidValue;
  const unsigned zero = 0;
  cudaError_t e = cudaMemcpyToSymbol(fd_check_lo, lo, 8 * n);
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(fd_check_hi, hi, 8 * n);
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(fd_check_n, &n, sizeof(int));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(fd_check_count, &zero, sizeof(unsigned));
  // landed before the launch, whatever stream it takes
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return (int)e;
}

// The last launch's count of loads outside the ranges and its records
// (FD_CHECK_RECORDS x 3 words), after the launch has finished.
extern "C" int fused_draw_check_get(unsigned* count, unsigned long long* rec) {
  cudaError_t e =
      cudaMemcpyFromSymbol(count, fd_check_count, sizeof(unsigned));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(rec, fd_check_rec, sizeof(fd_check_rec));
  return (int)e;
}
#else
#define FD_CHECKED(p, bytes)
#endif

#include "scan.cuh"
#include "threefry.cuh"
#include "tree_get.cuh"

#define FD_THREADS 256
#define FD_ITEMS 4
#define FD_TILE (FD_THREADS * FD_ITEMS)
#define FD_WARPS (FD_THREADS / 32)
// The widest slice a tile search stages (words); a buffer holds it with
// its 16-byte chunk edges.
#define FD_SPAN 3584
#define FD_BUF (FD_SPAN + 8)
// Shared words of the bracket rounds and the padding rows.
#define FD_SMALL 256
// Entries of the pivot tables of the mass and root prefixes.
#define FD_PIVOTS 1024
#define FD_EXPRACE 0
#define FD_PTBERN 1
// Blocks an SM an instance is built to hold at least, which sets its
// register budget (65,536 / (3 x FD_THREADS) = 80 registers a thread):
// fused_sample's instance and the walk's for up to 4 slots, whose rows and
// locals fit beside the draw's state at 80 registers with no spill. The
// 16-slot walk needs 128 and keeps 1.
#define FD_MIN_BLOCKS 3

static_assert(FD_THREADS == TG_THREADS, "the walk's tiles are the draw's");
static_assert(FD_SPAN >= TG_SPAN, "the walk stages in the draw's buffers");

static inline __host__ __device__ int fd_tiles(int lanes) {
  return (lanes + FD_TILE - 1) / FD_TILE;
}

static inline __host__ __device__ long long fd_pad4(long long n) {
  return (n + 3) & ~3LL;
}

// One key's device-memory scratch (a slab), carved from the int32 words.
struct FdScratch {
  int* gid;      // cells (lanes); flat PTBERN's running count
  int* U;        // running count of unique arrivals (lanes)
  int* S;        // running signed count (lanes)
  int* gc;       // complement carry-forward values (lanes); before phase
                 // 5 its words hold each lane's tile-local arrival prefix
                 // (phases 1-3), then its root (phases 3-5)
  int* outE;     // per-root output prefix (R + 1)
  int* hitsE;    // per-root hit prefix (R + 1)
  float* tot;    // per tile: float32 total,
  float* carry;  //   carry,
  float* pmax;   //   largest local prefix,
  float* cmax;   //   running max of the tiles before it;
  float* vlast;  // the last arrival
};

// int32 words of one key's slab (a multiple of 4).
static inline __host__ __device__ long long fd_slab_words(int lanes, int R) {
  return 4 * fd_pad4(lanes) + 2 * fd_pad4(R + 1) +
         fd_pad4(4LL * fd_tiles(lanes) + 1);
}

static inline __host__ __device__ FdScratch fd_carve(int* w, int lanes,
                                                     int R) {
  const int nt = fd_tiles(lanes);
  const long long pl = fd_pad4(lanes), pr = fd_pad4(R + 1);
  FdScratch s;
  s.gid = w;
  s.U = w + pl;
  s.S = w + 2 * pl;
  s.gc = w + 3 * pl;
  s.outE = w + 4 * pl;
  s.hitsE = s.outE + pr;
  s.tot = reinterpret_cast<float*>(s.hitsE + pr);
  s.carry = s.tot + nt;
  s.pmax = s.carry + nt;
  s.cmax = s.pmax + nt;
  s.vlast = s.cmax + nt;
  return s;
}

// The batch's slabs, then the look-back words (a 64-bit word a tile for the
// complement max, 32-bit words a tile for the counts and the last cell)
// and the barrier counter: the words a memset zeroes before each launch.
extern "C" long long fused_draw_scratch_words(int lanes, int R, int batch) {
  return (long long)batch * fd_slab_words(lanes, R) +
         4LL * batch * fd_tiles(lanes) + 1;
}

struct FdArgs {
  const int* arena;
  const float* massE;
  const float* lam;
  const int* sign;
  const int* w32;
  const int* prefE32;
  const int* cwE;
  const int* offE;
  const float* p32;
  const uint32_t* keys;  // (batch, 2) words, or null: the one key k0, k1
  int* rows;             // (batch, slots, cap)
  int* positions;        // (batch, cap)
  int* scalars;          // (batch, 2): count, overflow
  unsigned long long* stamps;  // phase clock (fd_stamp), or null
  unsigned long long* stats;   // [staged, fallback] tile searches, or null
  int* scratch;
  long long slab;                // int32 words a key
  unsigned long long* look_gc;   // (batch, tiles): flag | complement max
  unsigned* look_n;              // (batch, tiles): flag | U and S totals
  unsigned* look_g;              // (batch, tiles): flag | last cell
  unsigned* bar;                 // grid barrier counter, zero at launch
  uint32_t k0, k1;
  int method, batch, R, lanes, cap;
};

// Key b's scratch.
__device__ __forceinline__ FdScratch fd_slab(const FdArgs& a, int b) {
  return fd_carve(a.scratch + (long long)b * a.slab, a.lanes, a.R);
}

// Subkey of `stream` for key b.
__device__ __forceinline__ void fd_fold(const FdArgs& a, int b,
                                        uint32_t stream, uint32_t& s0,
                                        uint32_t& s1) {
  const uint32_t k0 = a.keys ? a.keys[2 * b] : a.k0;
  const uint32_t k1 = a.keys ? a.keys[2 * b + 1] : a.k1;
  rt_fold(k0, k1, stream, s0, s1);
}

// Every block of the grid waits here for every other (the cooperative
// launch keeps them all resident). Block 0 adds 2^31 - (blocks - 1), the
// others 1: the counter's top bit flips when the last block arrives, and
// its low bits return to 0 for the next barrier.
__device__ __forceinline__ void fd_grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned nb = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();
    const unsigned old = atomicAdd(bar, nb);
    unsigned cur;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(cur)
                   : "l"(bar)
                   : "memory");
    } while (((old ^ cur) & 0x80000000u) == 0);
    __threadfence();
  }
  __syncthreads();
}

// With a stamps vector (a measurement, off the draw path): block 0 records
// the global clock (ns) at the start and after each barrier, and every
// block raises the last entry to the time it finished.
__device__ __forceinline__ unsigned long long fd_clock() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void fd_stamp(unsigned long long* stamps, int k) {
  if (stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    stamps[k] = fd_clock();
}
__device__ __forceinline__ void fd_stamp_end(unsigned long long* stamps,
                                             int k) {
  __syncthreads();
  if (stamps != nullptr && threadIdx.x == 0) atomicMax(stamps + k, fd_clock());
}

// op over one value a thread, to every thread (op exact in any order).
template <typename T, class Op>
__device__ __forceinline__ T fd_block_reduce(T v, Op op, T* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v = op(v, __shfl_xor_sync(SC_FULL, v, o));
  __syncthreads();
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  T r = sh[0];
#pragma unroll
  for (int w = 1; w < FD_WARPS; ++w) r = op(r, sh[w]);
  __syncthreads();
  return r;
}

// Exclusive scans of two values a thread at once (exact in any order): x
// and y become this thread's exclusive prefixes, tx and ty the block's
// totals. One barrier; the caller syncs before sh is written again.
__device__ __forceinline__ void fd_block_excl2(int& x, int& y, int& tx,
                                               int& ty, int* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int vx = x, vy = y;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int ox = __shfl_up_sync(SC_FULL, vx, d);
    const int oy = __shfl_up_sync(SC_FULL, vy, d);
    if (lane >= d) {
      vx += ox;
      vy += oy;
    }
  }
  if (lane == 31) {
    sh[warp] = vx;
    sh[FD_WARPS + warp] = vy;
  }
  __syncthreads();
  int bx = 0, by = 0;
  tx = 0;
  ty = 0;
#pragma unroll
  for (int w = 0; w < FD_WARPS; ++w) {
    const int sx = sh[w], sy = sh[FD_WARPS + w];
    if (w < warp) {
      bx += sx;
      by += sy;
    }
    tx += sx;
    ty += sy;
  }
  x = bx + vx - x;
  y = by + vy - y;
}

// Two sums over one value a thread each, to every thread.
__device__ __forceinline__ void fd_block_sum2(int& x, int& y, int* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o /= 2) {
    x += __shfl_xor_sync(SC_FULL, x, o);
    y += __shfl_xor_sync(SC_FULL, y, o);
  }
  __syncthreads();
  if (lane == 0) {
    sh[warp] = x;
    sh[FD_WARPS + warp] = y;
  }
  __syncthreads();
  x = 0;
  y = 0;
#pragma unroll
  for (int w = 0; w < FD_WARPS; ++w) {
    x += sh[w];
    y += sh[FD_WARPS + w];
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Look-back words: a tile publishes its total (flag in the top bit) before
// it reads its predecessors', so waiting is on smaller work items only, and
// a block takes its items in ascending order: the smallest unfinished item
// always runs, and the resident cooperative grid cannot deadlock.
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned fd_wait32(const unsigned* p) {
  unsigned v;
  do {
    asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
                 : "=r"(v)
                 : "l"(p)
                 : "memory");
  } while ((v & 0x80000000u) == 0);
  return v;
}

__device__ __forceinline__ unsigned long long fd_wait64(
    const unsigned long long* p) {
  unsigned long long v;
  do {
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
                 : "=l"(v)
                 : "l"(p)
                 : "memory");
  } while ((v >> 63) == 0);
  return v;
}

// U and S totals of a tile (0..FD_TILE and -FD_TILE..FD_TILE) in one word.
__device__ __forceinline__ unsigned fd_pack_us(int u, int s) {
  return 0x80000000u | (unsigned)u | ((unsigned)(s + FD_TILE) << 11);
}

// Tile loads of the arrival scans.
struct LoadGap {  // Exp(1) gap of stream 0's uniform
  static constexpr bool kVec = false;
  uint32_t s0, s1;
  __device__ float operator()(long long i) const {
    return -log1pf(-rt_uniform_at(s0, s1, (uint32_t)i));
  }
};
struct LoadTileMax {  // the largest running sum of tile t
  static constexpr bool kVec = false;
  const float* carry;
  const float* pmax;
  __device__ float operator()(long long t) const {
    return __fadd_rn(carry[t], pmax[t]);
  }
};

// ---------------------------------------------------------------------------
// Asynchronous copies into shared memory.
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned fd_saddr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// 16 bytes through L2 (coherent with the launch's earlier phases).
__device__ __forceinline__ void fd_cp16(void* dst, const void* src) {
  FD_CHECKED(src, 16)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   fd_saddr(dst)),
               "l"(src)
               : "memory");
}
// 4 bytes: only for read-only operands (the arena, the parameter vectors).
__device__ __forceinline__ void fd_cp4(void* dst, const void* src) {
  FD_CHECKED(src, 4)
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   fd_saddr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void fd_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void fd_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x[s0, s1) into buf, x[i] at buf[i - (s0 & ~3)]: 16-byte chunks where x
// is aligned and the chunk lies within the `safe` words that may be read
// in chunks (a scratch vector's padded length), else word by word.
template <typename T>
__device__ __forceinline__ void fd_stage(int* buf, const T* x, int s0, int s1,
                                         int safe) {
  const int c0 = s0 >> 2, c1 = (s1 + 3) >> 2;
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  for (int c = c0 + (int)threadIdx.x; c < c1; c += FD_THREADS) {
    int* d = buf + 4 * (c - c0);
    const T* src = x + 4 * c;
    if (vec && 4 * c + 4 <= safe) {
      fd_cp16(d, src);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * c + e < s1) fd_cp4(d + e, src + e);
    }
  }
}

// ---------------------------------------------------------------------------
// The tile search: count_le(x, q) = #elements of the ascending x[0, len)
// that are <= q, for every used query of a block's tile.
// ---------------------------------------------------------------------------

template <typename T>
struct FdLim;
template <>
struct FdLim<int> {
  __device__ static int least() { return INT_MIN; }
  __device__ static int most() { return INT_MAX; }
};
template <>
struct FdLim<float> {
  __device__ static float least() { return -CUDART_INF_F; }
  __device__ static float most() { return CUDART_INF_F; }
};
__device__ __forceinline__ int fd_min(int a, int b) { return min(a, b); }
__device__ __forceinline__ int fd_max(int a, int b) { return max(a, b); }
__device__ __forceinline__ float fd_min(float a, float b) {
  return fminf(a, b);
}
__device__ __forceinline__ float fd_max(float a, float b) {
  return fmaxf(a, b);
}

// Steps of a descent whose answer lies in [0, W].
__device__ __forceinline__ int fd_bits(int W) {
  return W > 0 ? 32 - __clz(W) : 0;
}

// count_le over x[0, W) in shared memory.
template <typename T>
__device__ __forceinline__ int fd_count_sm(const T* x, int W, T q) {
  int p = 0;
  for (int k = fd_bits(W) - 1; k >= 0; --k) {
    const int cand = p + (1 << k);
    if (cand <= W && x[cand - 1] <= q) p = cand;
  }
  return p;
}

// count_le over x[0, W) in device memory, through L2 (the fallback).
template <typename T>
__device__ __forceinline__ int fd_count_gl(const T* x, int W, T q) {
  int p = 0;
  for (int k = fd_bits(W) - 1; k >= 0; --k) {
    const int cand = p + (1 << k);
    const T v = __ldcg(x + min(cand, W) - 1);
    if (cand <= W && v <= q) p = cand;
  }
  return p;
}

// count_le over x by the whole warp, known to lie in [lo, hi]: lanes
// 0..30 test evenly spaced elements, and a ballot keeps one segment (5 bits
// of the answer a dependent load).
template <typename T>
__device__ __forceinline__ int fd_warp_count(const T* x, int lo, int hi,
                                             T q) {
  const int lane = threadIdx.x & 31;
  while (hi > lo) {
    const int stride = (hi - lo + 31) >> 5;
    const int i = lo + (lane + 1) * stride - 1;
    const bool le = lane < 31 && i < hi && __ldcg(x + i) <= q;
    const int m = __popc(__ballot_sync(SC_FULL, le));
    if (m < 31) hi = min(hi, lo + (m + 1) * stride - 1);
    lo += m * stride;
  }
  return lo;
}

// One searched vector and, once bracketed, its tile's bracket: every used
// count lies in [lo, hi]; when staged, x[s0, hi) (s0 = max(lo - 1, 0), so
// that x[count - 1] is there too) sits at buf[i - base]. A read-only
// vector may have a pivot table in shared memory, piv[m] = x[m << psh] for
// m < np, which narrows each bracket end to 2^psh elements first.
template <typename T>
struct FdSearch {
  const T* x;
  int* buf;
  const T* piv;
  int len, safe, psh, np;
  int lo, hi, s0, base;
  bool any, staged;
};

template <typename T>
__device__ __forceinline__ FdSearch<T> fd_vec(const T* x, int len, int safe,
                                              int* buf,
                                              const T* piv = nullptr,
                                              int psh = 0) {
  FdSearch<T> v;
  v.x = x;
  v.buf = buf;
  v.piv = piv;
  v.len = len;
  v.safe = safe;
  v.psh = psh;
  v.np = ((len - 1) >> psh) + 1;
  v.lo = v.hi = v.s0 = v.base = 0;
  v.any = v.staged = false;
  return v;
}

// x[i] from the staged slice where it is there, else through L2.
template <typename T>
__device__ __forceinline__ T fd_at(const FdSearch<T>& v, int i) {
  if (v.staged && i >= v.s0 && i < v.hi)
    return reinterpret_cast<const T*>(v.buf)[i - v.base];
  return __ldcg(v.x + i);
}


// A searched vector's descriptor in shared memory (block-uniform values),
// where the warp that brackets it takes it by index: selecting among
// register copies by the warp's number would put them in local memory.
struct FdDesc {
  const void* x;
  const void* piv;
  int len, psh, np, pad;
};

// Shared memory of a block.
struct FdSm {
  int* buf0;  // the first search of a tile (prefetched)
  int* buf1;  // the tile's other searches; the walk's staging (tg buf0)
  int* buf2;  // the second vector of a pair; the walk's tg buf1
  int* red;   // [2][6][FD_WARPS] min / max rows of a bracket round
  FdDesc* desc;  // [3] the searched vectors of a round
  int* brk;   // [0, 6): brackets of up to three searches
  int* pad;   // [RT_MAX_SLOTS] rows of position n32 - 1, a ready flag,
              // then [RT_MAX_SLOTS] locals of that walk
  float* pmass;  // [FD_PIVOTS] pivots of the mass prefix
  int* ppref;    // [FD_PIVOTS] pivots of the root prefix
  int* qpos;     // [FD_TILE] the walk's query of each lane of a tile (the
                 // scan's staging words, free in the output phase)
  unsigned* tiles;  // [2] the block's staged and fallback tile searches
  int* piv;      // the walk's pivot tables
  TgShared tg;
};

// The rows of one bracket round: row 2s holds each warp's minimum of
// vector s's used queries, row 2s + 1 its maximum. Rounds alternate
// between two sets, so that a round's writes never meet the last one's
// reads.
template <typename T>
__device__ __forceinline__ T* fd_rows(int* red, int& phase) {
  T* r = reinterpret_cast<T*>(red + phase * 6 * FD_WARPS);
  phase ^= 1;
  return r;
}

// Each warp's min and max of each vector's used queries (lane 0 writes).
template <int NV, typename T, int N>
__device__ __forceinline__ void fd_partials(const T (&q)[NV][N],
                                            const bool (&use)[NV][N], T* r) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < NV; ++s) {
    T lo = FdLim<T>::most(), hi = FdLim<T>::least();
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (use[s][i]) {
        lo = fd_min(lo, q[s][i]);
        hi = fd_max(hi, q[s][i]);
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo = fd_min(lo, __shfl_xor_sync(SC_FULL, lo, o));
      hi = fd_max(hi, __shfl_xor_sync(SC_FULL, hi, o));
    }
    if (lane == 0) {
      r[2 * s * FD_WARPS + warp] = lo;
      r[(2 * s + 1) * FD_WARPS + warp] = hi;
    }
  }
}

// Vector s's query range given whole (from lo to hi; none when lo > hi),
// as its rows (one thread writes).
template <typename T>
__device__ __forceinline__ void fd_ends(T* r, int s, T lo, T hi) {
  if (threadIdx.x != 0) return;
#pragma unroll
  for (int w = 0; w < FD_WARPS; ++w) {
    r[2 * s * FD_WARPS + w] = w ? FdLim<T>::most() : lo;
    r[(2 * s + 1) * FD_WARPS + w] = w ? FdLim<T>::least() : hi;
  }
}

template <int NV, typename T>
__device__ __forceinline__ void fd_descs(const FdSearch<T> (&v)[NV],
                                         FdDesc* d) {
  if (threadIdx.x != 0) return;
#pragma unroll
  for (int s = 0; s < NV; ++s)
    d[s] = FdDesc{v[s].x, v[s].piv, v[s].len, v[s].psh, v[s].np, 0};
}

// After a barrier that published the rows and descriptors: warps 2s and
// 2s + 1 reduce vector s's min and max and find their counts (-1: no used
// query); one barrier; then every vector's bracket, and where it fits
// FD_SPAN the slice's copy (the copies are one group).
template <int NV, typename T>
__device__ __forceinline__ void fd_bracket(FdSearch<T> (&v)[NV], const T* r,
                                           const FdSm& sm) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < 2 * NV) {
    const int s = warp >> 1;
    T lo = lane < FD_WARPS ? r[2 * s * FD_WARPS + lane] : FdLim<T>::most();
    T hi = lane < FD_WARPS ? r[(2 * s + 1) * FD_WARPS + lane]
                           : FdLim<T>::least();
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo = fd_min(lo, __shfl_xor_sync(SC_FULL, lo, o));
      hi = fd_max(hi, __shfl_xor_sync(SC_FULL, hi, o));
    }
    int c = -1;
    if (lo <= hi) {
      const FdDesc d = sm.desc[s];
      const T q = (warp & 1) ? hi : lo;
      int a0 = 0, a1 = d.len;
      if (d.piv != nullptr) {
        const int m = fd_count_sm(static_cast<const T*>(d.piv), d.np, q);
        a0 = m > 0 ? ((m - 1) << d.psh) + 1 : 0;
        a1 = min(m << d.psh, d.len);
      }
      c = fd_warp_count(static_cast<const T*>(d.x), a0, a1, q);
    }
    if (lane == 0) sm.brk[warp] = c;
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < NV; ++s) {
    v[s].any = sm.brk[2 * s] >= 0;
    v[s].lo = max(sm.brk[2 * s], 0);
    v[s].hi = max(sm.brk[2 * s + 1], 0);
    v[s].s0 = max(v[s].lo - 1, 0);
    v[s].base = v[s].s0 & ~3;
    v[s].staged = v[s].any && v[s].hi - v[s].s0 <= FD_SPAN;
    if (v[s].staged) fd_stage(v[s].buf, v[s].x, v[s].s0, v[s].hi, v[s].safe);
    if (threadIdx.x == 0 && v[s].any) ++sm.tiles[v[s].staged ? 0 : 1];
  }
  fd_cp_commit();
}

// The tile's queries: rows and descriptors, one barrier, then the bracket
// and the copies.
template <int NV, typename T, int N>
__device__ __forceinline__ void fd_open(FdSearch<T> (&v)[NV],
                                        const T (&q)[NV][N],
                                        const bool (&use)[NV][N],
                                        const FdSm& sm, int& phase) {
  T* r = fd_rows<T>(sm.red, phase);
  fd_descs<NV, T>(v, sm.desc);
  fd_partials<NV, T, N>(q, use, r);
  __syncthreads();
  fd_bracket<NV, T>(v, r, sm);
}

// Wait for the slices (all but the WAITN most recent copy groups), then
// every used query's count; an unused query gets the bracket's low end.
template <int WAITN, int NV, typename T, int N>
__device__ __forceinline__ void fd_close(const FdSearch<T> (&v)[NV],
                                         const T (&q)[NV][N],
                                         const bool (&use)[NV][N],
                                         int (&out)[NV][N]) {
  bool staged = false;
#pragma unroll
  for (int s = 0; s < NV; ++s) staged |= v[s].staged;
  if (staged) {
    fd_cp_wait<WAITN>();
    __syncthreads();
  }
#pragma unroll
  for (int s = 0; s < NV; ++s) {
    const int W = v[s].hi - v[s].lo;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      int c = v[s].lo;
      if (use[s][i])
        c += v[s].staged
                 ? fd_count_sm(reinterpret_cast<const T*>(v[s].buf) +
                                   (v[s].lo - v[s].base),
                               W, q[s][i])
                 : fd_count_gl(v[s].x + v[s].lo, W, q[s][i]);
      out[s][i] = c;
    }
  }
}

// ---------------------------------------------------------------------------
// Shared memory.
// ---------------------------------------------------------------------------


// Words of the pivot tables of the layout (the walk only).
static inline __host__ __device__ int fd_pivot_words(const TgLayout& L) {
  int words = 0;
  for (int s = 0; s <= L.num_edges; ++s)
    words += tg_pivot_count(tg_steps(L, s));
  return words;
}

static inline size_t fd_smem_bytes(bool walk, const TgLayout& L) {
  return (size_t)(3 * FD_BUF + FD_SMALL + 2 * FD_PIVOTS +
                  (walk ? fd_pivot_words(L) : 0)) *
         sizeof(int);
}

extern __shared__ int4 fd_dyn[];

// Every region at a fixed offset of the dynamic shared memory; the
// kernel sets qpos.
__device__ __forceinline__ FdSm fd_shared() {
  int* w = reinterpret_cast<int*>(fd_dyn);
  FdSm sm;
  sm.buf0 = w;
  sm.buf1 = w + FD_BUF;
  sm.buf2 = w + 2 * FD_BUF;
  int* small = w + 3 * FD_BUF;
  sm.red = small;                                     // 96 words
  sm.desc = reinterpret_cast<FdDesc*>(small + 96);    // 24
  sm.brk = small + 120;                               // 8
  sm.pad = small + 128;               // 2 * RT_MAX_SLOTS + 1 (40)
  sm.tg.red = small + 168;            // 4 * TG_WARPS (32)
  sm.tg.bracket = small + 200;        // 2
  sm.tiles = reinterpret_cast<unsigned*>(small + 204);  // 2
  sm.tg.buf0 = sm.buf1;
  sm.tg.buf1 = sm.buf2;
  sm.pmass = reinterpret_cast<float*>(small + FD_SMALL);
  sm.ppref = small + FD_SMALL + FD_PIVOTS;
  sm.qpos = nullptr;
  sm.piv = sm.ppref + FD_PIVOTS;
  return sm;
}

// The pivot shift of the R + 1 entries of the mass and root prefixes: at
// most FD_PIVOTS pivots.
__device__ __forceinline__ int fd_psh(int R) {
  const int bits = 32 - __clz(R + 1);
  return bits > 10 ? bits - 10 : 0;
}

// The root prefix, searched with its pivot table.
__device__ __forceinline__ FdSearch<int> fd_pref_vec(const FdArgs& a,
                                                     const FdSm& sm) {
  return fd_vec(a.prefE32, a.R + 1, a.R + 1, sm.buf1, sm.ppref, fd_psh(a.R));
}

// ---------------------------------------------------------------------------
// The walk of an output tile (tree_get.cuh's tile walk).
// ---------------------------------------------------------------------------

// The walk of IW positions a thread: rows of every slot in registers.
template <int MAXS, int IW>
__device__ __forceinline__ void fd_walk_sub(const FdArgs& a,
                                            const TgLayout& L, const FdSm& sm,
                                            int& tph, const int (&q)[IW],
                                            int (&rows)[MAXS][IW]) {
  int locs[MAXS][IW];
  {
    int j[IW], aj[IW], unused[IW];
    tg_search<IW, false>(tg_vec(a.arena, L, 0, sm.piv), q, sm.tg, tph, j, aj,
                         unused);
#pragma unroll
    for (int it = 0; it < IW; ++it) {
      rows[0][it] = j[it];
      locs[0][it] = q[it] - aj[it];
    }
  }
  tg_edges<MAXS, IW, 0>(a.arena, L, sm.piv, sm.tg, tph, rows, locs);
}

// The rows of position n32 - 1 (a padding lane's), walked once a block
// when first needed, by one thread (rt_tree_walk's steps, its rows and
// locals in shared memory).
__device__ __forceinline__ void fd_pad_rows(const FdArgs& a,
                                            const TgLayout& L, const FdSm& sm,
                                            int n32) {
  // every thread reads the ready flag before thread 0 may set it
  if (__syncthreads_or(sm.pad[RT_MAX_SLOTS] != 0)) return;
  if (threadIdx.x == 0) {
    int* rows = sm.pad;
    int* locs = sm.pad + RT_MAX_SLOTS + 1;
    const int pos = n32 - 1;
    const int j = min(rt_descend(a.arena, 0, L.root_len, L.root_steps, pos),
                      L.n_root - 1);
    rows[0] = j;
    locs[0] = pos - __ldg(a.arena + j);
    for (int k = 0; k < L.num_edges; ++k) {
      const int* e = L.e[k];
      const int par = e[E_PARENT];
      const int prow = rows[par];
      const int w_safe = max(__ldg(a.arena + e[E_CW] + prow), 1);
      const int lp = locs[par];
      locs[par] = lp / w_safe;
      const int start = __ldg(a.arena + e[E_CS] + prow);
      const int target = __ldg(a.arena + e[E_CE] + start) + lp % w_safe;
      const int jj = min(rt_descend(a.arena, e[E_CE], e[E_NCHILD] + 1,
                                    e[E_STEPS], target),
                         e[E_NCHILD] - 1);
      rows[e[E_SLOT]] = __ldg(a.arena + e[E_PERM] + jj);
      locs[e[E_SLOT]] = target - __ldg(a.arena + e[E_CE] + jj);
    }
    sm.pad[RT_MAX_SLOTS] = 1;
  }
  __syncthreads();
}

// Rows of the output tile at `base` of key b: lane base + k * FD_THREADS +
// tid walks pos[k] when it is below count; the others take the padding
// rows and walk the tile's largest position meanwhile (positions ascend
// over a key's valid lanes, so its brackets stay narrow). Sub-tiles of
// IW x FD_THREADS lanes keep rows and locals in registers; each lane's
// query waits in shared memory (read back by the thread that wrote it), so
// the sub-tiles run as one loop.
template <int MAXS, int IW>
__device__ __forceinline__ void fd_walk(const FdArgs& a, const TgLayout& L,
                                        const FdSm& sm, int* shi, int& tph,
                                        int b, int base, int count, int n32,
                                        const int (&pos)[FD_ITEMS]) {
  const int tid = threadIdx.x;
  const int nvalid = min(max(count - base, 0), FD_TILE);
  int* rows = a.rows + (long long)b * (L.num_edges + 1) * a.cap;
  if (nvalid < FD_TILE) fd_pad_rows(a, L, sm, n32);
  if (nvalid == 0) {
#pragma unroll
    for (int k = 0; k < FD_ITEMS; ++k) {
      const int tt = base + k * FD_THREADS + tid;
#pragma unroll
      for (int s = 0; s < MAXS; ++s)
        if (s <= L.num_edges && tt < a.cap)
          rows[(long long)s * a.cap + tt] = sm.pad[s];
    }
    return;
  }
  int top = 0;
  if (nvalid < FD_TILE) {
    int m = INT_MIN;
#pragma unroll
    for (int k = 0; k < FD_ITEMS; ++k)
      if (base + k * FD_THREADS + tid < count) m = max(m, pos[k]);
    top = fd_block_reduce(m, MaxI(), shi);
  }
#pragma unroll
  for (int k = 0; k < FD_ITEMS; ++k)
    sm.qpos[k * FD_THREADS + tid] =
        base + k * FD_THREADS + tid < count ? min(pos[k], n32 - 1) : top;
#pragma unroll 1
  for (int sub = 0; sub < FD_ITEMS / IW; ++sub) {
    int q[IW], rw[MAXS][IW];
#pragma unroll
    for (int it = 0; it < IW; ++it)
      q[it] = sm.qpos[(sub * IW + it) * FD_THREADS + tid];
    fd_walk_sub<MAXS, IW>(a, L, sm, tph, q, rw);
#pragma unroll
    for (int it = 0; it < IW; ++it) {
      const int tt = base + (sub * IW + it) * FD_THREADS + tid;
#pragma unroll
      for (int s = 0; s < MAXS; ++s)
        if (s <= L.num_edges && tt < a.cap)
          rows[(long long)s * a.cap + tt] = tt < count ? rw[s][it] : sm.pad[s];
    }
  }
}

// Positions of an output tile (n32 past count) and lane 0's scalars.
__device__ __forceinline__ void fd_emit(const FdArgs& a, int b, int base,
                                        int count, int overflow,
                                        const int (&pos)[FD_ITEMS]) {
  int* P = a.positions + (long long)b * a.cap;
#pragma unroll
  for (int k = 0; k < FD_ITEMS; ++k) {
    const int tt = base + k * FD_THREADS + threadIdx.x;
    if (tt < a.cap) P[tt] = pos[k];
    if (tt == 0) {
      a.scalars[2 * b] = count;
      a.scalars[2 * b + 1] = overflow;
    }
  }
}

// The walk phase (WALK): every output tile's rows from its positions and
// its key's count, written by the output phase before the barrier. A phase
// of its own, so that little else is live beside the walk's rows and
// locals (the instance's register budget).
template <int MAXS, int IW>
__device__ __forceinline__ void fd_walk_phase(const FdArgs& a,
                                              const TgLayout& L,
                                              const FdSm& sm, int* shi) {
  const int n32 = __ldg(a.prefE32 + a.R);
  const int ot = fd_tiles(a.cap), oitems = a.batch * ot;
  int tph = 0;
  for (int w = blockIdx.x; w < oitems; w += gridDim.x) {
    const int b = w / ot, base = (w - b * ot) * FD_TILE;
    const int count = __ldcg(a.scalars + 2 * b);
    const int* P = a.positions + (long long)b * a.cap;
    int pos[FD_ITEMS];
#pragma unroll
    for (int k = 0; k < FD_ITEMS; ++k) {
      const int tt = base + k * FD_THREADS + threadIdx.x;
      pos[k] = tt < count ? __ldcg(P + tt) : n32;
    }
    fd_walk<MAXS, IW>(a, L, sm, shi, tph, b, base, count, n32, pos);
  }
}

// The bracket and copy of a first search whose queries ascend from qlo to
// qhi (none when qlo > qhi): a copy group of its own.
template <typename T>
__device__ __forceinline__ void fd_prefetch(FdSearch<T>& v, T qlo, T qhi,
                                            const FdSm& sm, int& phase) {
  FdSearch<T> vv[1] = {v};
  T* r = fd_rows<T>(sm.red, phase);
  fd_descs<1, T>(vv, sm.desc);
  fd_ends(r, 0, qlo, qhi);
  __syncthreads();
  fd_bracket<1, T>(vv, r, sm);
  v = vv[0];
}

// Output tile w's first search: the output lanes of key b (from qlo to
// qhi; none past the key's count) into its outE (EXPRACE), or into its
// running count (flat PTBERN); the slice goes to buf0.
template <bool PTBERN>
__device__ __forceinline__ FdSearch<int> fd_out_vec(const FdArgs& a, int w,
                                                    int ot, const FdSm& sm,
                                                    int& qlo, int& qhi) {
  const int b = w / ot, base = (w - b * ot) * FD_TILE;
  const FdScratch s = fd_slab(a, b);
  const int n = a.lanes;
  const int K = PTBERN ? __ldcg(s.gid + n - 1) : __ldcg(s.outE + a.R);
  const int count = min(K, a.cap);
  qlo = base < count ? base : INT_MAX;
  qhi = base < count ? min(base + FD_TILE, count) - 1 : INT_MIN;
  return PTBERN ? fd_vec(s.gid, n, (int)fd_pad4(n), sm.buf0)
                : fd_vec(s.outE, a.R + 1, (int)fd_pad4(a.R + 1), sm.buf0);
}

// fd_out_vec's bracket and copy on their own.
template <bool PTBERN>
__device__ __forceinline__ void fd_out_prefetch(const FdArgs& a, int w, int ot,
                                                const FdSm& sm,
                                                FdSearch<int>& v, int& phase) {
  int lo, hi;
  v = fd_out_vec<PTBERN>(a, w, ot, sm, lo, hi);
  fd_prefetch(v, lo, hi, sm, phase);
}

// Root tile w's search: key b's boundaries prefE32[j] - 1 of the tile's
// root lanes j (ascending in j) into its cells.
__device__ __forceinline__ void fd_root_prefetch(const FdArgs& a, int w,
                                                 int rt, const FdSm& sm,
                                                 FdSearch<int>& v, int& phase) {
  const int b = w / rt, jb = (w - b * rt) * FD_TILE;
  const int j1 = min(jb + FD_TILE, a.R + 1) - 1;
  v = fd_vec(fd_slab(a, b).gid, a.lanes, (int)fd_pad4(a.lanes), sm.buf0);
  fd_prefetch(v, __ldg(a.prefE32 + jb) - 1, __ldg(a.prefE32 + j1) - 1, sm,
              phase);
}

// ---------------------------------------------------------------------------
// Flat PTBERN over n = prefE32[R] lanes a key: one trial per flat position,
// a running count C, and lane tt = the first flat position with C == tt + 1.
// ---------------------------------------------------------------------------

template <bool WALK, int MAXS, int IW>
__device__ __forceinline__ void fd_ptbern(const FdArgs& a, const TgLayout& L,
                                          const FdSm& sm, int* shi) {
  const int tid = threadIdx.x, n = a.lanes, nt = fd_tiles(n), R = a.R;
  const int n32 = __ldg(a.prefE32 + R);
  const int items = a.batch * nt;
  int phase = 0;
  fd_stamp(a.stamps, 0);
  fd_cp_wait<0>();  // the pivot tables
  __syncthreads();
  int kb = -1;
  uint32_t s0 = 0, s1 = 0;
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const int b = w / nt, t = w - b * nt;
    if (b != kb) {
      fd_fold(a, b, 1u, s0, s1);
      kb = b;
    }
    const FdScratch s = fd_slab(a, b);
    const int i0 = t * FD_TILE + tid * FD_ITEMS;
    int q[1][FD_ITEMS], cnt[1][FD_ITEMS];
    bool use[1][FD_ITEMS];
#pragma unroll
    for (int i = 0; i < FD_ITEMS; ++i) {
      q[0][i] = i0 + i;
      use[0][i] = i0 + i < n;
    }
    FdSearch<int> v[1] = {fd_pref_vec(a, sm)};
    fd_open<1, int, FD_ITEMS>(v, q, use, sm, phase);
    fd_close<0, 1, int, FD_ITEMS>(v, q, use, cnt);
    int pre[FD_ITEMS], acc = 0;
#pragma unroll
    for (int i = 0; i < FD_ITEMS; ++i) {
      const int r = min(max(cnt[0][i] - 1, 0), R - 1);
      if (use[0][i])
        acc += rt_uniform_at(s0, s1, (uint32_t)(i0 + i)) < __ldg(a.p32 + r);
      pre[i] = acc;
    }
    int total;
    const int ex = sc_block_excl<FD_THREADS>(acc, 0, AddI(), shi, &total);
    unsigned* look = a.look_n + (long long)b * nt;
    if (tid == 0) atomicExch(look + t, 0x80000000u | (unsigned)total);
    int carry = 0, unused = 0;
    for (int k = tid; k < t; k += FD_THREADS)
      carry += fd_wait32(look + k) & 0x7ff;
    fd_block_sum2(carry, unused, shi);
    if (i0 + FD_ITEMS <= n) {
      *reinterpret_cast<int4*>(s.gid + i0) =
          make_int4(carry + ex + pre[0], carry + ex + pre[1],
                    carry + ex + pre[2], carry + ex + pre[3]);
    } else {
#pragma unroll
      for (int i = 0; i < FD_ITEMS; ++i)
        if (use[0][i]) s.gid[i0 + i] = carry + ex + pre[i];
    }
  }
  fd_grid_sync(a.bar);
  fd_stamp(a.stamps, 1);
  const int ot = fd_tiles(a.cap), oitems = a.batch * ot;
  FdSearch<int> pf = fd_vec(a.prefE32, 0, 0, sm.buf0);
  if ((int)blockIdx.x < oitems)
    fd_out_prefetch<true>(a, blockIdx.x, ot, sm, pf, phase);
  for (int w = blockIdx.x; w < oitems; w += gridDim.x) {
    const int b = w / ot, base = (w - b * ot) * FD_TILE;
    const FdScratch s = fd_slab(a, b);
    const int total = __ldcg(s.gid + n - 1);
    const int count = min(total, a.cap);
    int pos[FD_ITEMS];
    const FdSearch<int> cur[1] = {pf};
    if (base < count) {
      int q[1][FD_ITEMS], cnt[1][FD_ITEMS];
      bool use[1][FD_ITEMS];
#pragma unroll
      for (int k = 0; k < FD_ITEMS; ++k) {
        q[0][k] = base + k * FD_THREADS + tid;
        use[0][k] = q[0][k] < count;
      }
      fd_close<0, 1, int, FD_ITEMS>(cur, q, use, cnt);
#pragma unroll
      for (int k = 0; k < FD_ITEMS; ++k)
        pos[k] = use[0][k] ? min(cnt[0][k], n - 1) : n32;
    } else {
#pragma unroll
      for (int k = 0; k < FD_ITEMS; ++k) pos[k] = n32;
    }
    if (w + (int)gridDim.x < oitems)
      fd_out_prefetch<true>(a, w + gridDim.x, ot, sm, pf, phase);
    fd_emit(a, b, base, count, total > a.cap ? 1 : 0, pos);
  }
  if constexpr (WALK) {
    fd_grid_sync(a.bar);
    fd_stamp(a.stamps, 2);
    fd_walk_phase<MAXS, IW>(a, L, sm, shi);
    fd_stamp_end(a.stamps, 3);
  } else {
    fd_stamp_end(a.stamps, 2);
  }
}

// ---------------------------------------------------------------------------
// EXPRACE.
// ---------------------------------------------------------------------------

template <bool WALK, int MAXS, int IW>
__device__ __forceinline__ void fd_exprace(const FdArgs& a, const TgLayout& L,
                                           const FdSm& sm, float* smf,
                                           float* shf, int* shi) {
  const int tid = threadIdx.x, acap = a.lanes, R = a.R, nt = fd_tiles(acap);
  const int items = a.batch * nt;
  const int n32 = __ldg(a.prefE32 + R);
  const float Lam = __ldg(a.massE + R);
  const int lpad = (int)fd_pad4(acap);
  int* smi = reinterpret_cast<int*>(smf);
  int phase = 0;

  // 1. Arrivals: Exp(1) gaps, summed — a unit-rate Poisson process on
  // [0, Lam). Tile totals and largest local prefixes.
  fd_stamp(a.stamps, 0);
  int kb = -1;
  uint32_t s0 = 0, s1 = 0;
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const int b = w / nt, t = w - b * nt;
    if (b != kb) {
      fd_fold(a, b, 0u, s0, s1);
      kb = b;
    }
    const FdScratch s = fd_slab(a, b);
    const int base = t * FD_TILE;
    float pre[FD_ITEMS];
    const float total = sc_tile<FD_THREADS, FD_ITEMS>(
        LoadGap{s0, s1}, base, acap, 0.0f, AddF(), smf, shf, pre);
    const int i0 = base + tid * FD_ITEMS;
    float m = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < FD_ITEMS; ++i)
      if (i0 + i < acap) m = fmaxf(m, pre[i]);
    m = fd_block_reduce(m, MaxF(), shf);
    if (tid == 0) {
      s.tot[t] = total;
      s.pmax[t] = m;
    }
    // the tile-local prefixes wait in gc's words until phase 3
    float* v = reinterpret_cast<float*>(s.gc);
    if (i0 + FD_ITEMS <= acap) {
      *reinterpret_cast<float4*>(v + i0) =
          make_float4(pre[0], pre[1], pre[2], pre[3]);
    } else {
#pragma unroll
      for (int i = 0; i < FD_ITEMS; ++i)
        if (i0 + i < acap) v[i0 + i] = pre[i];
    }
  }
  fd_grid_sync(a.bar);
  fd_stamp(a.stamps, 1);

  // 2. One block a key: the tile carries, then the running max before each
  // tile (round-to-nearest is monotone, so carry + the largest local prefix
  // is the tile's largest running sum).
  for (int b = blockIdx.x; b < a.batch; b += gridDim.x) {
    const FdScratch s = fd_slab(a, b);
    sc_carries<FD_THREADS, FD_ITEMS>(LoadPtr<float>{s.tot}, nt, 0.0f, AddF(),
                                     s.carry, smf, shf);
    __syncthreads();
    sc_carries<FD_THREADS, FD_ITEMS>(LoadTileMax{s.carry, s.pmax}, nt,
                                     -CUDART_INF_F, MaxF(), s.cmax, smf, shf);
    __syncthreads();
  }
  fd_grid_sync(a.bar);
  fd_stamp(a.stamps, 2);

  // 3. Arrivals = running max of the running sum, cell placement (inverse
  // CDF into the mass prefix, by the tile), dedupe, and the counts U and S:
  // tile scans, then the totals of the tiles before (look-back).
  fd_cp_wait<0>();  // the pivot tables
  __syncthreads();
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const int b = w / nt, t = w - b * nt;
    const FdScratch s = fd_slab(a, b);
    const int base = t * FD_TILE, i0 = base + tid * FD_ITEMS;
    float pre[FD_ITEMS];
    if (i0 + FD_ITEMS <= acap) {
      const float4 p4 = __ldcg(reinterpret_cast<const float4*>(s.gc) +
                               (i0 >> 2));
      pre[0] = p4.x;
      pre[1] = p4.y;
      pre[2] = p4.z;
      pre[3] = p4.w;
    } else {
#pragma unroll
      for (int i = 0; i < FD_ITEMS; ++i)
        pre[i] = i0 + i < acap ? __ldcg(reinterpret_cast<const float*>(s.gc) +
                                        i0 + i)
                               : 0.0f;
    }
    const float carry = s.carry[t], cm = s.cmax[t];
    float run[FD_ITEMS], acc = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < FD_ITEMS; ++i) {
      const float x =
          i0 + i < acap ? __fadd_rn(carry, pre[i]) : -CUDART_INF_F;
      acc = fmaxf(acc, x);
      run[i] = acc;
    }
    float unused;
    const float ex =
        sc_block_excl<FD_THREADS>(acc, -CUDART_INF_F, MaxF(), shf, &unused);
    float q[1][FD_ITEMS];
    bool use[1][FD_ITEMS];
    int cnt[1][FD_ITEMS];
#pragma unroll
    for (int i = 0; i < FD_ITEMS; ++i) {
      q[0][i] = fmaxf(cm, fmaxf(ex, run[i]));
      use[0][i] = i0 + i < acap;
    }
    FdSearch<float> v[1] = {
        fd_vec(a.massE, R + 1, R + 1, sm.buf1, sm.pmass, fd_psh(R))};
    fd_open<1, float, FD_ITEMS>(v, q, use, sm, phase);
    fd_close<0, 1, float, FD_ITEMS>(v, q, use, cnt);
    int g[FD_ITEMS], r[FD_ITEMS];
#pragma unroll
    for (int i = 0; i < FD_ITEMS; ++i) {
      const float vi = q[0][i];
      r[i] = min(max(cnt[0][i] - 1, 0), R - 1);
      const float x = __fdiv_rn(__fsub_rn(vi, fd_at(v[0], r[i])),
                                fmaxf(__ldg(a.lam + r[i]), 1e-12f));
      int cell = (int)floorf(x);
      cell = min(max(cell, 0), max(__ldg(a.w32 + r[i]) - 1, 0));
      g[i] = use[0][i] && vi < Lam ? __ldg(a.prefE32 + r[i]) + cell : n32;
      if (i0 + i == acap - 1) *s.vlast = vi;
    }
    if (i0 + FD_ITEMS <= acap) {
      *reinterpret_cast<int4*>(s.gid + i0) = make_int4(g[0], g[1], g[2], g[3]);
    } else {
#pragma unroll
      for (int i = 0; i < FD_ITEMS; ++i)
        if (use[0][i]) s.gid[i0 + i] = g[i];
    }
    // Dedupe (>= 1 arrival in a cell is one success or failure). The cell
    // before lane i0: this thread's, the previous thread's (a shuffle, or
    // the previous warp's last in shared memory), or the previous tile's
    // last, which that tile publishes as soon as its cells are placed.
    unsigned* look_g = a.look_g + (long long)b * nt;
    {
      const int last = min(base + FD_TILE, acap) - 1;
#pragma unroll
      for (int i = 0; i < FD_ITEMS; ++i)
        if (i0 + i == last)
          atomicExch(look_g + t, 0x80000000u | (unsigned)g[i]);
    }
    const int lane = tid & 31, warp = tid >> 5;
    int prev = __shfl_up_sync(SC_FULL, g[FD_ITEMS - 1], 1);
    if (lane == 31) smi[warp] = g[FD_ITEMS - 1];
    __syncthreads();
    if (lane == 0)
      prev = warp > 0 ? smi[warp - 1]
                      : t > 0 ? (int)(fd_wait32(look_g + t - 1) & 0x7fffffffu)
                              : -1;
    // The counts U and S: a unique arrival's root segment is r, the root
    // its arrival was placed in (its cell lies in [prefE32[r],
    // prefE32[r + 1]), so the root prefix's search would return r).
    unsigned uq = 0;
    int au = 0, as = 0;
#pragma unroll
    for (int i = 0; i < FD_ITEMS; ++i) {
      if (use[0][i] && g[i] < n32 && g[i] != prev) {
        uq |= 1u << i;
        au += 1;
        as += __ldg(a.sign + r[i]);
      }
      prev = g[i];
    }
    // each lane's root waits in gc's words until phase 5
    if (i0 + FD_ITEMS <= acap) {
      *reinterpret_cast<int4*>(s.gc + i0) = make_int4(r[0], r[1], r[2], r[3]);
    } else {
#pragma unroll
      for (int i = 0; i < FD_ITEMS; ++i)
        if (use[0][i]) s.gc[i0 + i] = r[i];
    }
    int tu, ts, eu = au, es = as;
    fd_block_excl2(eu, es, tu, ts, shi);
    unsigned* look = a.look_n + (long long)b * nt;
    if (tid == 0) atomicExch(look + t, fd_pack_us(tu, ts));
    int cu = 0, cs = 0;
    for (int k = tid; k < t; k += FD_THREADS) {
      const unsigned f = fd_wait32(look + k);
      cu += (int)(f & 0x7ffu);
      cs += (int)((f >> 11) & 0xfffu) - FD_TILE;
    }
    fd_block_sum2(cu, cs, shi);
    int pu[FD_ITEMS], ps[FD_ITEMS];
    cu += eu;
    cs += es;
#pragma unroll
    for (int i = 0; i < FD_ITEMS; ++i) {
      if ((uq >> i) & 1u) {
        cu += 1;
        cs += __ldg(a.sign + r[i]);
      }
      pu[i] = cu;
      ps[i] = cs;
    }
    if (i0 + FD_ITEMS <= acap) {
      *reinterpret_cast<int4*>(s.U + i0) =
          make_int4(pu[0], pu[1], pu[2], pu[3]);
      *reinterpret_cast<int4*>(s.S + i0) =
          make_int4(ps[0], ps[1], ps[2], ps[3]);
    } else {
#pragma unroll
      for (int i = 0; i < FD_ITEMS; ++i)
        if (i0 + i < acap) {
          s.U[i0 + i] = pu[i];
          s.S[i0 + i] = ps[i];
        }
    }
  }
  fd_grid_sync(a.bar);
  fd_stamp(a.stamps, 3);

  // 4. Per-root output prefix (outE) and hit prefix (hitsE) via boundary
  // counts over the batch's B x (R + 1) root lanes: root j's boundary
  // prefE32[j] - 1 ascends in j, so each tile's bracket in gid is known
  // before the tile and staged while the previous tile finishes.
  {
    const int rt = fd_tiles(R + 1), ritems = a.batch * rt;
    FdSearch<int> pf = fd_vec(a.prefE32, 0, 0, sm.buf0);
    if ((int)blockIdx.x < ritems)
      fd_root_prefetch(a, blockIdx.x, rt, sm, pf, phase);
    for (int w = blockIdx.x; w < ritems; w += gridDim.x) {
      const int b = w / rt, jb = (w - b * rt) * FD_TILE;
      const FdScratch s = fd_slab(a, b);
      int q[1][FD_ITEMS], cnt[1][FD_ITEMS];
      bool use[1][FD_ITEMS];
#pragma unroll
      for (int k = 0; k < FD_ITEMS; ++k) {
        const int j = jb + k * FD_THREADS + tid;
        use[0][k] = j <= R;
        q[0][k] = use[0][k] ? __ldg(a.prefE32 + j) - 1 : 0;
      }
      const FdSearch<int> cur[1] = {pf};
      fd_close<0, 1, int, FD_ITEMS>(cur, q, use, cnt);
      // the next tile's copy lands in buf0 once every lane is past the
      // prefetch's barrier, so after this tile's searches
      if (w + (int)gridDim.x < ritems)
        fd_root_prefetch(a, w + gridDim.x, rt, sm, pf, phase);
#pragma unroll
      for (int k = 0; k < FD_ITEMS; ++k) {
        const int j = jb + k * FD_THREADS + tid, B = cnt[0][k];
        if (!use[0][k]) continue;
        s.outE[j] = __ldg(a.cwE + j) + (B > 0 ? __ldcg(s.S + B - 1) : 0);
        s.hitsE[j] = B > 0 ? __ldcg(s.U + B - 1) : 0;
      }
    }
  }
  fd_grid_sync(a.bar);
  fd_stamp(a.stamps, 4);

  // 5. Complement support: carry-forward g-values, kept ascending by a
  // running max (the tile's, then the tiles' before it by look-back). A
  // unique arrival's root segment is the root phase 3 left in gc's words.
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const int b = w / nt, t = w - b * nt;
    const FdScratch s = fd_slab(a, b);
    const int i0 = t * FD_TILE + tid * FD_ITEMS;
    int g[FD_ITEMS];
    bool use[FD_ITEMS];
    {
      // a thread wholly past acap reads no cell: its lanes are unused
      int prev = i0 > 0 && i0 <= acap ? __ldcg(s.gid + i0 - 1) : -1;
#pragma unroll
      for (int i = 0; i < FD_ITEMS; ++i) {
        g[i] = i0 + i < acap ? __ldcg(s.gid + i0 + i) : n32;
        use[i] = g[i] < n32 && g[i] != prev;
        prev = g[i];
      }
    }
    int run[FD_ITEMS], acc = INT_MIN;
#pragma unroll
    for (int i = 0; i < FD_ITEMS; ++i) {
      int gv = i0 + i < acap ? -(1 << 30) : INT_MIN;
      if (use[i]) {
        const int sg = __ldcg(s.gc + i0 + i);
        const int lrank = (__ldcg(s.U + i0 + i) - 1) - __ldcg(s.hitsE + sg);
        gv = (g[i] - __ldg(a.prefE32 + sg)) - lrank + __ldg(a.offE + sg);
      }
      acc = max(acc, gv);
      run[i] = acc;
    }
    int gm;
    const int ex = sc_block_excl<FD_THREADS>(acc, INT_MIN, MaxI(), shi, &gm);
    unsigned long long* look = a.look_gc + (long long)b * nt;
    if (tid == 0)
      atomicExch(look + t, (1ULL << 63) | (unsigned long long)(unsigned)gm);
    int before = INT_MIN;
    for (int k = tid; k < t; k += FD_THREADS)
      before = max(before, (int)(unsigned)fd_wait64(look + k));
    before = fd_block_reduce(before, MaxI(), shi);
    int out[FD_ITEMS];
#pragma unroll
    for (int i = 0; i < FD_ITEMS; ++i) out[i] = max(before, max(ex, run[i]));
    if (i0 + FD_ITEMS <= acap) {
      *reinterpret_cast<int4*>(s.gc + i0) =
          make_int4(out[0], out[1], out[2], out[3]);
    } else {
#pragma unroll
      for (int i = 0; i < FD_ITEMS; ++i)
        if (i0 + i < acap) s.gc[i0 + i] = out[i];
    }
  }
  fd_grid_sync(a.bar);
  fd_stamp(a.stamps, 5);

  // 6. Output slots (gather-only compaction) over the batch's output tiles,
  // then the walk of each position; lane 0 of a key writes its count and
  // overflow. A tile past the key's count emits padding without searching.
  const int ot = fd_tiles(a.cap), oitems = a.batch * ot;
  FdSearch<int> pf = fd_vec(a.prefE32, 0, 0, sm.buf0);
  if ((int)blockIdx.x < oitems)
    fd_out_prefetch<false>(a, blockIdx.x, ot, sm, pf, phase);
  for (int w = blockIdx.x; w < oitems; w += gridDim.x) {
    const int b = w / ot, base = (w - b * ot) * FD_TILE;
    const FdScratch s = fd_slab(a, b);
    const int K = __ldcg(s.outE + R);
    const int count = min(K, a.cap);
    const bool live = base < count;
    const FdSearch<int> cur[1] = {pf};
    // the next tile's output prefix: its bracket goes with this tile's pair
    // (one barrier), and its copy lands while this tile is walked
    int nlo = INT_MAX, nhi = INT_MIN;
    FdSearch<int> nx = pf;
    if (w + (int)gridDim.x < oitems)
      nx = fd_out_vec<false>(a, w + gridDim.x, ot, sm, nlo, nhi);
    // the tile's lanes: the output prefix search, then the pair of U (hit
    // ranks of direct roots) and gc (complement ranks); the root's other
    // values are read again after the pair, with its gathers
    int rO[FD_ITEMS], l[FD_ITEMS], q2[2][FD_ITEMS], c2[2][FD_ITEMS];
    bool u2[2][FD_ITEMS];
    FdSearch<int> v3[3] = {fd_vec(s.U, acap, lpad, sm.buf1),
                           fd_vec(s.gc, acap, lpad, sm.buf2), nx};
#pragma unroll
    for (int k = 0; k < FD_ITEMS; ++k) u2[0][k] = u2[1][k] = false;
    if (live) {
      int q[1][FD_ITEMS], cnt[1][FD_ITEMS];
      bool use[1][FD_ITEMS];
#pragma unroll
      for (int k = 0; k < FD_ITEMS; ++k) {
        q[0][k] = base + k * FD_THREADS + tid;
        use[0][k] = q[0][k] < count;
      }
      fd_close<0, 1, int, FD_ITEMS>(cur, q, use, cnt);
#pragma unroll
      for (int k = 0; k < FD_ITEMS; ++k) {
        rO[k] = min(max(cnt[0][k] - 1, 0), R - 1);
        l[k] = q[0][k] - fd_at(cur[0], rO[k]);
        const bool comp = __ldg(a.sign + rO[k]) < 0;
        q2[0][k] = __ldcg(s.hitsE + rO[k]) + l[k];
        q2[1][k] = l[k] + __ldg(a.offE + rO[k]);
        u2[0][k] = use[0][k] && !comp;
        u2[1][k] = use[0][k] && comp;
      }
    }
    // one round brackets the pair and the next tile's output prefix
    // (buf0 was read before its barrier)
    {
      int* r = fd_rows<int>(sm.red, phase);
      fd_descs<3, int>(v3, sm.desc);
      fd_partials<2, int, FD_ITEMS>(q2, u2, r);
      fd_ends(r, 2, nlo, nhi);
      __syncthreads();
      fd_bracket<3, int>(v3, r, sm);
    }
    pf = v3[2];
    const FdSearch<int> v2[2] = {v3[0], v3[1]};
    int pos[FD_ITEMS];
    if (live) {
      fd_close<0, 2, int, FD_ITEMS>(v2, q2, u2, c2);
#pragma unroll
      for (int k = 0; k < FD_ITEMS; ++k) {
        const int hO = __ldcg(s.hitsE + rO[k]);
        const int wm1 = max(__ldg(a.w32 + rO[k]) - 1, 0);
        const int p0 = __ldg(a.prefE32 + rO[k]);
        int local = 0;
        if (u2[0][k]) {
          local = __ldcg(s.gid + min(c2[0][k], acap - 1)) - p0;
        } else if (u2[1][k]) {
          const int Lq = c2[1][k];
          const int c = (Lq > 0 ? __ldcg(s.U + Lq - 1) : 0) - hO;
          local = l[k] + min(max(c, 0), wm1 - l[k] + 1);
        }
        pos[k] = u2[0][k] || u2[1][k] ? p0 + min(max(local, 0), wm1) : n32;
      }
    } else {
#pragma unroll
      for (int k = 0; k < FD_ITEMS; ++k) pos[k] = n32;
    }
    fd_emit(a, b, base, count, (*s.vlast < Lam || K > a.cap) ? 1 : 0, pos);
  }
  // 7. (WALK) the walk of every output lane.
  if constexpr (WALK) {
    fd_grid_sync(a.bar);
    fd_stamp(a.stamps, 6);
    fd_walk_phase<MAXS, IW>(a, L, sm, shi);
    fd_stamp_end(a.stamps, 7);
  } else {
    fd_stamp_end(a.stamps, 6);
  }
}

template <bool WALK, int MAXS, int IW>
__global__ void __launch_bounds__(FD_THREADS,
                                  MAXS <= 4 ? FD_MIN_BLOCKS : 1)
    fused_draw_kernel(
    const __grid_constant__ FdArgs a, const __grid_constant__ TgLayout L) {
  __shared__ uint32_t smw[SC_PAD(FD_TILE)];
  __shared__ uint32_t shw[FD_THREADS];
  float* smf = reinterpret_cast<float*>(smw);
  float* shf = reinterpret_cast<float*>(shw);
  int* shi = reinterpret_cast<int*>(shw);
  FdSm sm = fd_shared();
  sm.qpos = reinterpret_cast<int*>(smw);
  if (threadIdx.x == 0) {
    sm.pad[RT_MAX_SLOTS] = 0;
    sm.tiles[0] = sm.tiles[1] = 0;
  }
  {
    // pivot tables of the two read-only prefixes (a copy group)
    const int psh = fd_psh(a.R), np = (a.R >> psh) + 1;
    for (int m = threadIdx.x; m < np; m += FD_THREADS) {
      fd_cp4(sm.pmass + m, a.massE + (m << psh));
      fd_cp4(sm.ppref + m, a.prefE32 + (m << psh));
    }
  }
  if constexpr (WALK) {
    // the pivot tables of the walk, once a block: a copy group that lands
    // during the draw's phases (the arena is read-only)
    int words = 0;
    for (int s = 0; s <= L.num_edges; ++s) {
      const TgVec v = tg_vec(a.arena, L, s, sm.piv);
      const int count = tg_pivot_count(v.steps);
      for (int i = threadIdx.x; i < count; i += FD_THREADS)
        fd_cp4(sm.piv + words + i, v.a + min(i << v.sh, v.len - 1));
      words += count;
    }
    fd_cp_commit();
  }
  if (a.method == FD_PTBERN)
    fd_ptbern<WALK, MAXS, IW>(a, L, sm, shi);
  else
    fd_exprace<WALK, MAXS, IW>(a, L, sm, smf, shf, shi);
  if (a.stats != nullptr && threadIdx.x == 0) {
    atomicAdd(a.stats, (unsigned long long)sm.tiles[0]);
    atomicAdd(a.stats + 1, (unsigned long long)sm.tiles[1]);
  }
}

using FdKernel = decltype(&fused_draw_kernel<false, 1, 1>);

// The instance: fused_sample's, or the walk's for `slots` tree nodes, whose
// sub-tiles of IW x FD_THREADS lanes keep 2 x MAXS x IW rows and locals in
// registers: 4 lanes a thread up to 4 slots, else 1.
static FdKernel fd_instance(bool walk, int slots) {
  if (!walk) return fused_draw_kernel<false, 1, 1>;
  if (slots <= 4) return fused_draw_kernel<true, 4, 4>;
  return fused_draw_kernel<true, RT_MAX_SLOTS, 1>;
}

// Blocks a multiprocessor holds of `kern` at `smem` dynamic bytes, and
// the multiprocessors, on the current card. The dynamic shared memory limit
// is an attribute of the function in the current card's context, so it is
// set on every call above 48 KB (as tree_get.cu does) and the occupancy is
// asked at the limit just set.
static cudaError_t fd_occupancy(FdKernel kern, size_t smem, int& per_sm,
                                int& sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      FD_THREADS, smem);
  if (e != cudaSuccess) return e;
  return per_sm == 0 ? cudaErrorCooperativeLaunchTooLarge : cudaSuccess;
}

// The grid of one launch: the occupancy limit (blocks a multiprocessor
// holds x multiprocessors), cut to the blocks the batch's tiles can use
// (arrival, root and output tiles). grid = [blocks an SM, SMs, blocks,
// dynamic shared memory bytes].
static cudaError_t fd_grid(bool walk, const TgLayout& L, int lanes, int cap,
                           int R, int batch, int grid[4]) {
  const FdKernel kern = fd_instance(walk, L.num_edges + 1);
  const size_t smem = fd_smem_bytes(walk, L);
  int per_sm = 0, sms = 0;
  const cudaError_t e = fd_occupancy(kern, smem, per_sm, sms);
  if (e != cudaSuccess) return e;
  const long long tiles = (long long)batch * fd_tiles(lanes);
  const long long roots = (long long)batch * fd_tiles(R + 1);
  const long long outs = (long long)batch * fd_tiles(cap);
  long long need = tiles > roots ? tiles : roots;
  need = need > outs ? need : outs;
  const long long most = (long long)per_sm * sms;
  grid[0] = per_sm;
  grid[1] = sms;
  grid[2] = (int)(need < 1 ? 1 : need > most ? most : need);
  grid[3] = (int)smem;
  return cudaSuccess;
}

static int fd_launch(bool walk, const FdArgs& a, const TgLayout& L,
                     void* stream) {
  int grid[4];
  cudaError_t e = fd_grid(walk, L, a.lanes, a.cap, a.R, a.batch, grid);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  // the look-back words and the barrier counter
  const size_t zero = (4LL * a.batch * fd_tiles(a.lanes) + 1) * sizeof(int);
  e = cudaMemsetAsync(a.look_gc, 0, zero, s);
  if (e != cudaSuccess) return (int)e;
  void* params[] = {const_cast<FdArgs*>(&a), const_cast<TgLayout*>(&L)};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(fd_instance(walk, L.num_edges + 1)),
      dim3(grid[2]), dim3(FD_THREADS), params, (size_t)grid[3], s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Blocks a multiprocessor holds, multiprocessors, the grid of a launch at
// these sizes and its dynamic shared memory bytes (walk: the fused_draw
// instance for the layout's `table`, else fused_sample's; table may then
// be null).
extern "C" int fused_draw_grid(int walk, int lanes, int cap, int R, int batch,
                               const int* table, int* out) {
  TgLayout L = {};
  if (walk) L = tg_layout_from_table(table);
  return (int)fd_grid(walk != 0, L, lanes, cap, R, batch, out);
}

static FdArgs fd_args(const int* arena, const unsigned* keys, int batch,
                      unsigned k0, unsigned k1, int method,
                      const float* massE, const float* lam, const int* sign,
                      const int* w32, const int* prefE32, const int* cwE,
                      const int* offE, const float* p32, int R, int lanes,
                      int cap, int* rows, int* positions, int* scalars,
                      int* scratch, unsigned long long* stamps,
                      unsigned long long* stats) {
  FdArgs a;
  a.arena = arena;
  a.massE = massE;
  a.lam = lam;
  a.sign = sign;
  a.w32 = w32;
  a.prefE32 = prefE32;
  a.cwE = cwE;
  a.offE = offE;
  a.p32 = p32;
  a.keys = keys;
  a.rows = rows;
  a.positions = positions;
  a.scalars = scalars;
  a.stamps = stamps;
  a.stats = stats;
  a.scratch = scratch;
  a.slab = fd_slab_words(lanes, R);
  const long long look = (long long)batch * a.slab;
  const long long nt = (long long)batch * fd_tiles(lanes);
  a.look_gc = reinterpret_cast<unsigned long long*>(scratch + look);
  a.look_n = reinterpret_cast<unsigned*>(scratch + look + 2 * nt);
  a.look_g = reinterpret_cast<unsigned*>(scratch + look + 3 * nt);
  a.bar = reinterpret_cast<unsigned*>(scratch + look + 4 * nt);
  a.k0 = k0;
  a.k1 = k1;
  a.method = method;
  a.batch = batch;
  a.R = R;
  a.lanes = lanes;
  a.cap = cap;
  return a;
}

// keys: null for one key given as k0, k1 (batch 1), else `batch` keys as
// (batch, 2) uint32 words on the device. `lanes` is acap for EXPRACE and
// the join size n for flat PTBERN; scratch holds
// fused_draw_scratch_words(lanes, R, batch) int32 words (16-byte aligned).
// rows, positions and scalars are (batch, slots, cap), (batch, cap) and
// (batch, 2). stamps: null, or 8 zeroed words (EXPRACE; 4 for flat PTBERN;
// one fewer without the walk) for the phase clock; stats: null, or 2
// zeroed words that take the staged and fallback tile searches.
extern "C" int fused_draw_launch(
    const int* arena, const int* table, const unsigned* keys, int batch,
    unsigned k0, unsigned k1, int method, const float* massE,
    const float* lam, const int* sign, const int* w32, const int* prefE32,
    const int* cwE, const int* offE, const float* p32, int R, int lanes,
    int cap, int* rows, int* positions, int* scalars, int* scratch,
    unsigned long long* stamps, unsigned long long* stats, void* stream) {
  const TgLayout L = tg_layout_from_table(table);
  const FdArgs a = fd_args(arena, keys, batch, k0, k1, method, massE, lam,
                           sign, w32, prefE32, cwE, offE, p32, R, lanes, cap,
                           rows, positions, scalars, scratch, stamps, stats);
  return fd_launch(true, a, L, stream);
}

// The draw without the walk: positions, count and overflow only. The
// kernel reads no arena and no layout.
extern "C" int fused_sample_launch(
    const unsigned* keys, int batch, unsigned k0, unsigned k1, int method,
    const float* massE, const float* lam, const int* sign, const int* w32,
    const int* prefE32, const int* cwE, const int* offE, const float* p32,
    int R, int lanes, int cap, int* positions, int* scalars, int* scratch,
    unsigned long long* stamps, unsigned long long* stats, void* stream) {
  const TgLayout L = {};
  const FdArgs a = fd_args(nullptr, keys, batch, k0, k1, method, massE, lam,
                           sign, w32, prefE32, cwE, offE, p32, R, lanes, cap,
                           nullptr, positions, scalars, scratch, stamps,
                           stats);
  return fd_launch(false, a, L, stream);
}

// The Threefry uniforms of one stream, on their own: lets a check hold the
// device cipher against its plain version. Not on the draw path.
__global__ void threefry_uniforms_kernel(uint32_t k0, uint32_t k1,
                                         uint32_t stream_id,
                                         float* __restrict__ out, int n) {
  uint32_t s0, s1;
  rt_fold(k0, k1, stream_id, s0, s1);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    out[i] = rt_uniform_at(s0, s1, (uint32_t)i);
}

extern "C" int threefry_uniforms_launch(unsigned k0, unsigned k1,
                                        unsigned stream_id, float* out, int n,
                                        void* stream) {
  if (n == 0) return (int)cudaGetLastError();
  int blocks = (n + 255) / 256;
  if (blocks > 132 * 32) blocks = 132 * 32;
  threefry_uniforms_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      k0, k1, stream_id, out, n);
  return (int)cudaGetLastError();
}
