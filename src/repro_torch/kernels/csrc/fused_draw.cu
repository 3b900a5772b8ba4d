// One launch from Threefry keys to the compacted sample rows: the sort-free
// EXPRACE draw (or flat PTBERN) plus the tree walk of every sampled
// position, for one key or a batch of B keys.
//
// Replaces fused_draw of src/repro/kernels/fused_draw.py (its _kernel,
// draw_core, _exprace_core, _ptbern_core and _count_le), which runs as
// grid=(1,), and fused_sample of the same file (its _sample_kernel: the
// draw without the walk, the paged draw's front end). Both are one kernel
// body here, fused_draw_kernel<WALK>: fused_sample is the instance that
// writes each position and skips the walk, so the two give bit-equal
// positions under one key. The reference batches by vmapping the launch
// over its keys (QueryEngine.sample_batch); here a batch is one launch of
// the same kernel.
//
// The kernel runs on the whole card in one cooperative launch
// (cudaLaunchCooperativeKernel): the grid is the occupancy limit
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SM count), cut to the
// blocks the draw's lanes can use. Every stage of the draw is a grid-wide
// phase; blocks loop over work items, and phases are separated by
// fd_grid_sync, a barrier on one counter in the scratch (cooperative
// groups' own barrier, written out so that the one set of build flags needs
// no -rdc). A work item is a (key, tile) pair of FD_TILE lanes, in key-major
// order, or a (key, lane) pair for the per-root and output phases; a single
// draw is the batch of one, its key passed by value. EXPRACE runs eight
// barriers, whatever the batch:
//   1. Exp(1) gaps from the Threefry uniforms, each tile scanned in the
//      float32 order of scan.cuh: tile-local prefixes, tile totals, and
//      the largest prefix of each tile;
//   2. one block a key (blocks loop over keys when there are more keys):
//      the tile carries (the chunked scan of the totals), and the running
//      max of the tiles before each tile;
//   3. arrivals = running max of (carry + prefix), and cell placement;
//   4. dedupe, segment of each unique arrival, tile scans of the unsigned
//      and signed counts U and S (gid[i - 1] crosses a tile edge: phase 3
//      ended with a barrier);
//   5. U and S plus the sum of the tile totals before them;
//   6. per-root output and hit prefixes (outE, hitsE) over B x (R + 1)
//      lanes;
//   7. the complement's carry-forward values, tile running max;
//   8. that max plus the max of the tiles before;
//   9. output slots, then (WALK) the walk of each output lane; lane 0 of a
//      key writes its count and overflow.
// Flat PTBERN is two barriers: a tile count scan, the carries, compaction.
// Scratch is one allocation of fused_draw_scratch_words int32 words: a slab
// of the same layout for each key (offsets in 64 bits), then the barrier
// counter, zeroed by one 4-byte memset before the launch. If the
// cooperative launch is refused, the launch function returns the error;
// nothing falls back to a smaller grid or to one launch a key.
//
// Bound on the card: the draw reads a few parameter vectors and writes cap
// lanes a key, so its bytes and operations bound is microseconds; what it
// takes is latency: eight barriers, and per output lane several dependent
// binary searches and (WALK) a tree walk. A batch pays the barriers and the
// launch once for B keys.
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
// arrivals' cells out of order), so a running max follows the sum; max and
// the integer scans are exact in any order.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "scan.cuh"
#include "threefry.cuh"
#include "tree_walk.cuh"

#define FD_THREADS 256
#define FD_ITEMS 4
#define FD_TILE (FD_THREADS * FD_ITEMS)
#define FD_EXPRACE 0
#define FD_PTBERN 1

static inline __host__ __device__ int fd_tiles(int lanes) {
  return (lanes + FD_TILE - 1) / FD_TILE;
}

// One key's device-memory scratch (a slab), carved from the int32 words.
struct FdScratch {
  float* v;     // arrivals (lanes)
  int* gid;     // cells (lanes); flat PTBERN's running count
  int* seg;     // root segment of each unique arrival (lanes)
  int* U;       // running count of unique arrivals (lanes)
  int* S;       // running signed count (lanes)
  int* gc;      // complement carry-forward values (lanes)
  int* outE;    // per-root output prefix (R + 1)
  int* hitsE;   // per-root hit prefix (R + 1)
  float* tot;   // per tile: float32 total,
  float* carry; //   carry,
  float* pmax;  //   largest local prefix,
  float* cmax;  //   running max of the tiles before it;
  int* totU;    //   U total (flat PTBERN: count total),
  int* totS;    //   S total,
  int* gmax;    //   gc max
};

// int32 words of one key's slab.
static inline __host__ __device__ long long fd_slab_words(int lanes, int R) {
  return 6LL * lanes + 2LL * (R + 1) + 7LL * fd_tiles(lanes);
}

static inline __host__ __device__ FdScratch fd_carve(int* w, int lanes,
                                                     int R) {
  const int nt = fd_tiles(lanes);
  FdScratch s;
  s.v = reinterpret_cast<float*>(w);
  w += lanes;
  s.gid = w;
  w += lanes;
  s.seg = w;
  w += lanes;
  s.U = w;
  w += lanes;
  s.S = w;
  w += lanes;
  s.gc = w;
  w += lanes;
  s.outE = w;
  w += R + 1;
  s.hitsE = w;
  w += R + 1;
  s.tot = reinterpret_cast<float*>(w);
  w += nt;
  s.carry = reinterpret_cast<float*>(w);
  w += nt;
  s.pmax = reinterpret_cast<float*>(w);
  w += nt;
  s.cmax = reinterpret_cast<float*>(w);
  w += nt;
  s.totU = w;
  w += nt;
  s.totS = w;
  w += nt;
  s.gmax = w;
  return s;
}

// The batch's slabs, then the barrier counter.
extern "C" long long fused_draw_scratch_words(int lanes, int R, int batch) {
  return (long long)batch * fd_slab_words(lanes, R) + 1;
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
  int* scratch;
  long long slab;  // int32 words a key
  unsigned* bar;   // grid barrier counter, zero at launch
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

// #elements of the ascending vec[0, L) that are <= q (branchless descent).
// No __restrict__: several searched vectors are written by earlier phases of
// the same launch, so their loads must not take the non-coherent path.
template <typename T>
__device__ __forceinline__ int fd_count_le(const T* vec, int L, T q) {
  const int steps = max(1, 32 - __clz(L));
  int p = 0;
  for (int k = steps - 1; k >= 0; --k) {
    const int cand = p + (1 << k);
    const T val = vec[min(cand, L) - 1];
    if (cand <= L && val <= q) p = cand;
  }
  return p;
}

// Root segment of flat position g.
__device__ __forceinline__ int fd_seg(const int* prefE32, int R, int g) {
  return min(max(fd_count_le(prefE32, R + 1, g) - 1, 0), R - 1);
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
  for (int w = 1; w < FD_THREADS / 32; ++w) r = op(r, sh[w]);
  __syncthreads();
  return r;
}

// op over x[0, t): what the tiles before tile t carry into it.
template <typename T, class Op>
__device__ __forceinline__ T fd_before(const T* x, int t, T ident, Op op,
                                       T* sh) {
  T v = ident;
  for (int k = threadIdx.x; k < t; k += FD_THREADS) v = op(v, x[k]);
  return fd_block_reduce(v, op, sh);
}

// This thread's items of tile `base` back to x.
template <typename T>
__device__ __forceinline__ void fd_put(T* x, long long base, int lanes,
                                       const T (&pre)[FD_ITEMS]) {
#pragma unroll
  for (int i = 0; i < FD_ITEMS; ++i) {
    const long long idx = base + threadIdx.x * FD_ITEMS + i;
    if (idx < lanes) x[idx] = pre[i];
  }
}

// Work item w of a tile phase: key b, tile t.
__device__ __forceinline__ void fd_item(long long w, int nt, int& b, int& t) {
  b = (int)(w / nt);
  t = (int)(w - (long long)b * nt);
}

// Tile loads of the phases.
struct LoadGap {  // Exp(1) gap of stream 0's uniform
  static constexpr bool kVec = false;
  uint32_t s0, s1;
  __device__ float operator()(long long i) const {
    return -log1pf(-rt_uniform_at(s0, s1, (uint32_t)i));
  }
};
struct LoadShifted {  // the running sum: the tile's carry + local prefix
  static constexpr bool kVec = false;
  const float* v;
  float carry;
  __device__ float operator()(long long i) const {
    return __fadd_rn(carry, v[i]);
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
struct LoadGc {  // the complement's carry-forward value of a unique arrival
  static constexpr bool kVec = false;
  const int* gid;
  const int* seg;
  const int* U;
  const int* hitsE;
  const int* prefE32;
  const int* offE;
  int n32;
  __device__ int operator()(long long i) const {
    const int g = gid[i];
    const int prev = i > 0 ? gid[i - 1] : -1;
    if (g >= n32 || g == prev) return -(1 << 30);
    const int sg = seg[i];
    const int lrank = (U[i] - 1) - hitsE[sg];
    return (g - prefE32[sg]) - lrank + offE[sg];
  }
};
struct LoadTrial {  // flat PTBERN: stream 1's trial of flat position i
  static constexpr bool kVec = false;
  uint32_t s0, s1;
  const int* prefE32;
  const float* p32;
  int R;
  __device__ int operator()(long long i) const {
    const int r = fd_seg(prefE32, R, (int)i);
    return rt_uniform_at(s0, s1, (uint32_t)i) < p32[r] ? 1 : 0;
  }
};

// Output lane tt of key b: its position, then (WALK) the walk of that
// position.
template <bool WALK>
__device__ __forceinline__ void fd_emit(const FdArgs& a, const RtLayout& L,
                                        int b, int tt, int p_out, int n32) {
  a.positions[(long long)b * a.cap + tt] = p_out;
  if (!WALK) return;
  int rws[RT_MAX_SLOTS];
  rt_tree_walk(a.arena, L, min(p_out, n32 - 1), rws);
  int* rows = a.rows + (long long)b * (L.num_edges + 1) * a.cap + tt;
  for (int s = 0; s <= L.num_edges; ++s) rows[(long long)s * a.cap] = rws[s];
}

// Flat PTBERN over n = prefE32[R] lanes a key: one trial per flat position,
// a running count C, and lane tt = the first flat position with C == tt + 1.
template <bool WALK>
__device__ void fd_ptbern(const FdArgs& a, const RtLayout& L, int* smi,
                          int* shi) {
  const int tid = threadIdx.x, n = a.lanes, nt = fd_tiles(n);
  const int n32 = a.prefE32[a.R];
  const long long items = (long long)a.batch * nt;
  fd_stamp(a.stamps, 0);
  int kb = -1;
  uint32_t s0 = 0, s1 = 0;
  for (long long w = blockIdx.x; w < items; w += gridDim.x) {
    int b, t;
    fd_item(w, nt, b, t);
    if (b != kb) {
      fd_fold(a, b, 1u, s0, s1);
      kb = b;
    }
    const FdScratch s = fd_slab(a, b);
    const long long base = (long long)t * FD_TILE;
    int pre[FD_ITEMS];
    const int total = sc_tile<FD_THREADS, FD_ITEMS>(
        LoadTrial{s0, s1, a.prefE32, a.p32, a.R}, base, n, 0, AddI(), smi,
        shi, pre);
    fd_put(s.gid, base, n, pre);
    if (tid == 0) s.totU[t] = total;
  }
  fd_grid_sync(a.bar);
  fd_stamp(a.stamps, 1);
  for (long long w = blockIdx.x; w < items; w += gridDim.x) {
    int b, t;
    fd_item(w, nt, b, t);
    const FdScratch s = fd_slab(a, b);
    const int carry = fd_before(s.totU, t, 0, AddI(), shi);
    for (int k = 0; k < FD_ITEMS; ++k) {
      const long long i = (long long)t * FD_TILE + k * FD_THREADS + tid;
      if (i < n) s.gid[i] += carry;
    }
  }
  fd_grid_sync(a.bar);
  fd_stamp(a.stamps, 2);
  const long long lanes = (long long)a.batch * a.cap;
  for (long long g = (long long)blockIdx.x * FD_THREADS + tid; g < lanes;
       g += (long long)gridDim.x * FD_THREADS) {
    const int b = (int)(g / a.cap), tt = (int)(g - (long long)b * a.cap);
    const int* C = fd_slab(a, b).gid;
    const int total = C[n - 1];
    const int count = min(total, a.cap);
    const int pos = min(fd_count_le(C, n, tt), n - 1);
    fd_emit<WALK>(a, L, b, tt, tt < count ? pos : n32, n32);
    if (tt == 0) {
      a.scalars[2 * b] = count;
      a.scalars[2 * b + 1] = total > a.cap ? 1 : 0;
    }
  }
  fd_stamp_end(a.stamps, 3);
}

template <bool WALK>
__global__ void __launch_bounds__(FD_THREADS) fused_draw_kernel(
    const __grid_constant__ FdArgs a, const __grid_constant__ RtLayout L) {
  __shared__ uint32_t smw[SC_PAD(FD_TILE)];
  __shared__ uint32_t shw[FD_THREADS];
  float* smf = reinterpret_cast<float*>(smw);
  float* shf = reinterpret_cast<float*>(shw);
  int* smi = reinterpret_cast<int*>(smw);
  int* shi = reinterpret_cast<int*>(shw);
  if (a.method == FD_PTBERN) {
    // lanes is the join size n here.
    fd_ptbern<WALK>(a, L, smi, shi);
    return;
  }
  const int tid = threadIdx.x, acap = a.lanes, R = a.R, nt = fd_tiles(acap);
  const long long items = (long long)a.batch * nt;
  const long long gthread = (long long)blockIdx.x * FD_THREADS + tid;
  const long long gstride = (long long)gridDim.x * FD_THREADS;
  const int n32 = a.prefE32[R];
  const float Lam = a.massE[R];

  // 1. Arrivals: Exp(1) gaps, summed — a unit-rate Poisson process on
  // [0, Lam). Tile-local prefixes first.
  fd_stamp(a.stamps, 0);
  int kb = -1;
  uint32_t s0 = 0, s1 = 0;
  for (long long w = blockIdx.x; w < items; w += gridDim.x) {
    int b, t;
    fd_item(w, nt, b, t);
    if (b != kb) {
      fd_fold(a, b, 0u, s0, s1);
      kb = b;
    }
    const FdScratch s = fd_slab(a, b);
    const long long base = (long long)t * FD_TILE;
    float pre[FD_ITEMS];
    const float total = sc_tile<FD_THREADS, FD_ITEMS>(
        LoadGap{s0, s1}, base, acap, 0.0f, AddF(), smf, shf, pre);
    float m = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < FD_ITEMS; ++i)
      if (base + tid * FD_ITEMS + i < acap) m = fmaxf(m, pre[i]);
    m = fd_block_reduce(m, MaxF(), shf);
    fd_put(s.v, base, acap, pre);
    if (tid == 0) {
      s.tot[t] = total;
      s.pmax[t] = m;
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

  // 3. Arrivals = running max of the running sum; cell placement: inverse
  // CDF into the mass prefix.
  for (long long w = blockIdx.x; w < items; w += gridDim.x) {
    int b, t;
    fd_item(w, nt, b, t);
    const FdScratch s = fd_slab(a, b);
    const long long base = (long long)t * FD_TILE;
    const float cm = s.cmax[t];
    float pre[FD_ITEMS];
    sc_tile<FD_THREADS, FD_ITEMS>(LoadShifted{s.v, s.carry[t]}, base, acap,
                                  -CUDART_INF_F, MaxF(), smf, shf, pre);
#pragma unroll
    for (int i = 0; i < FD_ITEMS; ++i) {
      const long long idx = base + tid * FD_ITEMS + i;
      if (idx >= acap) continue;
      const float vi = fmaxf(cm, pre[i]);
      const int r = min(max(fd_count_le(a.massE, R + 1, vi) - 1, 0), R - 1);
      const float x =
          __fdiv_rn(__fsub_rn(vi, a.massE[r]), fmaxf(a.lam[r], 1e-12f));
      int cell = (int)floorf(x);
      cell = min(max(cell, 0), max(a.w32[r] - 1, 0));
      s.v[idx] = vi;
      s.gid[idx] = vi < Lam ? a.prefE32[r] + cell : n32;
    }
  }
  fd_grid_sync(a.bar);
  fd_stamp(a.stamps, 3);

  // 4. Dedupe (>= 1 arrival in a cell is one success or failure), segment
  // of each unique arrival in the root prefix, tile scans of the unsigned
  // and signed counts.
  for (long long w = blockIdx.x; w < items; w += gridDim.x) {
    int b, t;
    fd_item(w, nt, b, t);
    const FdScratch s = fd_slab(a, b);
    const long long base = (long long)t * FD_TILE;
#pragma unroll
    for (int k = 0; k < FD_ITEMS; ++k) {
      const long long i = base + k * FD_THREADS + tid;
      if (i >= acap) continue;
      const int g = s.gid[i];
      const int prev = i > 0 ? s.gid[i - 1] : -1;
      const bool uq = g < n32 && g != prev;
      const int sg = uq ? fd_seg(a.prefE32, R, g) : 0;
      s.seg[i] = sg;
      s.U[i] = uq ? 1 : 0;
      s.S[i] = uq ? a.sign[sg] : 0;
    }
    __syncthreads();
    int pre[FD_ITEMS];
    const int tu = sc_tile<FD_THREADS, FD_ITEMS>(LoadPtr<int>{s.U}, base, acap,
                                                 0, AddI(), smi, shi, pre);
    fd_put(s.U, base, acap, pre);
    const int ts = sc_tile<FD_THREADS, FD_ITEMS>(LoadPtr<int>{s.S}, base, acap,
                                                 0, AddI(), smi, shi, pre);
    fd_put(s.S, base, acap, pre);
    if (tid == 0) {
      s.totU[t] = tu;
      s.totS[t] = ts;
    }
  }
  fd_grid_sync(a.bar);
  fd_stamp(a.stamps, 4);

  // 5. The counts of the tiles before each tile.
  for (long long w = blockIdx.x; w < items; w += gridDim.x) {
    int b, t;
    fd_item(w, nt, b, t);
    const FdScratch s = fd_slab(a, b);
    const int cu = fd_before(s.totU, t, 0, AddI(), shi);
    const int cs = fd_before(s.totS, t, 0, AddI(), shi);
#pragma unroll
    for (int k = 0; k < FD_ITEMS; ++k) {
      const long long i = (long long)t * FD_TILE + k * FD_THREADS + tid;
      if (i < acap) {
        s.U[i] += cu;
        s.S[i] += cs;
      }
    }
  }
  fd_grid_sync(a.bar);
  fd_stamp(a.stamps, 5);

  // 6. Per-root output prefix (outE) and hit prefix (hitsE) via boundary
  // counts, over the batch's B x (R + 1) root lanes.
  const long long roots = (long long)a.batch * (R + 1);
  for (long long g = gthread; g < roots; g += gstride) {
    const int b = (int)(g / (R + 1)), j = (int)(g - (long long)b * (R + 1));
    const FdScratch s = fd_slab(a, b);
    const int B = fd_count_le(s.gid, acap, a.prefE32[j] - 1);
    s.outE[j] = a.cwE[j] + (B > 0 ? s.S[B - 1] : 0);
    s.hitsE[j] = B > 0 ? s.U[B - 1] : 0;
  }
  fd_grid_sync(a.bar);
  fd_stamp(a.stamps, 6);

  // 7-8. Complement support: carry-forward g-values, kept ascending by a
  // running max (tile by tile, then the tiles before).
  for (long long w = blockIdx.x; w < items; w += gridDim.x) {
    int b, t;
    fd_item(w, nt, b, t);
    const FdScratch s = fd_slab(a, b);
    const long long base = (long long)t * FD_TILE;
    int pre[FD_ITEMS];
    const int gm = sc_tile<FD_THREADS, FD_ITEMS>(
        LoadGc{s.gid, s.seg, s.U, s.hitsE, a.prefE32, a.offE, n32}, base,
        acap, INT_MIN, MaxI(), smi, shi, pre);
    fd_put(s.gc, base, acap, pre);
    if (tid == 0) s.gmax[t] = gm;
  }
  fd_grid_sync(a.bar);
  fd_stamp(a.stamps, 7);
  for (long long w = blockIdx.x; w < items; w += gridDim.x) {
    int b, t;
    fd_item(w, nt, b, t);
    const FdScratch s = fd_slab(a, b);
    const int m = fd_before(s.gmax, t, INT_MIN, MaxI(), shi);
#pragma unroll
    for (int k = 0; k < FD_ITEMS; ++k) {
      const long long i = (long long)t * FD_TILE + k * FD_THREADS + tid;
      if (i < acap) s.gc[i] = max(s.gc[i], m);
    }
  }
  fd_grid_sync(a.bar);
  fd_stamp(a.stamps, 8);

  // 9. Output slots (gather-only compaction) over the batch's B x cap
  // lanes, then the walk of each position; lane 0 of a key writes its count
  // and overflow.
  const long long lanes = (long long)a.batch * a.cap;
  for (long long g = gthread; g < lanes; g += gstride) {
    const int b = (int)(g / a.cap), tt = (int)(g - (long long)b * a.cap);
    const FdScratch s = fd_slab(a, b);
    const int K = s.outE[R];
    const int count = min(K, a.cap);
    const int rO = min(max(fd_count_le(s.outE, R + 1, tt) - 1, 0), R - 1);
    const int l = tt - s.outE[rO];
    const int wm1 = max(a.w32[rO] - 1, 0);
    const int hO = s.hitsE[rO];
    const int i_star = min(fd_count_le(s.U, acap, hO + l), acap - 1);
    const int direct_local = s.gid[i_star] - a.prefE32[rO];
    const int Lq = fd_count_le(s.gc, acap, l + a.offE[rO]);
    const int c = (Lq > 0 ? s.U[Lq - 1] : 0) - hO;
    const int comp_pos = l + min(max(c, 0), wm1 - l + 1);
    const int local_out = a.sign[rO] < 0 ? comp_pos : direct_local;
    const int pos = a.prefE32[rO] + min(max(local_out, 0), wm1);
    fd_emit<WALK>(a, L, b, tt, tt < count ? pos : n32, n32);
    if (tt == 0) {
      a.scalars[2 * b] = count;
      a.scalars[2 * b + 1] = (s.v[acap - 1] < Lam || K > a.cap) ? 1 : 0;
    }
  }
  fd_stamp_end(a.stamps, 9);
}

// The grid of one launch: the occupancy limit (blocks a multiprocessor
// holds x multiprocessors, asked once per instance), cut to the blocks the
// batch's lanes can use (its tiles, its output lanes, its root lanes).
template <bool WALK>
static cudaError_t fd_grid(int lanes, int cap, int R, int batch,
                           int grid[3]) {
  static int per_sm = 0, sms = 0;
  if (per_sm == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fused_draw_kernel<WALK>, FD_THREADS, 0);
    if (e != cudaSuccess) {
      per_sm = 0;
      return e;
    }
    if (per_sm == 0) return cudaErrorCooperativeLaunchTooLarge;
  }
  const long long wide = (long long)batch * (cap > R + 1 ? cap : R + 1);
  const long long tiles = (long long)batch * fd_tiles(lanes);
  const long long rows = (wide + FD_THREADS - 1) / FD_THREADS;
  const long long need = tiles > rows ? tiles : rows;
  const long long most = (long long)per_sm * sms;
  grid[0] = per_sm;
  grid[1] = sms;
  grid[2] = (int)(need < 1 ? 1 : need > most ? most : need);
  return cudaSuccess;
}

template <bool WALK>
static int fd_launch(const FdArgs& a, const RtLayout& L, void* stream) {
  int grid[3];
  cudaError_t e = fd_grid<WALK>(a.lanes, a.cap, a.R, a.batch, grid);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  e = cudaMemsetAsync(a.bar, 0, sizeof(unsigned), s);
  if (e != cudaSuccess) return (int)e;
  void* params[] = {const_cast<FdArgs*>(&a), const_cast<RtLayout*>(&L)};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(fused_draw_kernel<WALK>), dim3(grid[2]),
      dim3(FD_THREADS), params, 0, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Blocks a multiprocessor holds, multiprocessors, and the grid of a launch
// at these sizes (walk: the fused_draw instance, else fused_sample's).
extern "C" int fused_draw_grid(int walk, int lanes, int cap, int R, int batch,
                               int* out) {
  return (int)(walk ? fd_grid<true>(lanes, cap, R, batch, out)
                    : fd_grid<false>(lanes, cap, R, batch, out));
}

static FdArgs fd_args(const int* arena, const unsigned* keys, int batch,
                      unsigned k0, unsigned k1, int method,
                      const float* massE, const float* lam, const int* sign,
                      const int* w32, const int* prefE32, const int* cwE,
                      const int* offE, const float* p32, int R, int lanes,
                      int cap, int* rows, int* positions, int* scalars,
                      int* scratch, unsigned long long* stamps) {
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
  a.scratch = scratch;
  a.slab = fd_slab_words(lanes, R);
  a.bar = reinterpret_cast<unsigned*>(scratch + (long long)batch * a.slab);
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
// fused_draw_scratch_words(lanes, R, batch) int32 words. rows, positions
// and scalars are (batch, slots, cap), (batch, cap) and (batch, 2). stamps:
// null, or 10 zeroed words (EXPRACE; 4 for flat PTBERN) for the phase
// clock.
extern "C" int fused_draw_launch(
    const int* arena, const int* table, const unsigned* keys, int batch,
    unsigned k0, unsigned k1, int method, const float* massE,
    const float* lam, const int* sign, const int* w32, const int* prefE32,
    const int* cwE, const int* offE, const float* p32, int R, int lanes,
    int cap, int* rows, int* positions, int* scalars, int* scratch,
    unsigned long long* stamps, void* stream) {
  const RtLayout L = rt_layout_from_table(table);
  const FdArgs a = fd_args(arena, keys, batch, k0, k1, method, massE, lam,
                           sign, w32, prefE32, cwE, offE, p32, R, lanes, cap,
                           rows, positions, scalars, scratch, stamps);
  return fd_launch<true>(a, L, stream);
}

// The draw without the walk: positions, count and overflow only. The
// kernel reads no arena and no layout.
extern "C" int fused_sample_launch(
    const unsigned* keys, int batch, unsigned k0, unsigned k1, int method,
    const float* massE, const float* lam, const int* sign, const int* w32,
    const int* prefE32, const int* cwE, const int* offE, const float* p32,
    int R, int lanes, int cap, int* positions, int* scalars, int* scratch,
    unsigned long long* stamps, void* stream) {
  RtLayout L = {};
  const FdArgs a = fd_args(nullptr, keys, batch, k0, k1, method, massE, lam,
                           sign, w32, prefE32, cwE, offE, p32, R, lanes, cap,
                           nullptr, positions, scalars, scratch, stamps);
  return fd_launch<false>(a, L, stream);
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
