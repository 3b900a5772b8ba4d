// Inclusive prefix sums and fused GEO positions.
//
// Replaces two TPU kernels of src/repro/kernels/:
//   prefix_sum.py prefix_sum_tiles -> scan_i32_launch, scan_f32_launch;
//   geo_gaps.py   geo_gaps_tiles   -> geo_gaps_launch.
// The TPU kernels carry the running total from one grid step to the next in
// an SMEM scalar. Hopper blocks run in no order, so the carry crosses blocks
// another way, by type:
//
// int32 and GEO: one pass, a decoupled look-back (Merrill and Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", 2016). A
// block takes its tile index from an atomic ticket, so every tile it waits
// on belongs to a block that has already started. It reads its tile once
// (16-byte loads, staged through shared memory), sums it, and publishes the
// tile's aggregate in the tile's status word. Warp 0 then looks back over
// the predecessors' words, 32 at a time, adding aggregates until it meets
// an inclusive prefix; it publishes its own inclusive prefix, and the block
// writes the tile once (16-byte stores). Words are written with
// st.release.gpu and read with ld.acquire.gpu. int32 adds in uint32, so it
// wraps as XLA's int32 cumsum wraps and any order gives the reference's
// bits. GEO is the same scan with a prologue (the geometric step of a
// uniform) and an epilogue (- 1).
//
// One launch a call, with no reset: the status words live in a scratch
// that the wrapper keeps per (device, stream) and reuses (prefix_sum.py
// _look_back_scratch), zeroed only when it is first made or grows. A
// status word is 64 bits:
//
//   bits 63-62  flag: 1 the tile's aggregate, 2 its inclusive prefix
//   bits 61-32  the launch's epoch, 1 .. LB_EPOCH_MAX
//   bits 31-0   the uint32 value
//
// Each launch takes the next epoch, so a word left by an earlier launch
// (or a zero word) reads as not yet published. The ticket is never reset
// either: it counts on from launch to launch, and a launch's tiles are its
// tickets less the count its predecessors took (the ticket base), in
// uint32 arithmetic, which wraps harmlessly. Launches on one stream run in
// order, so each one finds every earlier ticket taken and every earlier
// word written. The host keeps the epoch and the base (lb_launch); when the
// epoch would pass LB_EPOCH_MAX, that launch first clears the scratch with
// one cudaMemsetAsync and starts again at epoch 1 and base 0.
//
// Tiles: LB_TILE elements (256 x 32), or LB_SMALL_TILE (256 x 8) when n
// gives fewer tiles of LB_TILE than the card holds blocks at once, so that
// a small scan still spreads over every SM. The choice depends on n and the
// card alone (lb_tile) and changes no sum.
//
// float32: three passes in a fixed order (scan.cuh): every block reduces
// its tile of SC_TILE elements to one total; one block scans the totals
// into carries; every block scans its tile again and adds its carry. A
// look-back sums in an order that changes from run to run, so it could not
// be held bit for bit against a plain version; float32 keeps this order,
// which prefix_sum.py scan_order_f32 repeats.
//
// Bound on the card: bytes. Each element is read once and written once
// (8 bytes for int32 and float32, 8 for a GEO lane: its uniform and its
// position). The look-back reaches that; the float32 passes read the
// input twice (12 bytes an element).
//
// GEO keeps the reference's divide (geo_gaps.py:31-34): floor() turns a
// last-ulp difference of a reciprocal multiply into an off-by-one position.
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

#define SC_THREADS 256
#define SC_ITEMS 16
#define SC_TILE (SC_THREADS * SC_ITEMS)
#define LB_THREADS 256
#define LB_ITEMS 32
#define LB_SMALL_ITEMS 8
// Blocks an SM holds: the thread-local prefixes are added again from shared
// memory instead of kept in registers, so six blocks fit (35 KB of shared
// memory each), against four with the prefixes in registers.
#define LB_MIN_BLOCKS 6
// The small tiles' instance: 9.5 KB of shared memory, so the thread limit
// (eight blocks of 256) is what bounds it.
#define LB_SMALL_MIN_BLOCKS 8
#define LB_TILE (LB_THREADS * LB_ITEMS)
#define LB_SMALL_TILE (LB_THREADS * LB_SMALL_ITEMS)
#define LB_AGGREGATE 1u
#define LB_PREFIX 2u
#define LB_EPOCH_BITS 30
#define LB_EPOCH_MAX ((1u << LB_EPOCH_BITS) - 1)

// Prologues: element i of the input as the scanned type, with a 16-byte
// path for full tiles of an aligned input.
struct LoadVecU32 {
  static constexpr bool kVec = true;
  const uint32_t* x;
  bool aligned;
  __device__ bool vec_ok() const { return aligned; }
  __device__ uint32_t operator()(long long i) const { return x[i]; }
  __device__ void load4(long long i, uint32_t q[4]) const {
    const uint4 w = *reinterpret_cast<const uint4*>(x + i);
    q[0] = w.x;
    q[1] = w.y;
    q[2] = w.z;
    q[3] = w.w;
  }
};
struct LoadGeo {
  static constexpr bool kVec = true;
  const float* u;
  float p;  // clipped to [1e-12, 1 - 1e-7] by the wrapper, as the reference
  bool aligned;
  __device__ bool vec_ok() const { return aligned; }
  // The step: floor(log(u) / log1p(-p)) + 1 (the divide, not a reciprocal
  // multiply), the gap clamped to 2e9 before the cast.
  __device__ uint32_t step(float ui) const {
    const float g = floorf(__fdiv_rn(logf(fmaxf(ui, 1e-12f)), log1pf(-p)));
    return (uint32_t)((int)fminf(g, 2000000000.0f) + 1);
  }
  __device__ uint32_t operator()(long long i) const { return step(u[i]); }
  __device__ void load4(long long i, uint32_t q[4]) const {
    const float4 w = *reinterpret_cast<const float4*>(u + i);
    q[0] = step(w.x);
    q[1] = step(w.y);
    q[2] = step(w.z);
    q[3] = step(w.w);
  }
};

// Epilogues: the scanned value as written.
struct Same {
  template <typename T>
  __device__ T operator()(T v) const { return v; }
};
struct MinusOne {
  __device__ uint32_t operator()(uint32_t v) const { return v - 1u; }
};

// ---- float32: three passes ---------------------------------------------

// Pass 1: the total of each tile.
template <typename T, class Load, class Op>
__global__ void __launch_bounds__(SC_THREADS)
    sc_totals_kernel(Load load, long long n, T ident, Op op, T* totals) {
  __shared__ T sm[SC_PAD(SC_TILE)];
  __shared__ T sh[SC_THREADS];
  T pre[SC_ITEMS];
  const T total = sc_tile<SC_THREADS, SC_ITEMS>(
      load, (long long)blockIdx.x * SC_TILE, n, ident, op, sm, sh, pre);
  if (threadIdx.x == 0) totals[blockIdx.x] = total;
}

// Pass 2, one block: carries[t] = totals[0] + ... + totals[t - 1].
template <typename T, class Op>
__global__ void __launch_bounds__(SC_THREADS)
    sc_carries_kernel(const T* totals, int ntiles, T ident, Op op,
                      T* carries) {
  __shared__ T sm[SC_PAD(SC_TILE)];
  __shared__ T sh[SC_THREADS];
  sc_carries<SC_THREADS, SC_ITEMS>(LoadPtr<T>{totals}, ntiles, ident, op,
                                   carries, sm, sh);
}

// Pass 3: out = carry of the tile + the tile-local prefix.
template <typename T, class Load, class Op>
__global__ void __launch_bounds__(SC_THREADS)
    sc_scan_kernel(Load load, long long n, T ident, Op op, const T* carries,
                   T* out) {
  __shared__ T sm[SC_PAD(SC_TILE)];
  __shared__ T sh[SC_THREADS];
  T pre[SC_ITEMS];
  const long long base = (long long)blockIdx.x * SC_TILE;
  sc_tile<SC_THREADS, SC_ITEMS>(load, base, n, ident, op, sm, sh, pre);
  const T carry = carries[blockIdx.x];
  // Back through shared memory, so that the stores are coalesced.
#pragma unroll
  for (int i = 0; i < SC_ITEMS; ++i)
    sm[SC_PAD(threadIdx.x * SC_ITEMS + i)] = op(carry, pre[i]);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < SC_ITEMS; ++i) {
    const int e = i * SC_THREADS + threadIdx.x;
    if (base + e < n) out[base + e] = sm[SC_PAD(e)];
  }
}

// ---- int32 and GEO: one pass with a decoupled look-back ------------------

// The status word of a tile: flag, epoch and value (the layout above).
__device__ __forceinline__ unsigned long long lb_word(unsigned flag,
                                                      unsigned epoch,
                                                      uint32_t value) {
  return ((unsigned long long)((flag << LB_EPOCH_BITS) | epoch) << 32) | value;
}

__device__ __forceinline__ void lb_publish(unsigned long long* word,
                                           unsigned flag, unsigned epoch,
                                           uint32_t value) {
  const unsigned long long w = lb_word(flag, epoch, value);
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(word), "l"(w)
               : "memory");
}

__device__ __forceinline__ unsigned long long lb_read(
    const unsigned long long* word) {
  unsigned long long w;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(w)
               : "l"(word)
               : "memory");
  return w;
}

// The flag of a word published in this launch's epoch, else 0.
__device__ __forceinline__ unsigned lb_flag(unsigned long long w,
                                            unsigned epoch) {
  const unsigned hi = (unsigned)(w >> 32);
  return (hi & LB_EPOCH_MAX) == epoch ? hi >> LB_EPOCH_BITS : 0u;
}

// Warp 0 of tile `tile` > 0: the sum of every tile before it. Lane l waits
// for tile top - l's word of this epoch; the window stops at the nearest
// inclusive prefix, else all 32 aggregates are added and it moves 32 tiles
// back. Lanes before tile 0 read as an empty inclusive prefix.
__device__ __forceinline__ uint32_t lb_look_back(
    const unsigned long long* status, long long tile, unsigned epoch) {
  const int lane = threadIdx.x & 31;
  uint32_t excl = 0;
  for (long long top = tile - 1;; top -= 32) {
    const long long j = top - lane;
    unsigned long long w = lb_word(LB_PREFIX, epoch, 0);
    if (j >= 0) {
      do {
        w = lb_read(status + j);
      } while (lb_flag(w, epoch) == 0);
    }
    const unsigned prefixes =
        __ballot_sync(SC_FULL, lb_flag(w, epoch) == LB_PREFIX);
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    uint32_t v = lane <= stop ? (uint32_t)w : 0u;
#pragma unroll
    for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(SC_FULL, v, o);
    excl += v;
    if (prefixes) return excl;
  }
}

// A tile of LB_THREADS x ITEMS elements a block. ticket: the launch's
// counter; base: the tickets earlier launches took; status: the tiles'
// words.
template <int ITEMS, int MINB, class Load, class Epi>
__global__ void __launch_bounds__(LB_THREADS, MINB)
    sc_look_back_kernel(Load load, long long n, Epi epi, int* out,
                        bool out_aligned, unsigned long long* status,
                        unsigned* ticket, unsigned base, unsigned epoch) {
  constexpr int TILE = LB_THREADS * ITEMS;
  __shared__ uint32_t sm[SC_PAD(TILE)];
  __shared__ uint32_t sh[LB_THREADS];
  __shared__ unsigned tile_sh;
  __shared__ uint32_t excl_sh;
  const int tid = threadIdx.x;
  if (tid == 0) tile_sh = atomicAdd(ticket, 1u) - base;
  __syncthreads();
  const long long tile = tile_sh;
  const long long base_e = tile * TILE;
  // The tile once through shared memory; this thread's total, then its
  // exclusive prefix across the block.
  sc_stage<LB_THREADS, ITEMS>(load, base_e, n, 0u, sm);
  __syncthreads();
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) acc += sm[SC_PAD(tid * ITEMS + i)];
  uint32_t total;
  const uint32_t texcl =
      sc_block_excl<LB_THREADS>(acc, 0u, AddU(), sh, &total);
  if (tid < 32) {
    uint32_t excl = 0;
    if (tile > 0) {
      if (tid == 0) lb_publish(status + tile, LB_AGGREGATE, epoch, total);
      excl = lb_look_back(status, tile, epoch);
    }
    if (tid == 0) {
      lb_publish(status + tile, LB_PREFIX, epoch, excl + total);
      excl_sh = excl;
    }
  }
  __syncthreads();
  // The running sum over this thread's items, back into shared memory so
  // that the stores are coalesced (16 bytes a thread on full tiles of an
  // aligned output).
  uint32_t run = excl_sh + texcl;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    run += sm[SC_PAD(tid * ITEMS + i)];
    sm[SC_PAD(tid * ITEMS + i)] = epi(run);
  }
  __syncthreads();
  if (base_e + TILE <= n && out_aligned) {
#pragma unroll
    for (int i = 0; i < ITEMS / 4; ++i) {
      const int e = 4 * (i * LB_THREADS + tid);
      const uint4 w = make_uint4(sm[SC_PAD(e)], sm[SC_PAD(e + 1)],
                                 sm[SC_PAD(e + 2)], sm[SC_PAD(e + 3)]);
      *reinterpret_cast<uint4*>(out + base_e + e) = w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int e = i * LB_THREADS + tid;
      if (base_e + e < n) out[base_e + e] = (int)sm[SC_PAD(e)];
    }
  }
}

static bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// The blocks of LB_TILE elements the current card holds at once (the
// occupancy of the scan_i32 instance; GEO's has the same shared memory and
// bounds), found once per device. 0 if the query fails.
static long long lb_resident() {
  static int cache[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, sc_look_back_kernel<LB_ITEMS, LB_MIN_BLOCKS, LoadVecU32,
                                         Same>,
            LB_THREADS, 0) != cudaSuccess)
      return 0;
    cache[dev] = sms * per_sm;
  }
  return cache[dev];
}

// The tile of a scan of n elements: LB_SMALL_TILE when LB_TILE gives less
// than one wave of the resident grid, else LB_TILE.
static int lb_tile(long long n) {
  return (n + LB_TILE - 1) / LB_TILE < lb_resident() ? LB_SMALL_TILE
                                                       : LB_TILE;
}

// One launch over the scratch `words` (`capacity` 64-bit words: the ticket
// in word 0's low half, the status words from word 1) with the host state
// `state` = [epoch of the last launch, ticket base], advanced here.
template <class Load, class Epi>
static int lb_launch(Load load, long long n, Epi epi, int* out,
                     unsigned long long* words, long long capacity,
                     unsigned* state, void* stream) {
  if (n == 0) return (int)cudaGetLastError();
  const int tile = lb_tile(n);
  const long long ntiles = (n + tile - 1) / tile;
  if (ntiles + 1 > capacity) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned epoch = state[0] + 1;
  if (epoch > LB_EPOCH_MAX) {
    const int err = (int)cudaMemsetAsync(words, 0, (size_t)capacity * 8, s);
    if (err) return err;
    epoch = 1;
    state[1] = 0;
  }
  unsigned* ticket = reinterpret_cast<unsigned*>(words);
  if (tile == LB_TILE)
    sc_look_back_kernel<LB_ITEMS, LB_MIN_BLOCKS>
        <<<(unsigned)ntiles, LB_THREADS, 0, s>>>(load, n, epi, out,
                                                 aligned16(out), words + 1,
                                                 ticket, state[1], epoch);
  else
    sc_look_back_kernel<LB_SMALL_ITEMS, LB_SMALL_MIN_BLOCKS>
        <<<(unsigned)ntiles, LB_THREADS, 0, s>>>(load, n, epi, out,
                                                 aligned16(out), words + 1,
                                                 ticket, state[1], epoch);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  state[0] = epoch;
  state[1] += (unsigned)ntiles;
  return 0;
}

// The tile a scan of n elements takes on the current card, in *tile.
extern "C" int scan_look_back_tile(long long n, int* tile) {
  if (lb_resident() == 0) return (int)cudaGetLastError();
  *tile = lb_tile(n);
  return 0;
}

// words, capacity, state: the look-back's scratch and host state
// (lb_launch); capacity >= ceil(n / LB_SMALL_TILE) + 1 always suffices.
extern "C" int scan_i32_launch(const int* x, int* out, long long n,
                               unsigned long long* words, long long capacity,
                               unsigned* state, void* stream) {
  const LoadVecU32 load{(const uint32_t*)x, aligned16(x)};
  return lb_launch(load, n, Same(), out, words, capacity, state, stream);
}

// p_clipped: p already clipped to [1e-12, 1 - 1e-7] in float32 by the
// wrapper, as the reference clips it.
extern "C" int geo_gaps_launch(const float* u, float p_clipped, int* out,
                               long long n, unsigned long long* words,
                               long long capacity, unsigned* state,
                               void* stream) {
  const LoadGeo load{u, p_clipped, aligned16(u)};
  return lb_launch(load, n, MinusOne(), out, words, capacity, state, stream);
}

// totals and carries: scratch of ceil(n / SC_TILE) floats each.
extern "C" int scan_f32_launch(const float* x, float* out, long long n,
                               float* totals, float* carries, void* stream) {
  if (n == 0) return (int)cudaGetLastError();
  const long long ntiles = (n + SC_TILE - 1) / SC_TILE;
  cudaStream_t s = (cudaStream_t)stream;
  const LoadPtr<float> load{x};
  sc_totals_kernel<float><<<(unsigned)ntiles, SC_THREADS, 0, s>>>(
      load, n, 0.0f, AddF(), totals);
  int err = (int)cudaGetLastError();
  if (err) return err;
  sc_carries_kernel<float><<<1, SC_THREADS, 0, s>>>(totals, (int)ntiles, 0.0f,
                                                    AddF(), carries);
  err = (int)cudaGetLastError();
  if (err) return err;
  sc_scan_kernel<float><<<(unsigned)ntiles, SC_THREADS, 0, s>>>(
      load, n, 0.0f, AddF(), carries, out);
  return (int)cudaGetLastError();
}
