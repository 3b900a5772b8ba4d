// Inclusive prefix sums and fused GEO positions.
//
// Replaces two TPU kernels of src/repro/kernels/:
//   prefix_sum.py prefix_sum_tiles -> scan_i32_launch, scan_f32_launch,
//                                     scan_f64_launch;
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
// word written. The host keeps the epoch and the base (lb_run); when the
// epoch would pass LB_EPOCH_MAX, that launch first clears the scratch with
// one cudaMemsetAsync and starts again at epoch 1 and base 0.
//
// Tiles: LB_TILE elements (256 x 32), or LB_SMALL_TILE (256 x 8) when n
// gives fewer tiles of LB_TILE than the card holds blocks at once, so that
// a small scan still spreads over every SM. The choice depends on n and the
// card alone (lb_tile) and changes no sum.
//
// float32 and float64: one launch in a fixed order. A look-back sums in an
// order that changes from run to run, so it could not be held bit for bit
// against a plain version, and a sum that feeds a draw would give one key
// two samples. The order is that of three passes (scan.cuh): each tile of
// SC_TILE elements scanned by sc_tile; the tile totals scanned by the same
// tile function in chunks of one tile, the carry chained from chunk to
// chunk (sc_carries); an element is its tile's carry + its tile-local
// prefix. prefix_sum.py scan_order repeats it. One launch keeps it: tiles
// are taken by ticket as in the look-back; a tile scans itself into shared
// memory (sc_tile_sm) and publishes its total; the last tile of each group
// of SC_ITEMS totals (one thread of sc_carries) sums the group in sequence
// and publishes the sum; a tile then computes its carry from the group
// sums and totals before it with sc_carries' operations in sc_carries'
// order (sc_carry_at), so with its bits whichever tile finishes first, and
// writes itself once. A tile waits only on smaller tickets, held by blocks
// already running, so the grid cannot deadlock. The words are the
// look-back's (the same scratch, epochs and ticket): a float takes
// sizeof(T) / 4 aggregate words, each holding 32 of its bits, so that no
// word ever reads as published in a later launch.
//
// Bound on the card: bytes. Each element is read once and written once
// (8 bytes for int32 and float32, 16 for float64, 8 for a GEO lane: its
// uniform and its position). The look-back and the float scans move just
// those bytes: each reads its input once, and what crosses tiles stays in
// L2.
//
// GEO keeps the reference's divide (geo_gaps.py:31-34): floor() turns a
// last-ulp difference of a reciprocal multiply into an off-by-one position.
//
// The checked build (-DSC_CHECK_BOUNDS; prefix_sum.out_of_bounds,
// geo_gaps.out_of_bounds) holds every load and store of the input, the
// output, the ticket and the status words against the launch's operands
// (bounds_check.cuh). There a status word outside them reads as an empty
// inclusive prefix, so that no wait on it spins, and scan_check_tile sets
// the look-back's tile to the production build's choice for n, whatever
// the checked instance's own occupancy.
#include <cuda_runtime.h>
#include <stdint.h>

#ifdef SC_CHECK_BOUNDS
#define BC_CHECK_BOUNDS
#endif
#include "bounds_check.cuh"
#include "scan.cuh"

BC_CHECK_ENTRIES(scan)

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
  __device__ uint32_t operator()(long long i) const { return BC_LD(x + i); }
  __device__ void load4(long long i, uint32_t q[4]) const {
    const uint4 w = BC_LD(reinterpret_cast<const uint4*>(x + i));
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
  __device__ uint32_t operator()(long long i) const {
    return step(BC_LD(u + i));
  }
  __device__ void load4(long long i, uint32_t q[4]) const {
    const float4 w = BC_LD(reinterpret_cast<const float4*>(u + i));
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
  if (!BC_OK(word, 8)) return;
  const unsigned long long w = lb_word(flag, epoch, value);
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(word), "l"(w)
               : "memory");
}

// A word outside the operands (the checked build) reads as an empty
// inclusive prefix of this epoch.
__device__ __forceinline__ unsigned long long lb_read(
    const unsigned long long* word, unsigned epoch) {
  if (!BC_OK(word, 8)) return lb_word(LB_PREFIX, epoch, 0);
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
        w = lb_read(status + j, epoch);
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
  if (tid == 0)
    tile_sh = (BC_OK(ticket, 4) ? atomicAdd(ticket, 1u) : base) - base;
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
      BC_ST(reinterpret_cast<uint4*>(out + base_e + e), w);
    }
  } else {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int e = i * LB_THREADS + tid;
      if (base_e + e < n) BC_ST(out + base_e + e, (int)sm[SC_PAD(e)]);
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

#ifdef SC_CHECK_BOUNDS
static int lb_tile_set = 0;

// The tile of the checked build's next look-back launches (LB_TILE or
// LB_SMALL_TILE; 0: its own choice).
extern "C" int scan_check_tile(int tile) {
  if (tile != 0 && tile != LB_TILE && tile != LB_SMALL_TILE)
    return (int)cudaErrorInvalidValue;
  lb_tile_set = tile;
  return 0;
}
#endif

// The tile of a scan of n elements: LB_SMALL_TILE when LB_TILE gives less
// than one wave of the resident grid, else LB_TILE.
static int lb_tile(long long n) {
#ifdef SC_CHECK_BOUNDS
  if (lb_tile_set != 0) return lb_tile_set;
#endif
  return (n + LB_TILE - 1) / LB_TILE < lb_resident() ? LB_SMALL_TILE
                                                       : LB_TILE;
}

// Takes the next epoch and ticket base of the scratch `words` (`capacity`
// 64-bit words: the ticket in word 0's low half, the status words from
// word 1) with the host state `state` = [epoch of the last launch, ticket
// base], launches `ntiles` tiles through launch(stream, status words,
// ticket, base, epoch) and advances the state. `need`: the words the
// launch uses, the ticket's included.
template <class LaunchFn>
static int lb_run(long long ntiles, long long need, unsigned long long* words,
                  long long capacity, unsigned* state, void* stream,
                  LaunchFn launch) {
  if (need > capacity) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned epoch = state[0] + 1;
  if (epoch > LB_EPOCH_MAX) {
    const int err = (int)cudaMemsetAsync(words, 0, (size_t)capacity * 8, s);
    if (err) return err;
    epoch = 1;
    state[1] = 0;
  }
  launch(s, words + 1, reinterpret_cast<unsigned*>(words), state[1], epoch);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  state[0] = epoch;
  state[1] += (unsigned)ntiles;
  return 0;
}

// One look-back launch over the scratch (lb_run).
template <class Load, class Epi>
static int lb_launch(Load load, long long n, Epi epi, int* out,
                     unsigned long long* words, long long capacity,
                     unsigned* state, void* stream) {
  if (n == 0) return (int)cudaGetLastError();
  const int tile = lb_tile(n);
  const long long ntiles = (n + tile - 1) / tile;
  return lb_run(ntiles, ntiles + 1, words, capacity, state, stream,
                [&](cudaStream_t s, unsigned long long* status,
                    unsigned* ticket, unsigned base, unsigned epoch) {
                  if (tile == LB_TILE)
                    sc_look_back_kernel<LB_ITEMS, LB_MIN_BLOCKS>
                        <<<(unsigned)ntiles, LB_THREADS, 0, s>>>(
                            load, n, epi, out, aligned16(out), status,
                            ticket, base, epoch);
                  else
                    sc_look_back_kernel<LB_SMALL_ITEMS, LB_SMALL_MIN_BLOCKS>
                        <<<(unsigned)ntiles, LB_THREADS, 0, s>>>(
                            load, n, epi, out, aligned16(out), status,
                            ticket, base, epoch);
                });
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

// ---- float32 and float64: one launch in the fixed order -----------------

// Blocks an SM for the float instances: the 618 tiles of A's float64
// masses run in one wave of 132 SMs (the float64 tile's shared memory
// admits six).
#define SC_MIN_BLOCKS 5

// Element i of a float input, with a 16-byte path for full tiles of an
// aligned input (four elements: two 16-byte loads in float64, one in
// float32).
template <typename T>
struct LoadVecF {
  static constexpr bool kVec = true;
  const T* x;
  bool aligned;
  __device__ bool vec_ok() const { return aligned; }
  __device__ T operator()(long long i) const { return BC_LD(x + i); }
  __device__ void load4(long long i, T q[4]) const {
    if constexpr (sizeof(T) == 8) {
      const double2 a = BC_LD(reinterpret_cast<const double2*>(x + i));
      const double2 b = BC_LD(reinterpret_cast<const double2*>(x + i + 2));
      q[0] = a.x;
      q[1] = a.y;
      q[2] = b.x;
      q[3] = b.y;
    } else {
      const float4 a = BC_LD(reinterpret_cast<const float4*>(x + i));
      q[0] = a.x;
      q[1] = a.y;
      q[2] = a.z;
      q[3] = a.w;
    }
  }
};

// sc_tile's arithmetic (scan.cuh) with the tile-local inclusive prefixes
// left in sm, each thread's in its own slots, instead of in registers.
// Returns the tile total.
template <int THREADS, int ITEMS, typename T, class Load, class Op>
__device__ __forceinline__ T sc_tile_sm(const Load& load, long long base,
                                        long long n, T ident, Op op, T* sm,
                                        T* sh) {
  static_assert(!Op::kExact, "the fixed order of the floats");
  constexpr int TILE = THREADS * ITEMS;
  const int tid = threadIdx.x;
  // sc_stage's staging, two vectors (or four elements) in flight a thread,
  // which keeps the float64 instance within its registers
  if (base + TILE <= n && load.vec_ok()) {
#pragma unroll 2
    for (int i = 0; i < ITEMS / 4; ++i) {
      const int e = 4 * (i * THREADS + tid);
      T q[4];
      load.load4(base + e, q);
#pragma unroll
      for (int j = 0; j < 4; ++j) sm[SC_PAD(e + j)] = q[j];
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < ITEMS; ++i) {
      const int e = i * THREADS + tid;
      sm[SC_PAD(e)] = base + e < n ? load(base + e) : ident;
    }
  }
  __syncthreads();
  T acc = sm[SC_PAD(tid * ITEMS)];
#pragma unroll
  for (int i = 1; i < ITEMS; ++i) {
    acc = op(acc, sm[SC_PAD(tid * ITEMS + i)]);
    sm[SC_PAD(tid * ITEMS + i)] = acc;
  }
  T total;
  const T excl = sc_block_excl<THREADS>(acc, ident, op, sh, &total);
  if (tid > 0) {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)
      sm[SC_PAD(tid * ITEMS + i)] = op(excl, sm[SC_PAD(tid * ITEMS + i)]);
  }
  __syncthreads();  // sh is the caller's next
  return total;
}

// A relaxed store: a word carries its own value and publishes nothing
// else, so it needs no release (the look-back's st.release first waits
// for the thread's earlier writes, which held up every tile's publish).
__device__ __forceinline__ void sc_store(unsigned long long* word,
                                         unsigned flag, unsigned epoch,
                                         uint32_t value) {
  if (!BC_OK(word, 8)) return;
  const unsigned long long w = lb_word(flag, epoch, value);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(word), "l"(w)
               : "memory");
}

// A float total as sizeof(T) / 4 aggregate words of tile `tile`.
template <typename T>
__device__ __forceinline__ void sc_publish(unsigned long long* status,
                                           long long tile, unsigned epoch,
                                           T total) {
  if constexpr (sizeof(T) == 8) {
    const unsigned long long b = __double_as_longlong(total);
    sc_store(status + 2 * tile, LB_AGGREGATE, epoch, (uint32_t)b);
    sc_store(status + 2 * tile + 1, LB_AGGREGATE, epoch, (uint32_t)(b >> 32));
  } else {
    sc_store(status + tile, LB_AGGREGATE, epoch, __float_as_uint(total));
  }
}

// Nanoseconds a thread sleeps between two reads of a word not yet
// published: 618 tiles waiting on the same few lines of L2 would slow the
// tiles that publish them.
#define SC_BACKOFF_NS 100

// A relaxed read: a word carries its own value, so no read needs ordering.
// Outside the operands (the checked build): lb_read's empty prefix.
__device__ __forceinline__ unsigned long long sc_read(
    const unsigned long long* word, unsigned epoch) {
  if (!BC_OK(word, 8)) return lb_word(LB_PREFIX, epoch, 0);
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(w) : "l"(word));
  return w;
}

// The float held by the words w (sc_publish's layout).
template <typename T>
__device__ __forceinline__ T sc_value(const unsigned long long (&w)[sizeof(T) /
                                                                  4]) {
  if constexpr (sizeof(T) == 8)
    return __longlong_as_double(
        (long long)((w[0] & 0xffffffffull) | (w[1] << 32)));
  else
    return __uint_as_float((uint32_t)w[0]);
}

// The value of float j of `words`, once published in this epoch.
template <typename T>
__device__ __forceinline__ T sc_wait(const unsigned long long* words,
                                     long long j, unsigned epoch) {
  constexpr int W = sizeof(T) / 4;
  unsigned long long w[W];
#pragma unroll
  for (int k = 0; k < W; ++k) w[k] = sc_read(words + j * W + k, epoch);
#pragma unroll
  for (int k = 0; k < W; ++k)
    while (lb_flag(w[k], epoch) == 0) {
      __nanosleep(SC_BACKOFF_NS);
      w[k] = sc_read(words + j * W + k, epoch);
    }
  return sc_value<T>(w);
}

// Group g of ITEMS tile totals (one thread of sc_carries: tiles g * ITEMS
// .. g * ITEMS + ITEMS - 1) summed in sequence, as that thread of sc_tile
// adds its items, and published in `groups`. Warp 0.
template <int ITEMS, typename T, class Op>
__device__ __forceinline__ void sc_publish_group(
    const unsigned long long* totals, unsigned long long* groups,
    unsigned epoch, long long g, Op op) {
  static_assert(ITEMS <= 32, "a group is read by one warp");
  const int lane = threadIdx.x;
  const T v = lane < ITEMS ? sc_wait<T>(totals, g * ITEMS + lane, epoch) : T(0);
  T acc = v;
#pragma unroll
  for (int i = 1; i < ITEMS; ++i) acc = op(acc, __shfl_sync(SC_FULL, v, i));
  if (lane == 0) sc_publish(groups, g, epoch, acc);  // lane 0 began at total 0
}

// carries[tile] of sc_carries (scan.cuh), from the published tile totals
// and group sums, with sc_carries' operations in its order. Total tile - 1
// is item iq of thread q of chunk c of sc_carries' chunked scan (chunks of
// THREADS threads of ITEMS totals). Its prefix there is the thread's items
// 0 .. iq in sequence, after (for q > 0) the Hillis-Steele prefix of the
// thread totals before q, the group sums (sums from q on count as ident:
// they change no prefix before q). The carry is the chained carry of the
// chunks before (each chunk's Hillis-Steele total of its group sums) op
// that prefix. Returns it to every thread; sh, stage (ITEMS values) and
// out_sh are the block's scratch.
template <int THREADS, int ITEMS, typename T, class Op>
__device__ T sc_carry_at(const unsigned long long* totals,
                         const unsigned long long* groups, unsigned epoch,
                         long long tile, T ident, Op op, T* sh, T* stage,
                         T* out_sh) {
  constexpr int TILE = THREADS * ITEMS;
  if (tile == 0) return ident;
  const int tid = threadIdx.x;
  const long long last = tile - 1;
  const long long c = last / TILE, cbase = c * TILE;
  const int q = (int)((last - cbase) / ITEMS);
  const int iq = (int)((last - cbase) % ITEMS);
  T chained = ident, total;
  for (long long k = 0; k < c; ++k) {
    sc_block_excl<THREADS>(sc_wait<T>(groups, k * THREADS + tid, epoch),
                           ident, op, sh, &total);
    chained = op(chained, total);
    __syncthreads();  // sh is the next scan's
  }
  const T gs = tid < q ? sc_wait<T>(groups, c * THREADS + tid, epoch) : ident;
  if (tid <= iq) stage[tid] = sc_wait<T>(totals, cbase + q * ITEMS + tid, epoch);
  const T excl = sc_block_excl<THREADS>(gs, ident, op, sh, &total);
  if (tid == q) {
    T loc = stage[0];
    for (int i = 1; i <= iq; ++i) loc = op(loc, stage[i]);
    *out_sh = op(chained, q > 0 ? op(excl, loc) : loc);
  }
  __syncthreads();
  const T carry = *out_sh;
  __syncthreads();  // out_sh and sh are the next tile's
  return carry;
}

// A tile of SC_TILE elements a block, taken by ticket (base and epoch as
// the look-back's): the tile scanned into shared memory (sc_tile_sm), its
// total published; the last tile of each group of SC_ITEMS publishes the
// group's sum; the tile's carry from the totals and group sums before it
// (sc_carry_at); the tile written once (16-byte stores on full tiles of an
// aligned output). Words: the tile totals from
// `status`, then the group sums, each float sizeof(T) / 4 aggregate words
// of this launch's epoch.
template <typename T, class Op>
__global__ void __launch_bounds__(SC_THREADS, SC_MIN_BLOCKS)
    sc_fixed_kernel(const T* __restrict__ x, bool x_aligned, long long n,
                    Op op, T* __restrict__ out, bool out_aligned,
                    unsigned long long* status, unsigned* ticket,
                    unsigned base, unsigned epoch) {
  __shared__ T sm[SC_PAD(SC_TILE)];
  __shared__ T stage[SC_ITEMS];
  __shared__ T sh[SC_THREADS];
  __shared__ unsigned tile_sh;
  __shared__ T out_sh;
  const int tid = threadIdx.x;
  if (tid == 0)
    tile_sh = (BC_OK(ticket, 4) ? atomicAdd(ticket, 1u) : base) - base;
  __syncthreads();
  const long long tile = tile_sh;
  const long long base_e = tile * SC_TILE;
  const long long ntiles = (n + SC_TILE - 1) / SC_TILE;
  unsigned long long* groups = status + ntiles * (long long)(sizeof(T) / 4);
  const T total = sc_tile_sm<SC_THREADS, SC_ITEMS>(
      LoadVecF<T>{x, x_aligned}, base_e, n, T(0), op, sm, sh);
  if (tid == 0) sc_publish(status, tile, epoch, total);
  if (tid < 32 && tile % SC_ITEMS == SC_ITEMS - 1)
    sc_publish_group<SC_ITEMS, T>(status, groups, epoch, tile / SC_ITEMS, op);
  const T carry = sc_carry_at<SC_THREADS, SC_ITEMS>(status, groups, epoch,
                                                    tile, T(0), op, sh, stage,
                                                    &out_sh);
#pragma unroll
  for (int k = 0; k < SC_ITEMS; ++k)
    sm[SC_PAD(tid * SC_ITEMS + k)] = op(carry, sm[SC_PAD(tid * SC_ITEMS + k)]);
  __syncthreads();
  if (base_e + SC_TILE <= n && out_aligned) {
#pragma unroll
    for (int k = 0; k < SC_ITEMS / 4; ++k) {
      const int e = 4 * (k * SC_THREADS + tid);
      if constexpr (sizeof(T) == 8) {
        BC_ST(reinterpret_cast<double2*>(out + base_e + e),
              make_double2(sm[SC_PAD(e)], sm[SC_PAD(e + 1)]));
        BC_ST(reinterpret_cast<double2*>(out + base_e + e + 2),
              make_double2(sm[SC_PAD(e + 2)], sm[SC_PAD(e + 3)]));
      } else {
        BC_ST(reinterpret_cast<float4*>(out + base_e + e),
              make_float4(sm[SC_PAD(e)], sm[SC_PAD(e + 1)],
                          sm[SC_PAD(e + 2)], sm[SC_PAD(e + 3)]));
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < SC_ITEMS; ++k) {
      const int e = k * SC_THREADS + tid;
      if (base_e + e < n) BC_ST(out + base_e + e, sm[SC_PAD(e)]);
    }
  }
}

// One launch over n elements on the look-back's scratch (lb_run: its next
// epoch and tickets): it takes (sizeof(T) / 4) * (ntiles + ceil(ntiles /
// SC_ITEMS)) + 1 words, the tile totals and the group sums after the
// ticket's word.
template <typename T, class Op>
static int sc_fixed(const T* x, T* out, long long n, Op op,
                    unsigned long long* words, long long capacity,
                    unsigned* state, void* stream) {
  if (n == 0) return (int)cudaGetLastError();
  const long long ntiles = (n + SC_TILE - 1) / SC_TILE;
  const long long need =
      (ntiles + (ntiles + SC_ITEMS - 1) / SC_ITEMS) * (long long)(sizeof(T) / 4) +
      1;
  return lb_run(ntiles, need, words, capacity, state, stream,
                [&](cudaStream_t s, unsigned long long* status,
                    unsigned* ticket, unsigned base, unsigned epoch) {
                  sc_fixed_kernel<T><<<(unsigned)ntiles, SC_THREADS, 0, s>>>(
                      x, aligned16(x), n, op, out, aligned16(out), status,
                      ticket, base, epoch);
                });
}

extern "C" int scan_f32_launch(const float* x, float* out, long long n,
                               unsigned long long* words, long long capacity,
                               unsigned* state, void* stream) {
  return sc_fixed(x, out, n, AddF(), words, capacity, state, stream);
}

// The float64 instance: the engine's mass prefixes (sampling.py), which a
// look-back would sum in a run-dependent order.
extern "C" int scan_f64_launch(const double* x, double* out, long long n,
                               unsigned long long* words, long long capacity,
                               unsigned* state, void* stream) {
  return sc_fixed(x, out, n, AddD(), words, capacity, state, stream);
}
