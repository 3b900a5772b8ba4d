// Inclusive prefix sums and fused GEO positions: one reduce-then-scan.
//
// Replaces two TPU kernels of src/repro/kernels/:
//   prefix_sum.py prefix_sum_tiles -> scan_i32_launch, scan_f32_launch;
//   geo_gaps.py   geo_gaps_tiles   -> geo_gaps_launch.
// The TPU kernels carry the running total from one grid step to the next in
// an SMEM scalar; Hopper blocks run in no order, so the carry becomes two
// extra passes:
//   1. every block reduces its tile of SC_TILE elements to one total;
//   2. one block scans the tile totals (chunks of SC_TILE, the carry chained
//      through the chunks) into each tile's exclusive carry;
//   3. every block scans its tile again and adds its carry.
// GEO is the same scan with a prologue (the geometric step of a uniform)
// and an epilogue (- 1): one template serves all three entries.
//
// Bound on the card: bytes. Each element is read once and written once
// (8 bytes for int32 and float32, 8 for a GEO lane: its uniform and its
// position). This design reads the input twice (passes 1 and 3), so it
// moves 12 bytes an element at best; a single-pass decoupled look-back
// scan would reach 8 and is later work. Loads stage through shared memory
// in coalesced order; each thread then runs SC_ITEMS consecutive elements.
//
// Order. int32 adds in uint32, so it wraps as XLA's int32 cumsum wraps and
// any order gives the same bits. float32 is order-sensitive; the order is
// fixed here and repeated by the plain version (prefix_sum.py _scan_f32):
// a thread's SC_ITEMS elements in sequence; the thread totals scanned
// Hillis-Steele (distance 1, 2, 4, ...); an element is (exclusive thread
// prefix + its local prefix), except in thread 0; the final value is
// carry + that. Built with -fmad=false and round-to-nearest adds, kernel and
// plain version agree bit for bit.
//
// GEO keeps the reference's divide (geo_gaps.py:31-34): floor() turns a
// last-ulp difference of a reciprocal multiply into an off-by-one position.
#include <cuda_runtime.h>
#include <stdint.h>

#define SC_THREADS 256
#define SC_ITEMS 16
#define SC_TILE (SC_THREADS * SC_ITEMS)
// Shared-memory slot of tile element e: one pad word every 32 keeps the
// per-thread runs (stride SC_ITEMS) off a shared bank.
#define SC_PAD(e) ((e) + ((e) >> 5))

struct AddU {
  __device__ uint32_t operator()(uint32_t a, uint32_t b) const { return a + b; }
};
struct AddF {
  __device__ float operator()(float a, float b) const { return __fadd_rn(a, b); }
};

// Prologues: element i of the input as the scanned type.
template <typename T>
struct LoadPtr {
  const T* x;
  __device__ T operator()(long long i) const { return x[i]; }
};
struct LoadGeo {
  const float* u;
  float p;  // clipped to [1e-12, 1 - 1e-7] by the wrapper, as the reference
  // The step: floor(log(u) / log1p(-p)) + 1 (the divide, not a reciprocal
  // multiply), the gap clamped to 2e9 before the cast.
  __device__ uint32_t operator()(long long i) const {
    const float g = floorf(__fdiv_rn(logf(fmaxf(u[i], 1e-12f)), log1pf(-p)));
    return (uint32_t)((int)fminf(g, 2000000000.0f) + 1);
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

// The block's tile [base, base + SC_TILE) of n: `pre` gets the tile-local
// inclusive prefix of this thread's items; the tile total is returned.
template <typename T, class Load, class Op>
__device__ __forceinline__ T sc_tile(Load load, long long base, long long n, T ident, Op op,
                     T* sm, T* sh, T pre[SC_ITEMS]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < SC_ITEMS; ++i) {
    const int e = i * SC_THREADS + tid;
    sm[SC_PAD(e)] = base + e < n ? load(base + e) : ident;
  }
  __syncthreads();
  T acc = sm[SC_PAD(tid * SC_ITEMS)];
  pre[0] = acc;
#pragma unroll
  for (int i = 1; i < SC_ITEMS; ++i) {
    acc = op(acc, sm[SC_PAD(tid * SC_ITEMS + i)]);
    pre[i] = acc;
  }
  sh[tid] = acc;
  __syncthreads();
  for (int d = 1; d < SC_THREADS; d *= 2) {
    T val = sh[tid];
    if (tid >= d) val = op(val, sh[tid - d]);
    __syncthreads();
    sh[tid] = val;
    __syncthreads();
  }
  if (tid > 0) {
    const T excl = sh[tid - 1];
#pragma unroll
    for (int i = 0; i < SC_ITEMS; ++i) pre[i] = op(excl, pre[i]);
  }
  const T total = sh[SC_THREADS - 1];
  __syncthreads();  // sm and sh are reused by the caller's next tile
  return total;
}

// Pass 1: the total of each tile.
template <typename T, class Load, class Op>
__global__ void __launch_bounds__(SC_THREADS)
    sc_totals_kernel(Load load, long long n, T ident, Op op, T* totals) {
  __shared__ T sm[SC_PAD(SC_TILE)];
  __shared__ T sh[SC_THREADS];
  T pre[SC_ITEMS];
  const T total = sc_tile<T>(load, (long long)blockIdx.x * SC_TILE, n, ident,
                             op, sm, sh, pre);
  if (threadIdx.x == 0) totals[blockIdx.x] = total;
}

// Pass 2, one block: carries[t] = totals[0] + ... + totals[t - 1].
template <typename T, class Op>
__global__ void __launch_bounds__(SC_THREADS)
    sc_carries_kernel(const T* totals, int ntiles, T ident, Op op,
                      T* carries) {
  __shared__ T sm[SC_PAD(SC_TILE)];
  __shared__ T sh[SC_THREADS];
  T pre[SC_ITEMS];
  T carry = ident;
  const LoadPtr<T> load{totals};
  if (threadIdx.x == 0) carries[0] = ident;
  for (long long base = 0; base < ntiles; base += SC_TILE) {
    const T total = sc_tile<T>(load, base, ntiles, ident, op, sm, sh, pre);
#pragma unroll
    for (int i = 0; i < SC_ITEMS; ++i) {
      const long long t = base + threadIdx.x * SC_ITEMS + i;
      if (t + 1 < ntiles) carries[t + 1] = op(carry, pre[i]);
    }
    carry = op(carry, total);
  }
}

// Pass 3: out = epi(carry of the tile + the tile-local prefix).
template <typename T, typename Out, class Load, class Op, class Epi>
__global__ void __launch_bounds__(SC_THREADS)
    sc_scan_kernel(Load load, long long n, T ident, Op op, const T* carries,
                   Epi epi, Out* out) {
  __shared__ T sm[SC_PAD(SC_TILE)];
  __shared__ T sh[SC_THREADS];
  T pre[SC_ITEMS];
  const long long base = (long long)blockIdx.x * SC_TILE;
  sc_tile<T>(load, base, n, ident, op, sm, sh, pre);
  const T carry = carries[blockIdx.x];
  // Back through shared memory, so that the stores are coalesced.
#pragma unroll
  for (int i = 0; i < SC_ITEMS; ++i)
    sm[SC_PAD(threadIdx.x * SC_ITEMS + i)] = epi(op(carry, pre[i]));
  __syncthreads();
#pragma unroll
  for (int i = 0; i < SC_ITEMS; ++i) {
    const int e = i * SC_THREADS + threadIdx.x;
    if (base + e < n) {
      const T val = sm[SC_PAD(e)];
      out[base + e] = *reinterpret_cast<const Out*>(&val);
    }
  }
}

template <typename T, typename Out, class Load, class Op, class Epi>
static int sc_launch(Load load, long long n, T ident, Op op, Epi epi,
                     T* totals, T* carries, Out* out, void* stream) {
  if (n == 0) return (int)cudaGetLastError();
  const long long ntiles = (n + SC_TILE - 1) / SC_TILE;
  cudaStream_t s = (cudaStream_t)stream;
  sc_totals_kernel<T><<<(unsigned)ntiles, SC_THREADS, 0, s>>>(load, n, ident,
                                                              op, totals);
  int err = (int)cudaGetLastError();
  if (err) return err;
  sc_carries_kernel<T><<<1, SC_THREADS, 0, s>>>(totals, (int)ntiles, ident, op,
                                                carries);
  err = (int)cudaGetLastError();
  if (err) return err;
  sc_scan_kernel<T, Out><<<(unsigned)ntiles, SC_THREADS, 0, s>>>(
      load, n, ident, op, carries, epi, out);
  return (int)cudaGetLastError();
}

// totals and carries: scratch of sc_tiles(n) words each (the wrapper's).
extern "C" int scan_i32_launch(const int* x, int* out, long long n,
                               uint32_t* totals, uint32_t* carries,
                               void* stream) {
  return sc_launch<uint32_t, int>(LoadPtr<uint32_t>{(const uint32_t*)x}, n, 0u,
                                  AddU(), Same(), totals,
                                  carries, out, stream);
}

extern "C" int scan_f32_launch(const float* x, float* out, long long n,
                               float* totals, float* carries, void* stream) {
  return sc_launch<float, float>(LoadPtr<float>{x}, n, 0.0f, AddF(), Same(),
                                 totals,
                                 carries, out, stream);
}

// p_clipped: p already clipped to [1e-12, 1 - 1e-7] in float32 by the
// wrapper, as the reference clips it.
extern "C" int geo_gaps_launch(const float* u, float p_clipped, int* out,
                               long long n, uint32_t* totals,
                               uint32_t* carries, void* stream) {
  return sc_launch<uint32_t, int>(LoadGeo{u, p_clipped}, n, 0u, AddU(),
                                  MinusOne(), totals, carries, out, stream);
}
