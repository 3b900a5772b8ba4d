// Block-level scan pieces shared by csrc/scan.cu and csrc/fused_draw.cu.
//
// A tile is THREADS * ITEMS consecutive elements, scanned by one block:
// thread t owns the ITEMS elements [t * ITEMS, (t + 1) * ITEMS) and adds
// them in sequence; the thread totals are scanned across the block; an
// element is (exclusive thread prefix) op (its local prefix).
//
// The float32 and float64 sums are order-sensitive, so their order is fixed
// and repeated by the plain version (prefix_sum.py scan_order, which every
// plain version calls): the thread totals are scanned Hillis-Steele in shared memory
// (distance 1, 2, 4, ...), thread 0 takes its local prefixes as they are,
// and across tiles the carries are the same tile function run over the tile
// totals in chunks of one tile, the carry chained from chunk to chunk
// (sc_carries). Built with -fmad=false and round-to-nearest adds, kernel
// and plain version agree bit for bit.
//
// Operations that are exact in any order (integer adds, max) say so with
// kExact and take a faster block scan: warp shuffles, then one warp over
// the warp totals.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Shared-memory slot of tile element e: one pad word every 32 keeps both
// the per-thread runs (stride ITEMS) and the 16-byte staging of a vector
// load off a shared bank.
#define SC_PAD(e) ((e) + ((e) >> 5))
#define SC_FULL 0xffffffffu

struct AddU {
  static constexpr bool kExact = true;
  __device__ uint32_t operator()(uint32_t a, uint32_t b) const { return a + b; }
};
struct AddI {
  static constexpr bool kExact = true;
  __device__ int operator()(int a, int b) const { return a + b; }
};
struct AddF {
  static constexpr bool kExact = false;
  __device__ float operator()(float a, float b) const { return __fadd_rn(a, b); }
};
struct AddD {
  static constexpr bool kExact = false;
  __device__ double operator()(double a, double b) const {
    return __dadd_rn(a, b);
  }
};
struct MaxF {
  static constexpr bool kExact = true;
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct MaxI {
  static constexpr bool kExact = true;
  __device__ int operator()(int a, int b) const { return max(a, b); }
};

// Element i of a vector in memory. No 16-byte path: see LoadVecU32.
template <typename T>
struct LoadPtr {
  static constexpr bool kVec = false;
  const T* x;
  __device__ T operator()(long long i) const { return x[i]; }
};

// One value per thread scanned across the block: returns this thread's
// exclusive prefix (ident in thread 0) and the block total in *total.
template <int THREADS, typename T, class Op>
__device__ __forceinline__ T sc_block_excl(T acc, T ident, Op op, T* sh,
                                           T* total) {
  const int tid = threadIdx.x;
  if constexpr (!Op::kExact) {
    // Hillis-Steele over all THREADS values: the fixed float32 order.
    sh[tid] = acc;
    __syncthreads();
    for (int d = 1; d < THREADS; d *= 2) {
      T val = sh[tid];
      if (tid >= d) val = op(val, sh[tid - d]);
      __syncthreads();
      sh[tid] = val;
      __syncthreads();
    }
    *total = sh[THREADS - 1];
    return tid > 0 ? sh[tid - 1] : ident;
  } else {
    constexpr int NW = THREADS / 32;
    const int lane = tid & 31, warp = tid >> 5;
    T v = acc;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const T o = __shfl_up_sync(SC_FULL, v, d);
      if (lane >= d) v = op(o, v);
    }
    if (lane == 31) sh[warp] = v;
    __syncthreads();
    if (warp == 0) {
      T w = lane < NW ? sh[lane] : ident;
#pragma unroll
      for (int d = 1; d < NW; d *= 2) {
        const T o = __shfl_up_sync(SC_FULL, w, d);
        if (lane >= d) w = op(o, w);
      }
      if (lane < NW) sh[lane] = w;
    }
    __syncthreads();
    const T wexcl = warp > 0 ? sh[warp - 1] : ident;
    const T up = __shfl_up_sync(SC_FULL, v, 1);
    *total = sh[NW - 1];
    return lane > 0 ? op(wexcl, up) : wexcl;
  }
}

// Stages the tile [base, base + THREADS * ITEMS) of n in shared memory:
// sm[SC_PAD(e)] = element base + e, ident past n. A Load with kVec and a
// true vec_ok() reads full tiles with 16-byte loads (neighbouring threads on
// neighbouring vectors); any other load is one coalesced element a thread.
// The caller syncs before reading sm.
template <int THREADS, int ITEMS, typename T, class Load>
__device__ __forceinline__ void sc_stage(const Load& load, long long base,
                                         long long n, T ident, T* sm) {
  constexpr int TILE = THREADS * ITEMS;
  const int tid = threadIdx.x;
  if constexpr (Load::kVec) {
    static_assert(ITEMS % 4 == 0, "16-byte staging takes 4 items a vector");
    if (base + TILE <= n && load.vec_ok()) {
#pragma unroll
      for (int i = 0; i < ITEMS / 4; ++i) {
        const int e = 4 * (i * THREADS + tid);
        T q[4];
        load.load4(base + e, q);
#pragma unroll
        for (int j = 0; j < 4; ++j) sm[SC_PAD(e + j)] = q[j];
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int e = i * THREADS + tid;
    sm[SC_PAD(e)] = base + e < n ? load(base + e) : ident;
  }
}

// The block's tile [base, base + THREADS * ITEMS) of n: `pre` gets the
// tile-local inclusive prefix of this thread's items; the tile total is
// returned. Elements past n count as ident.
template <int THREADS, int ITEMS, typename T, class Load, class Op>
__device__ __forceinline__ T sc_tile(const Load& load, long long base,
                                     long long n, T ident, Op op, T* sm,
                                     T* sh, T (&pre)[ITEMS]) {
  const int tid = threadIdx.x;
  sc_stage<THREADS, ITEMS>(load, base, n, ident, sm);
  __syncthreads();
  T acc = sm[SC_PAD(tid * ITEMS)];
  pre[0] = acc;
#pragma unroll
  for (int i = 1; i < ITEMS; ++i) {
    acc = op(acc, sm[SC_PAD(tid * ITEMS + i)]);
    pre[i] = acc;
  }
  T total;
  const T excl = sc_block_excl<THREADS>(acc, ident, op, sh, &total);
  if (Op::kExact || tid > 0) {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) pre[i] = op(excl, pre[i]);
  }
  __syncthreads();  // sm and sh are reused by the caller's next tile
  return total;
}

// carries[t] = the chunked scan of load(0), ..., load(t - 1); carries[0] =
// ident. One block: the tile function over chunks of THREADS * ITEMS
// values, the carry chained from chunk to chunk.
template <int THREADS, int ITEMS, typename T, class Load, class Op>
__device__ void sc_carries(const Load& load, long long ntiles, T ident, Op op,
                           T* carries, T* sm, T* sh) {
  constexpr int TILE = THREADS * ITEMS;
  T pre[ITEMS];
  T carry = ident;
  if (threadIdx.x == 0) carries[0] = ident;
  for (long long base = 0; base < ntiles; base += TILE) {
    const T total = sc_tile<THREADS, ITEMS>(load, base, ntiles, ident, op, sm,
                                            sh, pre);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const long long t = base + threadIdx.x * ITEMS + i;
      if (t + 1 < ntiles) carries[t + 1] = op(carry, pre[i]);
    }
    carry = op(carry, total);
  }
}
