// One launch from a Threefry key to the compacted sample rows: the
// sort-free EXPRACE draw (or flat PTBERN) plus the tree walk of every
// sampled position.
//
// Replaces fused_draw of src/repro/kernels/fused_draw.py (its _kernel,
// draw_core, _exprace_core, _ptbern_core and _count_le), which runs as
// grid=(1,), and fused_sample of the same file (its _sample_kernel: the
// draw without the walk, the paged draw's front end). Both are one kernel
// body here, fused_draw_kernel<WALK>: fused_sample is the instance that
// writes each position and skips the walk, so the two give bit-equal
// positions under one key. This is the reference's shape: ONE block of
// 1024 threads. Stages are
// separated by __syncthreads(); their scratch vectors (length acap, n or
// R + 1) live in device memory, allocated by the Python wrapper. The
// running sums (the float arrival times, the int counts, one int cummax)
// are block scans over chunks of FD_THREADS * FD_ITEMS elements that carry
// the running total from chunk to chunk.
//
// Bound on the card: one SM does all the work, so the draw is bound by that
// SM's load latency and its serial chunk loop, not by device bandwidth;
// every output lane runs several binary searches and a full tree walk. This
// first version accepts that (the reference's budget keeps acap and cap to
// a few hundred thousand lanes); spreading it over all SMs is later work.
//
// The float32 arrival sum is the only order-sensitive step. Its order is
// fixed here and repeated by the plain version (fused_draw.py _scan_f32):
// within a chunk thread t adds its FD_ITEMS elements in sequence; thread
// totals are scanned Hillis-Steele (distance 1, 2, 4, ...); an element is
// carry + (exclusive thread prefix + local prefix). Built with -fmad=false
// and explicit round-to-nearest operations, so the kernel and the plain
// version agree bit for bit on the card. That order is not monotone: at a
// thread or chunk boundary an element's sum is rounded along another path
// than its predecessor's, and after a tiny gap it can land an ulp below it.
// Arrivals must ascend (a dip places two arrivals' cells out of order and
// breaks the ascending positions), so a running max follows the sum; max
// is exact, so it needs no fixed order.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "threefry.cuh"
#include "tree_walk.cuh"

#define FD_THREADS 1024
#define FD_ITEMS 8
#define FD_CHUNK (FD_THREADS * FD_ITEMS)

struct AddF {
  __device__ float operator()(float a, float b) const { return __fadd_rn(a, b); }
};
struct MaxF {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct AddI {
  __device__ int operator()(int a, int b) const { return a + b; }
};
struct MaxI {
  __device__ int operator()(int a, int b) const { return max(a, b); }
};

// #elements of the ascending vec[0, L) that are <= q (branchless descent).
template <typename T>
__device__ __forceinline__ int fd_count_le(const T* __restrict__ vec, int L,
                                           T q) {
  const int steps = max(1, 32 - __clz(L));
  int p = 0;
  for (int k = steps - 1; k >= 0; --k) {
    const int cand = p + (1 << k);
    const T val = vec[min(cand, L) - 1];
    if (cand <= L && val <= q) p = cand;
  }
  return p;
}

// In-place inclusive scan of data[0, n) by the whole block (order above).
template <typename T, typename Op>
__device__ void fd_block_scan(T* data, int n, T ident, Op op, T* sh,
                              T* carry_sh) {
  const int t = threadIdx.x;
  __syncthreads();
  if (t == 0) *carry_sh = ident;
  __syncthreads();
  for (int base = 0; base < n; base += FD_CHUNK) {
    const int i0 = base + t * FD_ITEMS;
    T loc[FD_ITEMS];
    T acc = ident;
#pragma unroll
    for (int e = 0; e < FD_ITEMS; ++e) {
      const int i = i0 + e;
      const T x = i < n ? data[i] : ident;
      acc = e == 0 ? x : op(acc, x);
      loc[e] = acc;
    }
    sh[t] = acc;
    __syncthreads();
    for (int d = 1; d < FD_THREADS; d <<= 1) {
      const T other = t >= d ? sh[t - d] : ident;
      __syncthreads();
      if (t >= d) sh[t] = op(sh[t], other);
      __syncthreads();
    }
    const T excl = t > 0 ? sh[t - 1] : ident;
    const T carry = *carry_sh;
#pragma unroll
    for (int e = 0; e < FD_ITEMS; ++e) {
      const int i = i0 + e;
      const T pre = t > 0 ? op(excl, loc[e]) : loc[e];
      if (i < n) data[i] = base > 0 ? op(carry, pre) : pre;
    }
    __syncthreads();
    if (t == 0) *carry_sh = base > 0 ? op(carry, sh[FD_THREADS - 1])
                                     : sh[FD_THREADS - 1];
    __syncthreads();
  }
}

#define FD_EXPRACE 0
#define FD_PTBERN 1

// Output lane tt: its position, then (WALK) the walk of that position.
template <bool WALK>
__device__ __forceinline__ void fd_emit(const int* __restrict__ arena,
                                        const RtLayout& L, int tt, int cap,
                                        int p_out, int n32,
                                        int* __restrict__ rows,
                                        int* __restrict__ positions) {
  positions[tt] = p_out;
  if (!WALK) return;
  int rws[RT_MAX_SLOTS];
  rt_tree_walk(arena, L, min(p_out, n32 - 1), rws);
  for (int s = 0; s <= L.num_edges; ++s) rows[(long long)s * cap + tt] = rws[s];
}

// Flat PTBERN over n = prefE32[R] lanes: one trial per flat position, a
// running count C, and lane tt = the first flat position with C == tt + 1.
template <bool WALK>
__device__ void fd_ptbern(const int* __restrict__ arena, const RtLayout& L,
                          uint32_t k0, uint32_t k1,
                          const int* __restrict__ prefE32,
                          const float* __restrict__ p32, int R, int n,
                          int cap, int* __restrict__ rows,
                          int* __restrict__ positions,
                          int* __restrict__ scalars, int* C, int* sh,
                          int* carry) {
  const int t = threadIdx.x;
  const int n32 = prefE32[R];
  uint32_t s0, s1;
  rt_fold(k0, k1, 1u, s0, s1);
  for (int i = t; i < n; i += FD_THREADS) {
    const int r = min(max(fd_count_le(prefE32, R + 1, i) - 1, 0), R - 1);
    C[i] = rt_uniform_at(s0, s1, (uint32_t)i) < p32[r] ? 1 : 0;
  }
  fd_block_scan(C, n, 0, AddI(), sh, carry);
  const int total = C[n - 1];
  const int count = min(total, cap);
  for (int tt = t; tt < cap; tt += FD_THREADS) {
    const int pos = min(fd_count_le(C, n, tt), n - 1);
    fd_emit<WALK>(arena, L, tt, cap, tt < count ? pos : n32, n32, rows,
                  positions);
  }
  if (t == 0) {
    scalars[0] = count;
    scalars[1] = total > cap ? 1 : 0;
  }
}

template <bool WALK>
__global__ void __launch_bounds__(FD_THREADS) fused_draw_kernel(
    const int* __restrict__ arena, const __grid_constant__ RtLayout L,
    uint32_t k0, uint32_t k1, int method, const float* __restrict__ massE,
    const float* __restrict__ lam, const int* __restrict__ sign,
    const int* __restrict__ w32, const int* __restrict__ prefE32,
    const int* __restrict__ cwE, const int* __restrict__ offE,
    const float* __restrict__ p32, int R, int acap, int cap,
    int* __restrict__ rows, int* __restrict__ positions,
    int* __restrict__ scalars, float* v, int* gid, int* seg, int* U, int* S,
    int* gc, int* outE, int* hitsE) {
  __shared__ float shf[FD_THREADS];
  __shared__ int shi[FD_THREADS];
  __shared__ float carry_f;
  __shared__ int carry_i;
  if (method == FD_PTBERN) {
    // acap is the lane count here: the join size n.
    fd_ptbern<WALK>(arena, L, k0, k1, prefE32, p32, R, acap, cap, rows,
                    positions, scalars, gid, shi, &carry_i);
    return;
  }
  const int t = threadIdx.x;
  const int n32 = prefE32[R];
  const float Lam = massE[R];

  // Arrivals: Exp(1) gaps, summed — a unit-rate Poisson process on [0, Lam).
  uint32_t s0, s1;
  rt_fold(k0, k1, 0u, s0, s1);
  for (int i = t; i < acap; i += FD_THREADS)
    v[i] = -log1pf(-rt_uniform_at(s0, s1, (uint32_t)i));
  fd_block_scan(v, acap, 0.0f, AddF(), shf, &carry_f);
  fd_block_scan(v, acap, -CUDART_INF_F, MaxF(), shf, &carry_f);

  // Cell placement: inverse CDF into the mass prefix.
  for (int i = t; i < acap; i += FD_THREADS) {
    const float vi = v[i];
    const int r = min(max(fd_count_le(massE, R + 1, vi) - 1, 0), R - 1);
    const float x = __fdiv_rn(__fsub_rn(vi, massE[r]), fmaxf(lam[r], 1e-12f));
    int cell = (int)floorf(x);
    cell = min(max(cell, 0), max(w32[r] - 1, 0));
    gid[i] = vi < Lam ? prefE32[r] + cell : n32;
  }
  __syncthreads();

  // Dedupe (>= 1 arrival in a cell is one success or failure), segment of
  // each lane in the root prefix, unsigned and signed running counts.
  for (int i = t; i < acap; i += FD_THREADS) {
    const int g = gid[i];
    const int prev = i > 0 ? gid[i - 1] : -1;
    const int uq = (g < n32 && g != prev) ? 1 : 0;
    const int sg = min(max(fd_count_le(prefE32, R + 1, g) - 1, 0), R - 1);
    seg[i] = sg;
    U[i] = uq;
    S[i] = uq ? sign[sg] : 0;
  }
  fd_block_scan(U, acap, 0, AddI(), shi, &carry_i);
  fd_block_scan(S, acap, 0, AddI(), shi, &carry_i);

  // Per-root output prefix (outE) and hit prefix (hitsE) via boundary counts.
  for (int j = t; j <= R; j += FD_THREADS) {
    const int B = fd_count_le(gid, acap, prefE32[j] - 1);
    outE[j] = cwE[j] + (B > 0 ? S[B - 1] : 0);
    hitsE[j] = B > 0 ? U[B - 1] : 0;
  }
  __syncthreads();

  // Complement support: carry-forward g-values, kept ascending by cummax.
  for (int i = t; i < acap; i += FD_THREADS) {
    const int g = gid[i];
    const int prev = i > 0 ? gid[i - 1] : -1;
    int val = -(1 << 30);
    if (g < n32 && g != prev) {
      const int sg = seg[i];
      const int lrank = (U[i] - 1) - hitsE[sg];
      val = (g - prefE32[sg]) - lrank + offE[sg];
    }
    gc[i] = val;
  }
  fd_block_scan(gc, acap, INT_MIN, MaxI(), shi, &carry_i);

  // Output slots (gather-only compaction), then the walk of each position.
  const int K = outE[R];
  const int count = min(K, cap);
  for (int tt = t; tt < cap; tt += FD_THREADS) {
    const int rO = min(max(fd_count_le(outE, R + 1, tt) - 1, 0), R - 1);
    const int l = tt - outE[rO];
    const int wm1 = max(w32[rO] - 1, 0);
    const int hO = hitsE[rO];
    const int i_star = min(fd_count_le(U, acap, hO + l), acap - 1);
    const int direct_local = gid[i_star] - prefE32[rO];
    const int Lq = fd_count_le(gc, acap, l + offE[rO]);
    const int c = (Lq > 0 ? U[Lq - 1] : 0) - hO;
    const int comp_pos = l + min(max(c, 0), wm1 - l + 1);
    const int local_out = sign[rO] < 0 ? comp_pos : direct_local;
    const int pos = prefE32[rO] + min(max(local_out, 0), wm1);
    fd_emit<WALK>(arena, L, tt, cap, tt < count ? pos : n32, n32, rows,
                  positions);
  }
  if (t == 0) {
    scalars[0] = count;
    scalars[1] = (v[acap - 1] < Lam || K > cap) ? 1 : 0;
  }
}

// `lanes` is acap for EXPRACE and the join size n for flat PTBERN; every
// scratch vector holds `lanes` elements (outE, hitsE: R + 1).
extern "C" int fused_draw_launch(
    const int* arena, const int* table, unsigned k0, unsigned k1, int method,
    const float* massE, const float* lam, const int* sign, const int* w32,
    const int* prefE32, const int* cwE, const int* offE, const float* p32,
    int R, int lanes, int cap, int* rows, int* positions, int* scalars,
    float* v, int* gid, int* seg, int* U, int* S, int* gc, int* outE,
    int* hitsE, void* stream) {
  const RtLayout L = rt_layout_from_table(table);
  fused_draw_kernel<true><<<1, FD_THREADS, 0, (cudaStream_t)stream>>>(
      arena, L, k0, k1, method, massE, lam, sign, w32, prefE32, cwE, offE,
      p32, R, lanes, cap, rows, positions, scalars, v, gid, seg, U, S, gc,
      outE, hitsE);
  return (int)cudaGetLastError();
}

// The draw without the walk: positions, count and overflow only. The
// kernel reads no arena and no layout.
extern "C" int fused_sample_launch(
    unsigned k0, unsigned k1, int method, const float* massE,
    const float* lam, const int* sign, const int* w32, const int* prefE32,
    const int* cwE, const int* offE, const float* p32, int R, int lanes,
    int cap, int* positions, int* scalars, float* v, int* gid, int* seg,
    int* U, int* S, int* gc, int* outE, int* hitsE, void* stream) {
  RtLayout L = {};
  fused_draw_kernel<false><<<1, FD_THREADS, 0, (cudaStream_t)stream>>>(
      nullptr, L, k0, k1, method, massE, lam, sign, w32, prefE32, cwE, offE,
      p32, R, lanes, cap, nullptr, positions, scalars, v, gid, seg, U, S, gc,
      outE, hitsE);
  return (int)cudaGetLastError();
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
