// The CSR GET's chain walk: one tree edge, every probe.
//
// Replaces the vmapped while-loop _csr_walk (src/repro/core/probe.py:403)
// and the lax.scan of _csr_walk_cached (src/repro/core/probe.py:434, the
// paper's Fig. 11). Given the child's weights and its same-key chain (nxt,
// -1 terminates) and per probe a chain head hd and an offset idx, each
// probe walks from its head while row >= 0 and rem >= weight[row],
// subtracting each passed row's weight (Fig. 4 lines 11-15; weight-0 rows
// are passed). Out: the row where it stopped (-1 past the chain) and what
// is left of the offset.
//
// What bounds it. Each step is two dependent loads (weight[row], then
// nxt[row]) at a row of the child that the chain picks, not the probe's
// neighbour's: latency, not bandwidth, unless enough probes walk at once.
// The bytes bound is the probes' own words (hd, idx in; row, rem out) plus
// 12 bytes a step actually taken.
//
// Two modes, one result:
//  * cached = 0: one thread a probe, each walking from its head (the
//    reference's data-parallel walk).
//  * cached = 1: the reference's scan carries (head, row, consumed) from a
//    probe to the next and resumes from the carried row while the head
//    repeats and the offset has not fallen below what was consumed.
//    Resuming ends where a walk from the head ends (the chain's
//    cumulative weight is nondecreasing, and a walk stops at the first row
//    whose cumulative weight, its own included, exceeds the offset), so
//    the cache changes the links walked, never a probe's (row, rem). The
//    kernel shares the links of a run of equal heads instead of carrying
//    them from probe to probe, one lane a probe:
//      - a block of CW_WALKERS threads takes a tile of CW_TILE consecutive
//        probes: coalesced loads of hd and idx into shared memory, a bit a
//        lane for the run starts (ballots), the runs listed in lane order;
//        a run that spans tiles restarts from the head in each;
//      - the threads take the tile's runs one after another from a shared
//        counter, so that a long chain holds one thread and not a warp: a
//        run of one probe is walked from its head (cw_step); a run of two
//        or more is walked once from the head up to the row where its
//        largest offset stops (or the chain's end), and the rows from the
//        one where its smallest offset stops are staged in shared memory,
//        each with its cumulative weight (32 bits, relative to the weight
//        before the first staged row): entry k of the tile's walker w at
//        k * W + w, the W walkers sharing CW_BUDGET entries, CW_BUDGET / W
//        each;
//      - then every lane searches its run's staged rows for the first
//        whose cumulative weight exceeds its offset (past the chain: row
//        -1 and the offset less the chain's weight);
//      - a run whose rows do not fit its share (or whose relative weight
//        passes 32 bits) stages what fits, and a probe past that resumes
//        the walk from there on its own lane (the fallback);
//      - stores are coalesced, one lane a probe.
//    No run walks more links than the plain walk of its largest offset, and
//    a probe that resumes walks only links past the staged rows, so the
//    kernel never walks more links than cached = 0. What bounds it is the
//    walkers' dependent loads, each link two 32-byte sectors of rows the
//    chain scatters over the child: a block lasts as long as its longest
//    walk or its threads' share of the walks, whichever is longer, so many
//    small blocks (6 KB of shared memory and 64 threads each, 32 an SM)
//    keep the most walks in flight. A stats pointer, when given, takes the
//    tiles' counts of staged runs, of runs that fell back and of runs of
//    one probe (csr_walk.py csr_walk_cached_tiled is the plain model of
//    the tiles, the staging and the fallback).
//
// The checked build (-DCW_CHECK_BOUNDS; csr_walk.out_of_bounds) holds every
// load of a chain link, a head or an offset and every store of a result or
// a count against the launch's operands (bounds_check.cuh). A next link
// outside them reads as -1, the chain's end: read as 0 it would send the
// walk back to row 0, and round a chain of weight-0 rows forever.
#include <cuda_runtime.h>

#ifdef CW_CHECK_BOUNDS
#define BC_CHECK_BOUNDS
#endif
#include "bounds_check.cuh"

BC_CHECK_ENTRIES(csr_walk)

#define CW_THREADS 256
// csr_walk_cached: threads a block, probes a tile (CW_ITEMS a thread) and
// chain rows a tile stages. Mirrored by csr_walk.py TILE and BUDGET.
#define CW_WALKERS 64
#define CW_ITEMS 2
#define CW_TILE 128
#define CW_BUDGET 512
#define CW_MASKS (CW_TILE / 32)
#define CW_FULL 0xffffffffu
static_assert(CW_TILE == CW_WALKERS * CW_ITEMS, "a tile is the block's items");
static_assert(CW_TILE / 2 < 2048 && CW_BUDGET < 4096,
              "a run's walker packs in 11 bits, its staged rows in 12");

__device__ __forceinline__ void cw_step(const long long* __restrict__ weight,
                                        const int* __restrict__ nxt, int& row,
                                        long long& rem, long long& used) {
  while (row >= 0) {
    const long long w = __ldg(weight + row);
    if (rem < w) break;
    rem -= w;
    used += w;
    row = BC_LDG_OR(nxt + row, -1);
  }
}

__global__ void __launch_bounds__(CW_THREADS)
    csr_walk_kernel(const long long* __restrict__ weight,
                    const int* __restrict__ nxt, const int* __restrict__ hd,
                    const long long* __restrict__ idx, int* __restrict__ row_out,
                    long long* __restrict__ rem_out, long long n) {
  const long long i = (long long)blockIdx.x * CW_THREADS + threadIdx.x;
  if (i >= n) return;
  int row = __ldg(hd + i);
  long long rem = __ldg(idx + i), used = 0;
  cw_step(weight, nxt, row, rem, used);
  BC_ST(row_out + i, row);
  BC_ST(rem_out + i, rem);
}

// The caching walk over tiles of CW_TILE probes (the design above).
// stats: null, or the counts [staged, fallback, single] that each block
// adds to.
__global__ void __launch_bounds__(CW_WALKERS)
    csr_walk_cached_kernel(const long long* __restrict__ weight,
                           const int* __restrict__ nxt,
                           const int* __restrict__ hd,
                           const long long* __restrict__ idx,
                           int* __restrict__ row_out,
                           long long* __restrict__ rem_out, long long n,
                           unsigned long long* stats) {
  // The tile's heads and offsets; once a run is walked, its first lanes
  // hold its results: a run of one its (row, rem); a longer one (lanes a,
  // a + 1) the row its walk ended at and [walker | entries << 11 | fell
  // back << 30] in s_hd, the weight before its first staged row and where
  // its walk ended in s_off.
  __shared__ int s_hd[CW_TILE];
  __shared__ long long s_off[CW_TILE];
  __shared__ int s_runs[CW_TILE + 1];  // the runs' first lanes, then the end
  __shared__ unsigned s_mask[CW_MASKS];  // a bit a lane: a run starts there
  __shared__ int s_row[CW_BUDGET];
  __shared__ unsigned s_rel[CW_BUDGET];
  __shared__ int s_nruns, s_next, s_nw, s_walker;
  __shared__ int s_count[3];
  const int t = threadIdx.x, lane = t & 31;
  const long long base = (long long)blockIdx.x * CW_TILE;
  const int valid = (int)min((long long)CW_TILE, n - base);
  long long own[CW_ITEMS];  // this thread's offsets (lanes k * CW_WALKERS + t)
#pragma unroll
  for (int k = 0; k < CW_ITEMS; ++k) {
    const int e = k * CW_WALKERS + t;
    own[k] = 0;
    if (e < valid) {
      s_hd[e] = __ldg(hd + base + e);
      own[k] = s_off[e] = __ldg(idx + base + e);
    }
  }
  if (t < 3) s_count[t] = 0;
  if (t == 0) s_next = s_nw = s_walker = 0;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < CW_ITEMS; ++k) {
    const int e = k * CW_WALKERS + t;
    const bool st = e < valid && (e == 0 || s_hd[e] != s_hd[e - 1]);
    const unsigned bits = __ballot_sync(CW_FULL, st);
    if (lane == 0) s_mask[e >> 5] = bits;
  }
  __syncthreads();
  if (t < 32) {  // the runs in lane order, from the bits
    unsigned m = lane < CW_MASKS ? s_mask[lane] : 0u;
    const int c = __popc(m);
    int incl = c;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int o = __shfl_up_sync(CW_FULL, incl, d);
      if (lane >= d) incl += o;
    }
    int j = incl - c;
    while (m) {
      s_runs[j++] = lane * 32 + __ffs(m) - 1;
      m &= m - 1;
    }
    if (lane == 31) {
      s_nruns = incl;
      s_runs[incl] = valid;
    }
  }
  __syncthreads();
  const int nruns = s_nruns;
  {
    int c = 0;
    for (int r = t; r < nruns; r += CW_WALKERS)
      c += s_runs[r + 1] - s_runs[r] >= 2;
    if (c) atomicAdd(&s_nw, c);
  }
  __syncthreads();
  const int nw = s_nw;
  const int share = nw ? CW_BUDGET / nw : 0;
  // The walks, a run at a time from the shared counter.
  for (;;) {
    const int r = atomicAdd(&s_next, 1);
    if (r >= nruns) break;
    const int a = s_runs[r], b = s_runs[r + 1];
    int row = s_hd[a];
    if (b - a == 1) {
      long long rem = s_off[a], used = 0;
      cw_step(weight, nxt, row, rem, used);
      s_hd[a] = row;
      s_off[a] = rem;
      if (stats != nullptr) atomicAdd(&s_count[2], 1);
      continue;
    }
    long long lo = s_off[a], hi = lo;
    for (int j = a + 1; j < b; ++j) {
      const long long v = s_off[j];
      lo = min(lo, v);
      hi = max(hi, v);
    }
    const int w = atomicAdd(&s_walker, 1);
    int cnt = 0;
    long long cum = 0, first = 0;
    bool over = false;
    while (row >= 0) {
      const long long inc = cum + __ldg(weight + row);
      if (inc > lo) {
        if (cnt == 0) first = cum;
        if (cnt == share || inc - first > 0xffffffffLL) {
          over = true;
          break;
        }
        s_row[cnt * nw + w] = row;
        s_rel[cnt * nw + w] = (unsigned)(inc - first);
        ++cnt;
        if (inc > hi) break;
      }
      cum = inc;
      row = BC_LDG_OR(nxt + row, -1);
    }
    s_hd[a] = over ? row : -1;
    s_hd[a + 1] = w | (cnt << 11) | ((int)over << 30);
    s_off[a] = cnt ? first : cum;
    s_off[a + 1] = cum;
    if (stats != nullptr) atomicAdd(&s_count[over ? 1 : 0], 1);
  }
  __syncthreads();
  if (stats != nullptr && t == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      if (s_count[c] && BC_OK(stats + c, 8))
        atomicAdd(stats + c, (unsigned long long)s_count[c]);
  }
  // Every lane: its run's first lane, then its result.
#pragma unroll
  for (int k = 0; k < CW_ITEMS; ++k) {
    const int e = k * CW_WALKERS + t;
    if (e >= valid) continue;
    const int bit = e & 31;
    int word = e >> 5;
    unsigned m = s_mask[word] & (bit == 31 ? CW_FULL : (2u << bit) - 1u);
    while (m == 0) m = s_mask[--word];
    const int a = word * 32 + 31 - __clz(m);
    const bool single = a == e && (e + 1 == valid ||
                                   ((s_mask[(e + 1) >> 5] >> ((e + 1) & 31)) &
                                    1u));
    int row;
    long long rem;
    if (single) {
      row = s_hd[e];
      rem = s_off[e];
    } else {
      const long long i = own[k];
      const int info = s_hd[a + 1];
      const int w = info & 2047, cnt = (info >> 11) & 4095;
      const long long first = s_off[a];
      int lo = 0, hi = cnt;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (first + (long long)s_rel[mid * nw + w] > i)
          hi = mid;
        else
          lo = mid + 1;
      }
      if (lo < cnt) {
        row = s_row[lo * nw + w];
        rem = i - first - (lo > 0 ? (long long)s_rel[(lo - 1) * nw + w] : 0);
      } else {  // past the staged rows: the chain's end, or resume there
        long long used = 0;
        row = s_hd[a];
        rem = i - s_off[a + 1];
        cw_step(weight, nxt, row, rem, used);
      }
    }
    BC_ST(row_out + base + e, row);
    BC_ST(rem_out + base + e, rem);
  }
}

// One launch over n probes: a thread a probe (cached = 0), or tiles of
// CW_TILE probes, CW_WALKERS threads each (cached = 1; stats: null or its
// three counts). Returns a CUDA error code.
extern "C" int csr_walk_launch(const long long* weight, const int* nxt,
                               const int* hd, const long long* idx, int* row,
                               long long* rem, long long n, int cached,
                               unsigned long long* stats, void* stream) {
  if (n == 0) return (int)cudaGetLastError();
  const int per = cached ? CW_TILE : CW_THREADS;
  const long long blocks = (n + per - 1) / per;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  if (cached)
    csr_walk_cached_kernel<<<(unsigned)blocks, CW_WALKERS, 0, s>>>(
        weight, nxt, hd, idx, row, rem, n, stats);
  else
    csr_walk_kernel<<<(unsigned)blocks, CW_THREADS, 0, s>>>(
        weight, nxt, hd, idx, row, rem, n);
  return (int)cudaGetLastError();
}
