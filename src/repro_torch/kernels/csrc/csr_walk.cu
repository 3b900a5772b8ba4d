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
//    repeats and the offset has not fallen below what was consumed. A run
//    of equal heads is therefore independent of every other run: one
//    thread starts at each lane whose head differs from the lane before
//    and walks its run in order with the scan's carry; the threads of the
//    other lanes return at once. Resuming ends where a walk from the head
//    ends, so both modes give the same rows and offsets; the cache changes
//    the steps taken, not the result. A long run (a skewed key) is one
//    thread's sequential loop.
#include <cuda_runtime.h>

#define CW_THREADS 256

__device__ __forceinline__ void cw_step(const long long* __restrict__ weight,
                                        const int* __restrict__ nxt, int& row,
                                        long long& rem, long long& used) {
  while (row >= 0) {
    const long long w = __ldg(weight + row);
    if (rem < w) break;
    rem -= w;
    used += w;
    row = __ldg(nxt + row);
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
  row_out[i] = row;
  rem_out[i] = rem;
}

__global__ void __launch_bounds__(CW_THREADS)
    csr_walk_cached_kernel(const long long* __restrict__ weight,
                           const int* __restrict__ nxt,
                           const int* __restrict__ hd,
                           const long long* __restrict__ idx,
                           int* __restrict__ row_out,
                           long long* __restrict__ rem_out, long long n) {
  const long long start = (long long)blockIdx.x * CW_THREADS + threadIdx.x;
  if (start >= n) return;
  const int h = __ldg(hd + start);
  if (start > 0 && __ldg(hd + start - 1) == h) return;  // not a run start
  // The scan's carry within the run: the row the last probe stopped at and
  // the weight consumed before it (none yet at the run's first probe).
  int prev_row = h;
  long long consumed = 0;
  bool carried = false;
  for (long long j = start; j < n; ++j) {
    if (j > start && __ldg(hd + j) != h) break;
    const long long i = __ldg(idx + j);
    const bool same = carried && i >= consumed;
    int row = same ? prev_row : h;
    long long used = same ? consumed : 0;
    long long rem = i - used;
    cw_step(weight, nxt, row, rem, used);
    row_out[j] = row;
    rem_out[j] = rem;
    prev_row = row;
    consumed = used;
    carried = true;
  }
}

// One launch over n probes: a thread a probe (cached = 0) or a thread a
// lane of which only the runs' first lanes walk (cached = 1). Returns a
// CUDA error code.
extern "C" int csr_walk_launch(const long long* weight, const int* nxt,
                               const int* hd, const long long* idx, int* row,
                               long long* rem, long long n, int cached,
                               void* stream) {
  if (n == 0) return (int)cudaGetLastError();
  const long long blocks = (n + CW_THREADS - 1) / CW_THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  if (cached)
    csr_walk_cached_kernel<<<(unsigned)blocks, CW_THREADS, 0, s>>>(
        weight, nxt, hd, idx, row, rem, n);
  else
    csr_walk_kernel<<<(unsigned)blocks, CW_THREADS, 0, s>>>(
        weight, nxt, hd, idx, row, rem, n);
  return (int)cudaGetLastError();
}
