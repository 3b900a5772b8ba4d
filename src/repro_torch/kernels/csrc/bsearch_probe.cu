// Bulk binary search of int32 probes into a sorted int32 prefix vector.
//
// Replaces bsearch_probe of src/repro/kernels/bsearch_probe.py: for each
// query q, the largest j with pref[j] <= q (pref[0] == 0 <= q). One thread
// per query runs the same branchless power-of-two descent. Bound on the
// card: each query makes ceil(log2 NP) dependent loads, so it is bound by
// load latency; the table stays in device memory and its upper levels, which
// every query touches, in L2 and L1 through read-only loads. A grid-stride
// loop over enough blocks to fill the SMs keeps many loads in flight.
#include <cuda_runtime.h>

#include "tree_walk.cuh"

__global__ void bsearch_probe_kernel(const int* __restrict__ pref, int np_len,
                                     int steps, const int* __restrict__ q,
                                     int* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = rt_descend(pref, 0, np_len, steps, q[i]);
}

extern "C" int bsearch_probe_launch(const int* pref, int np_len, int steps,
                                    const int* q, int* out, long long n,
                                    void* stream) {
  if (n == 0) return (int)cudaGetLastError();
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  bsearch_probe_kernel<<<(int)blocks, threads, 0, (cudaStream_t)stream>>>(
      pref, np_len, steps, q, out, n);
  return (int)cudaGetLastError();
}
