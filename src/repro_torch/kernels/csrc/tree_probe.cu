// Fused USR GET over the packed int32 index arena.
//
// Replaces tree_probe of src/repro/kernels/tree_probe.py (its _kernel and
// tree_walk). One thread per probe lane walks the whole tree (tree_walk.cuh)
// and writes one row per slot, slot-major: out[s * n + i]. Bound on the
// card: a lane makes about log2(n_root) + sum over edges of (3 +
// log2(n_child)) dependent arena loads, so the kernel is bound by load
// latency over a table far larger than L2 (the JOB-scale arena is hundreds
// of MB). The design keeps the arena in device memory with read-only loads
// and launches enough blocks to keep the SMs' load queues full; probes that
// arrive sorted (full join, sampled positions) share their upper search
// levels in cache.
#include <cuda_runtime.h>

#include "tree_walk.cuh"

__global__ void tree_probe_kernel(const int* __restrict__ arena,
                                  const __grid_constant__ RtLayout L,
                                  const int* __restrict__ q,
                                  int* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int slots = L.num_edges + 1;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int rows[RT_MAX_SLOTS];
    rt_tree_walk(arena, L, q[i], rows);
    for (int s = 0; s < slots; ++s) out[(long long)s * n + i] = rows[s];
  }
}

extern "C" int tree_probe_launch(const int* arena, const int* table,
                                 const int* q, int* out, long long n,
                                 void* stream) {
  const RtLayout L = rt_layout_from_table(table);
  if (n == 0) return (int)cudaGetLastError();
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  tree_probe_kernel<<<(int)blocks, threads, 0, (cudaStream_t)stream>>>(
      arena, L, q, out, n);
  return (int)cudaGetLastError();
}
