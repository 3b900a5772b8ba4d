// The bounds check of a checked build (build.VARIANTS): every global load
// and store of a launch held against the byte ranges of that launch's
// operands and scratch, which the host sets before it (<prefix>_check_set).
// An access outside them is not made (a load reads 0, a store is dropped)
// but counted, and the first BC_CHECK_RECORDS are kept as (address, bytes,
// source line) (<prefix>_check_get). The kernel is otherwise the source's
// own: the same instances, tiles and launch shapes.
//
// A source defines BC_CHECK_BOUNDS under its build's flag before it
// includes this header, which comes before any device code that loads
// with __ldg (tree_get.cuh, tree_walk.cuh), and it names its two entries
// with BC_CHECK_ENTRIES(prefix). Its own accesses go through BC_LD, BC_ST
// and, for an atomic or a PTX access, BC_OK. A load whose 0 could keep a
// loop going (a chain's next link) takes BC_LDG_OR(p, v): outside the
// operands it reads v, a value that ends the loop. Without
// BC_CHECK_BOUNDS they are the plain access and `true`, and
// BC_CHECK_ENTRIES is empty.
//
// Used by scan.cu, bsearch_probe.cu, csr_walk.cu and tree_probe_paged.cu;
// fused_draw.cu, flash_prefill_tc.cu, tree_get.cu, flash_decode.cu and
// flash_prefill.cu keep blocks of their own.
#pragma once

#include <cuda_runtime.h>

#ifdef BC_CHECK_BOUNDS
#define BC_CHECK_RANGES 16
#define BC_CHECK_RECORDS 64
__device__ unsigned long long bc_check_lo[BC_CHECK_RANGES];
__device__ unsigned long long bc_check_hi[BC_CHECK_RANGES];
__device__ int bc_check_n;
__device__ unsigned bc_check_count;
__device__ unsigned long long bc_check_rec[BC_CHECK_RECORDS][3];

__device__ __noinline__ void bc_check_fail(const void* p, int bytes,
                                           int line) {
  const unsigned k = atomicAdd(&bc_check_count, 1u);
  if (k < BC_CHECK_RECORDS) {
    bc_check_rec[k][0] = (unsigned long long)p;
    bc_check_rec[k][1] = (unsigned long long)bytes;
    bc_check_rec[k][2] = (unsigned long long)line;
  }
}

// Whether [p, p + bytes) lies in one range; counted and recorded if not.
__device__ __forceinline__ bool bc_check(const void* p, int bytes, int line) {
  const unsigned long long a = (unsigned long long)p;
  for (int i = 0; i < bc_check_n; ++i)
    if (a >= bc_check_lo[i] && a + bytes <= bc_check_hi[i]) return true;
  bc_check_fail(p, bytes, line);
  return false;
}

template <typename T>
__device__ __forceinline__ T bc_ld(const T* p, int line) {
  return bc_check(p, sizeof(T), line) ? *p : T();
}

template <typename T>
__device__ __forceinline__ T bc_ldg(const T* p, int line) {
  return bc_check(p, sizeof(T), line) ? (__ldg)(p) : T();
}

template <typename T>
__device__ __forceinline__ T bc_ldg_or(const T* p, T v, int line) {
  return bc_check(p, sizeof(T), line) ? (__ldg)(p) : v;
}

template <typename T, typename V>
__device__ __forceinline__ void bc_st(T* p, V v, int line) {
  if (bc_check(p, sizeof(T), line)) *p = v;
}

#define BC_LD(p) bc_ld((p), __LINE__)
#define BC_LDG_OR(p, v) bc_ldg_or((p), (v), __LINE__)
#define BC_ST(p, v) bc_st((p), (v), __LINE__)
#define BC_OK(p, bytes) bc_check((p), (bytes), __LINE__)
#define __ldg(p) bc_ldg((p), __LINE__)

// prefix_check_set: the operands' byte ranges [lo, hi) of the next launch
// and a zero count; prefix_check_get: the last launch's count and its
// records (BC_CHECK_RECORDS x 3 words), after it has finished.
#define BC_CHECK_ENTRIES(prefix)                                             \
  extern "C" int prefix##_check_set(const unsigned long long* lo,           \
                                    const unsigned long long* hi, int n) {  \
    if (n < 0 || n > BC_CHECK_RANGES) return (int)cudaErrorInvalidValue;    \
    const unsigned zero = 0;                                                 \
    cudaError_t e = cudaMemcpyToSymbol(bc_check_lo, lo, 8 * n);             \
    if (e == cudaSuccess) e = cudaMemcpyToSymbol(bc_check_hi, hi, 8 * n);   \
    if (e == cudaSuccess)                                                    \
      e = cudaMemcpyToSymbol(bc_check_n, &n, sizeof(int));                   \
    if (e == cudaSuccess)                                                    \
      e = cudaMemcpyToSymbol(bc_check_count, &zero, sizeof(unsigned));       \
    if (e == cudaSuccess) e = cudaDeviceSynchronize();                       \
    return (int)e;                                                           \
  }                                                                          \
  extern "C" int prefix##_check_get(unsigned* count,                        \
                                    unsigned long long* rec) {               \
    cudaError_t e =                                                          \
        cudaMemcpyFromSymbol(count, bc_check_count, sizeof(unsigned));       \
    if (e == cudaSuccess)                                                    \
      e = cudaMemcpyFromSymbol(rec, bc_check_rec, sizeof(bc_check_rec));     \
    return (int)e;                                                           \
  }
#else
#define BC_LD(p) (*(p))
#define BC_LDG_OR(p, v) __ldg(p)
#define BC_ST(p, v) ((void)(*(p) = (v)))
#define BC_OK(p, bytes) true
#define BC_CHECK_ENTRIES(prefix)
#endif
