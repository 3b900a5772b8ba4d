// Device helpers of the CUDA-core attention kernels (flash_decode.cu,
// flash_prefill.cu): element conversion, float4 arithmetic and the tile
// loader.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ float to_f(float x) { return x; }
// float -> the output type (bf16 rounds to nearest even)
__device__ __forceinline__ float from_f(float x, float*) { return x; }
__device__ __forceinline__ __nv_bfloat16 from_f(float x, __nv_bfloat16*) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = __fmaf_rn(a.x, b.x, acc);
  acc = __fmaf_rn(a.y, b.y, acc);
  acc = __fmaf_rn(a.z, b.z, acc);
  return __fmaf_rn(a.w, b.w, acc);
}
__device__ __forceinline__ float4 axpy4(float p, float4 v, float4 acc) {
  return make_float4(__fmaf_rn(p, v.x, acc.x), __fmaf_rn(p, v.y, acc.y),
                     __fmaf_rn(p, v.z, acc.z), __fmaf_rn(p, v.w, acc.w));
}
__device__ __forceinline__ float4 scale4(float4 v, float a) {
  return make_float4(__fmul_rn(v.x, a), __fmul_rn(v.y, a), __fmul_rn(v.z, a),
                     __fmul_rn(v.w, a));
}

// Rows [r0, r0 + nrows) of a row-major (S, D) matrix of T -> dst[r * stride
// + c] as float, by the whole block: 16-byte loads, float4 stores (stride %
// 4 == 0, D * sizeof(T) % 16 == 0). Rows at or past S become 0.
template <typename T, int D>
__device__ __forceinline__ void load_rows(const T* mat, int r0, int nrows,
                                          int S, float* dst, int stride) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = D / VEC;
  for (int c = threadIdx.x; c < nrows * PER_ROW; c += blockDim.x) {
    const int r = c / PER_ROW, col = (c % PER_ROW) * VEC;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);  // all-zero bits: 0.0 in both types
    if (r0 + r < S)
      raw = reinterpret_cast<const uint4*>(mat + (long long)(r0 + r) * D)[col / VEC];
    const T* vals = reinterpret_cast<const T*>(&raw);
    float* out = dst + r * stride + col;
#pragma unroll
    for (int j = 0; j < VEC; j += 4)
      *reinterpret_cast<float4*>(out + j) =
          make_float4(to_f(vals[j]), to_f(vals[j + 1]), to_f(vals[j + 2]),
                      to_f(vals[j + 3]));
  }
}
