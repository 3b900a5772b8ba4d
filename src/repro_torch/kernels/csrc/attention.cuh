// Device helpers of the CUDA-core attention kernels (flash_decode.cu,
// flash_prefill.cu): the output conversion and float4 arithmetic.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
