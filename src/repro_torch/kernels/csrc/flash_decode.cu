// One-token decode attention over a KV cache, with GQA and an additive bias.
//
// Replaces flash_decode of src/repro/kernels/flash_decode.py: for each batch
// row b and query head h, softmax(q . K^T / sqrt(D) + bias[b]) . V over the
// cache of KV head h / G (G = H / KV_H), in float32, out in q's dtype.
//
// Bound on the card: bytes. Every K and V element is read once; the
// arithmetic is 4 * B * H * S * D operations, far below the byte time.
// What the design does about it:
//   * one block per (S-split, KV head, batch row) handles all G query heads
//     of its group, so each K/V tile is read once per group (the TPU grid
//     (B, H, S / block_s) reads it G times);
//   * the cache is cut into splits of FD_SPLIT keys, so small batches still
//     give enough blocks to fill the SMs (flash-decoding); a second kernel
//     combines the splits' (m, l, acc) partials;
//   * tiles of FD_TK keys load as 16-byte vectors, coalesced, into shared
//     memory as float32;
//   * the arithmetic reads shared memory as float4, and each loaded K or V
//     vector feeds two heads: a first version with scalar reads and one
//     FMA per pair of reads was bound by shared-memory load instructions,
//     not by bytes.
// The loads are not overlapped with the arithmetic (no cp.async / TMA ring),
// and the dot products run on the CUDA cores: later work.
//
// Online softmax as the reference: m starts at -1e30 (not -inf), so a row
// whose every key carries the -1e30 mask averages V as the reference does
// and is not NaN. Keys past S (the cache's ragged end) are left out, not
// masked: no padding is needed.
#include <math_constants.h>

#include "attention.cuh"

#define FD_THREADS 256
#define FD_TK 32         // keys per tile: one warp lane per key
#define FD_SPLIT 1024    // keys per block (S-split)
#define FD_SLOTS 4       // float4 accumulators a thread owns: G * D <= 4096
#define FD_NEG (-1e30f)  // the reference's initial running max

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o /= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o /= 2) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Grid (nsplit, KV_H, B). Partials: acc (B, H, nsplit, D); m, l (B, H, nsplit).
template <typename T, int D>
__global__ void __launch_bounds__(FD_THREADS) flash_decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, float* __restrict__ acc_part,
    float* __restrict__ m_part, float* __restrict__ l_part, int H, int KVH,
    int S, float scale) {
  constexpr int KS = D + 4;               // k_s row stride: float4-aligned,
                                          // and lanes' rows on distinct banks
  constexpr int PS = FD_TK + 1;           // p_s row stride
  constexpr int D4 = D / 4;               // float4 columns of a row
  constexpr int GSTEP = FD_THREADS / D4;  // heads between a thread's slots
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int G = H / KVH;
  float* q_s = smem;                  // [G][D]
  float* k_s = q_s + G * D;           // [FD_TK][KS]
  float* v_s = k_s + FD_TK * KS;      // [FD_TK][D]
  float* p_s = v_s + FD_TK * D;       // [G][PS]
  float* m_s = p_s + G * PS;          // [G]
  float* l_s = m_s + G;               // [G]
  float* a_s = l_s + G;               // [G]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long head0 = (long long)b * H + (long long)kvh * G;

  load_rows<T, D>(q + head0 * D, 0, G, G, q_s, D);
  for (int g = tid; g < G; g += FD_THREADS) {
    m_s[g] = FD_NEG;
    l_s[g] = 0.0f;
  }
  // Slot i of this thread: head g_first + i * GSTEP, columns [dcol, dcol + 4).
  const int dcol = (tid % D4) * 4, g_first = tid / D4;
  float4 acc[FD_SLOTS];
#pragma unroll
  for (int i = 0; i < FD_SLOTS; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  const long long kv_base = ((long long)b * KVH + kvh) * S;
  const int s_begin = split * FD_SPLIT;
  const int s_end = min(S, s_begin + FD_SPLIT);
  for (int k0 = s_begin; k0 < s_end; k0 += FD_TK) {
    const int nr = min(FD_TK, s_end - k0);
    __syncthreads();  // the previous tile is consumed; q_s, m_s are set
    load_rows<T, D>(k + kv_base * D, k0, nr, S, k_s, KS);
    load_rows<T, D>(v + kv_base * D, k0, nr, S, v_s, D);
    __syncthreads();
    // logits: a lane per key; a warp takes heads g0 and g0 + 8 together
    for (int g0 = warp; g0 < G; g0 += 16) {
      const int g1 = min(g0 + 8, G - 1);
      const float* kr = k_s + lane * KS;
      float da = 0.0f, db = 0.0f;
#pragma unroll 8
      for (int d = 0; d < D; d += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(kr + d);
        da = dot4(*reinterpret_cast<const float4*>(q_s + g0 * D + d), k4, da);
        db = dot4(*reinterpret_cast<const float4*>(q_s + g1 * D + d), k4, db);
      }
      float sa = -CUDART_INF_F, sb = -CUDART_INF_F;
      if (lane < nr) {
        const float bv = bias[(long long)b * S + k0 + lane];
        sa = __fadd_rn(__fmul_rn(da, scale), bv);
        sb = __fadd_rn(__fmul_rn(db, scale), bv);
      }
      p_s[g0 * PS + lane] = sa;
      if (g0 + 8 < G) p_s[g1 * PS + lane] = sb;
    }
    __syncthreads();
    // online softmax: one warp per head, one lane per key
    for (int g = warp; g < G; g += FD_THREADS / 32) {
      const float s = p_s[g * PS + lane];
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float pr = expf(s - m_new);
      const float sum = warp_sum(pr);
      p_s[g * PS + lane] = pr;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = __fadd_rn(__fmul_rn(l_s[g], alpha), sum);
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // acc[g][dcol..] = acc * alpha[g] + sum_k p[g][k] * v[k][dcol..]
#pragma unroll
    for (int i = 0; i < FD_SLOTS; ++i) {
      const int g = g_first + i * GSTEP;
      if (g < G) acc[i] = scale4(acc[i], a_s[g]);
    }
    for (int kk = 0; kk < nr; ++kk) {
      const float4 v4 = *reinterpret_cast<const float4*>(v_s + kk * D + dcol);
#pragma unroll
      for (int i = 0; i < FD_SLOTS; ++i) {
        const int g = g_first + i * GSTEP;
        if (g < G) acc[i] = axpy4(p_s[g * PS + kk], v4, acc[i]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < FD_SLOTS; ++i) {
    const int g = g_first + i * GSTEP;
    if (g < G)
      *reinterpret_cast<float4*>(
          acc_part + ((head0 + g) * nsplit + split) * D + dcol) = acc[i];
  }
  for (int g = tid; g < G; g += FD_THREADS) {
    m_part[(head0 + g) * nsplit + split] = m_s[g];
    l_part[(head0 + g) * nsplit + split] = l_s[g];
  }
}

// Grid (H, B), D threads: out = sum_s e_s acc_s / max(sum_s e_s l_s, 1e-30)
// with e_s = exp(m_s - max_s m_s).
template <typename T>
__global__ void flash_decode_combine_kernel(const float* __restrict__ acc_part,
                                            const float* __restrict__ m_part,
                                            const float* __restrict__ l_part,
                                            T* __restrict__ out, int H,
                                            int nsplit, int D) {
  const long long head = (long long)blockIdx.y * H + blockIdx.x;
  const int d = threadIdx.x;
  const float* m = m_part + head * nsplit;
  const float* l = l_part + head * nsplit;
  float mx = FD_NEG;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, m[s]);
  float num = 0.0f, den = 0.0f;
  for (int s = 0; s < nsplit; ++s) {
    const float e = expf(m[s] - mx);
    num = __fmaf_rn(e, acc_part[(head * nsplit + s) * D + d], num);
    den = __fmaf_rn(e, l[s], den);
  }
  out[head * D + d] = from_f(__fdiv_rn(num, fmaxf(den, 1e-30f)), (T*)nullptr);
}

template <typename T, int D>
static int fd_launch(const T* q, const T* k, const T* v, const float* bias,
                     T* out, float* acc_part, float* m_part, float* l_part,
                     int B, int H, int KVH, int S, float scale, void* stream) {
  const int G = H / KVH;
  const int nsplit = (S + FD_SPLIT - 1) / FD_SPLIT;
  const size_t smem = sizeof(float) * ((size_t)G * D + FD_TK * (D + 4) +
                                       FD_TK * D + G * (FD_TK + 1) + 3 * G);
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_split_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  flash_decode_split_kernel<T, D><<<dim3(nsplit, KVH, B), FD_THREADS, smem, s>>>(
      q, k, v, bias, acc_part, m_part, l_part, H, KVH, S, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_decode_combine_kernel<T><<<dim3(H, B), D, 0, s>>>(
      acc_part, m_part, l_part, out, H, nsplit, D);
  return (int)cudaGetLastError();
}

template <typename T>
static int fd_dispatch(const void* q, const void* k, const void* v,
                       const float* bias, void* out, float* acc_part,
                       float* m_part, float* l_part, int B, int H, int KVH,
                       int S, int D, float scale, void* stream) {
  const T *qt = (const T*)q, *kt = (const T*)k, *vt = (const T*)v;
  T* ot = (T*)out;
  switch (D) {
    case 64:
      return fd_launch<T, 64>(qt, kt, vt, bias, ot, acc_part, m_part, l_part,
                              B, H, KVH, S, scale, stream);
    case 128:
      return fd_launch<T, 128>(qt, kt, vt, bias, ot, acc_part, m_part, l_part,
                               B, H, KVH, S, scale, stream);
    case 256:
      return fd_launch<T, 256>(qt, kt, vt, bias, ot, acc_part, m_part, l_part,
                               B, H, KVH, S, scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 float32, 1 bfloat16. The wrapper checks the shapes: H % KVH == 0,
// D in {64, 128, 256}, (H / KVH) * D <= 4 * FD_THREADS * FD_SLOTS, S >= 1.
// Partials (16-byte aligned): acc B * H * nsplit * D floats, then m and l
// B * H * nsplit floats each.
extern "C" int flash_decode_launch(int dtype, const void* q, const void* k,
                                   const void* v, const float* bias, void* out,
                                   float* acc_part, float* m_part,
                                   float* l_part, int B, int H, int KVH,
                                   int S, int D, float scale, void* stream) {
  if (dtype == 0)
    return fd_dispatch<float>(q, k, v, bias, out, acc_part, m_part, l_part, B,
                              H, KVH, S, D, scale, stream);
  return fd_dispatch<__nv_bfloat16>(q, k, v, bias, out, acc_part, m_part,
                                    l_part, B, H, KVH, S, D, scale, stream);
}
