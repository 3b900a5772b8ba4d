// Causal or full flash attention over whole sequences, with GQA.
//
// Replaces flash_prefill of src/repro/kernels/flash_prefill.py for float32
// operands: for each (b, h) and query row i, softmax(q_i . K^T / sqrt(D),
// masked to keys j <= i when causal) . V over KV head h / G (G = H / KV),
// float32 arithmetic. bf16 operands take flash_prefill_tc.cu.
//
// Bound on the card: operations, 4 * B * H * S^2 * D (half of it when
// causal). This kernel runs on the CUDA cores in float32 (67 TFLOP/s), as
// the reference computes both products in float32: the tensor cores' TF32
// keeps ~3 decimal digits, too few for the float32 tolerances.
// What the design does:
//   * one block of FP_THREADS per (query tile of FP_BQ rows, head, batch
//     row); K and V stream through shared memory in tiles of BK keys with an
//     online softmax (m, l in shared memory, the output tile in registers),
//     so no S x S score matrix exists anywhere;
//   * a thread owns 4 query rows x BK/16 keys of each score tile and 4 rows
//     x D/16 columns of the output, and reads shared memory as float4: each
//     load feeds 4 to 16 FMAs (a first version with scalar reads was bound
//     by shared-memory load instructions);
//   * causal: key tiles wholly above the diagonal are skipped. Once the
//     first tile (which holds key 0, visible to every row) has set m, such a
//     tile would add exp(-1e30 - m) = 0 to every sum, so the result is the
//     same; keys above the diagonal inside a tile get the reference's -1e30;
//   * keys past S (a ragged last tile) are left out, causal or not: a padded
//     key never joins the softmax. Query rows past S are not written.
// D = 256 needs more than 48 KB of shared memory: the launch raises the
// limit with cudaFuncSetAttribute.
#include <math_constants.h>

#include "attention.cuh"

#define FP_THREADS 256
#define FP_BQ 64         // query rows per block: 16 thread rows x 4
#define FP_NEG (-1e30f)  // the reference's mask value and initial max

template <int D>
struct FpShape {
  static constexpr int BK = D >= 128 ? 32 : 64;  // keys per tile
  static constexpr int KPT = BK / 16;            // score columns a thread owns
  static constexpr int DPT = D / 64;             // output float4s a thread owns
  // q_s and k_s rows: float4-aligned, and the 8 lanes of a float4 phase on
  // distinct banks
  static constexpr int KS = D + 4;
  static constexpr int SMEM_FLOATS = FP_BQ * KS + BK * KS + BK * D +
                                     FP_BQ * (BK + 1) + 3 * FP_BQ;
};

// Grid (ceil(S / FP_BQ), H, B).
template <typename T, int D>
__global__ void __launch_bounds__(FP_THREADS) flash_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int H, int KV, int S, int causal, float scale) {
  using Sh = FpShape<D>;
  constexpr int BK = Sh::BK, KPT = Sh::KPT, DPT = Sh::DPT, KS = Sh::KS;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* q_s = smem;                       // [FP_BQ][KS]
  float* k_s = q_s + FP_BQ * KS;           // [BK][KS]
  float* v_s = k_s + BK * KS;              // [BK][D]
  float* s_s = v_s + BK * D;               // [FP_BQ][BK + 1]
  float* m_s = s_s + FP_BQ * (BK + 1);     // [FP_BQ]
  float* l_s = m_s + FP_BQ;                // [FP_BQ]
  float* a_s = l_s + FP_BQ;                // [FP_BQ]

  const int q0 = blockIdx.x * FP_BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int lane = tid % 32, warp = tid / 32;
  const T* qm = q + ((long long)b * H + h) * S * D;
  const T* km = k + ((long long)b * KV + kvh) * S * D;
  const T* vm = v + ((long long)b * KV + kvh) * S * D;

  load_rows<T, D>(qm, q0, FP_BQ, S, q_s, KS);
  for (int r = tid; r < FP_BQ; r += FP_THREADS) {
    m_s[r] = FP_NEG;
    l_s[r] = 0.0f;
  }
  // rows ty*4 + i, float4 columns 4 tx + 64 j
  float4 acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int k_end = causal ? min(S, q0 + FP_BQ) : S;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    load_rows<T, D>(km, k0, BK, S, k_s, KS);
    load_rows<T, D>(vm, k0, BK, S, v_s, D);
    __syncthreads();
    // scores of rows ty*4 + i, keys tx + 16 j
    float sc[4][KPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[KPT];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_s + (ty * 4 + i) * KS + d);
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        kv[j] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * j) * KS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) sc[i][j] = dot4(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int kk = tx + 16 * j, kpos = k0 + kk;
        float s = __fmul_rn(sc[i][j], scale);
        if (kpos >= S) s = -CUDART_INF_F;
        else if (causal && kpos > q0 + r) s = FP_NEG;
        s_s[r * (BK + 1) + kk] = s;
      }
    }
    __syncthreads();
    // online softmax: a warp per row, BK / 32 keys a lane
    for (int r = warp; r < FP_BQ; r += FP_THREADS / 32) {
      float s[BK / 32];
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < BK / 32; ++c) {
        s[c] = s_s[r * (BK + 1) + lane + 32 * c];
        mx = fmaxf(mx, s[c]);
      }
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < BK / 32; ++c) {
        const float p = expf(s[c] - m_new);
        s_s[r * (BK + 1) + lane + 32 * c] = p;
        sum = __fadd_rn(sum, p);
      }
      for (int off = 16; off > 0; off /= 2)
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = __fadd_rn(__fmul_rn(l_s[r], alpha), sum);
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * alpha + P . V for rows ty*4 + i, float4 columns 4 tx + 64 j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] = scale4(acc[i][j], alpha);
    }
    const int nk = min(BK, S - k0);
    for (int kk = 0; kk < nk; ++kk) {
      float p[4];
      float4 vv[DPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = s_s[(ty * 4 + i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < DPT; ++j)
        vv[j] = *reinterpret_cast<const float4*>(v_s + kk * D + 4 * tx + 64 * j);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = axpy4(p[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();
  T* om = out + ((long long)b * H + h) * S * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= S) continue;
    const float den = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      T* o = om + (long long)(q0 + r) * D + 4 * tx + 64 * j;
      o[0] = from_f(__fdiv_rn(acc[i][j].x, den), (T*)nullptr);
      o[1] = from_f(__fdiv_rn(acc[i][j].y, den), (T*)nullptr);
      o[2] = from_f(__fdiv_rn(acc[i][j].z, den), (T*)nullptr);
      o[3] = from_f(__fdiv_rn(acc[i][j].w, den), (T*)nullptr);
    }
  }
}

template <typename T, int D>
static int fp_launch(const T* q, const T* k, const T* v, T* out, int B, int H,
                     int KV, int S, int causal, float scale, void* stream) {
  const size_t smem = sizeof(float) * FpShape<D>::SMEM_FLOATS;
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + FP_BQ - 1) / FP_BQ, H, B);
  flash_prefill_kernel<T, D><<<grid, FP_THREADS, smem, (cudaStream_t)stream>>>(
      q, k, v, out, H, KV, S, causal, scale);
  return (int)cudaGetLastError();
}

// float32 q (B, H, S, D), k / v (B, KV, S, D); D in {64, 128, 256};
// H % KV == 0; S >= 1.
extern "C" int flash_prefill_launch(const float* q, const float* k,
                                    const float* v, float* out, int B, int H,
                                    int KV, int S, int D, int causal,
                                    float scale, void* stream) {
  switch (D) {
    case 64:
      return fp_launch<float, 64>(q, k, v, out, B, H, KV, S, causal, scale,
                                  stream);
    case 128:
      return fp_launch<float, 128>(q, k, v, out, B, H, KV, S, causal, scale,
                                   stream);
    case 256:
      return fp_launch<float, 256>(q, k, v, out, B, H, KV, S, causal, scale,
                                   stream);
  }
  return (int)cudaErrorInvalidValue;
}
