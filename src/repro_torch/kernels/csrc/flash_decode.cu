// One-token decode attention over a KV cache, with GQA and an additive bias.
//
// Replaces flash_decode of src/repro/kernels/flash_decode.py: for each batch
// row b and query head h, softmax(q . K^T / sqrt(D) + bias[b]) . V over the
// cache of KV head h / G (G = H / KV_H), out in q's dtype. Two kernels
// compute the splits, one per dtype, and one combine kernel merges them:
//   * bf16: flash_decode_tc_kernel, both products on the tensor cores;
//   * float32: flash_decode_split_kernel on the CUDA cores, as the
//     reference computes in float32 and the tensor cores' TF32 keeps ~3
//     decimal digits, too few for the float32 tolerances.
//
// Bound on the card: bytes. Every K and V element is read once; the
// arithmetic is 4 * B * H * S * D operations, 4 G of them a K/V element
// pair (16 operations a byte at G = 16), below the byte time on the tensor
// cores. What the designs do about it:
//   * one block per (S-split, KV head, batch row) handles all G query heads
//     of its group, so each K/V tile is read once per group (the TPU grid
//     (B, H, S / block_s) reads it G times);
//   * the wrapper chooses the number of splits (flash_decode.py
//     decode_splits) so that small batches still give enough blocks to fill
//     the SMs (flash-decoding); split i covers keys [i S / n, (i + 1) S / n),
//     and the combine kernel merges the splits' (m, l, acc) partials;
//   * bf16: K, V and the bias slice stream through a ring of FDT_STAGES
//     stages of FDT_TK keys filled by 16-byte cp.async, so two tiles are in
//     flight while one is computed (64 KB a block at D = 128, two blocks an
//     SM); the tiles stay bf16 in shared memory, rows swizzled so ldmatrix
//     reads them without bank conflicts. The G heads are the 16 rows of
//     mma.sync m16n8k16 (padded); each warp takes 16 keys of a tile with its
//     own online softmax, and the four warps merge in shared memory at the
//     end. P goes to the P . V product as hi + lo, two bf16 fragments, so it
//     carries p to ~2^-16 (the bytes bound leaves the tensor cores idle);
//   * float32: tiles of FD_TK keys load synchronously into shared memory;
//     the arithmetic reads it as float4, each loaded K or V vector feeding
//     two heads (scalar reads made a first version bound by shared-memory
//     load instructions, not by bytes).
//
// Online softmax as the reference: m starts at -1e30 (not -inf), so a row
// whose every key carries the -1e30 mask averages V as the reference does
// and is not NaN. Keys past S (the cache's ragged end) are left out, not
// masked: no padding is needed. The bf16 kernel runs the softmax in base 2
// (logits times log2 e, the same -1e30 in base 2).
#include <math_constants.h>

#include "attention.cuh"
#include "tensor_core.cuh"

#define FD_THREADS 256
#define FD_TK 32         // keys per tile: one warp lane per key
#define FD_SLOTS 4       // float4 accumulators a thread owns: G * D <= 4096
#define FD_NEG (-1e30f)  // the reference's initial running max
#define FD_LN2 0.6931471805599453f

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
  const int s_begin = (int)((long long)split * S / nsplit);
  const int s_end = (int)((long long)(split + 1) * S / nsplit);
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
// with e_s = exp(m_s - max_s m_s). The max starts at -inf: a split whose
// every key is masked has m_s = -1e30 (the bf16 kernel's within rounding of
// its base-2 value) and must weigh 1 against another such split.
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
  float mx = -CUDART_INF_F;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, m[s]);
  float num = 0.0f, den = 0.0f;
  for (int s = 0; s < nsplit; ++s) {
    const float e = expf(m[s] - mx);
    num = __fmaf_rn(e, acc_part[(head * nsplit + s) * D + d], num);
    den = __fmaf_rn(e, l[s], den);
  }
  out[head * D + d] = from_f(__fdiv_rn(num, fmaxf(den, 1e-30f)), (T*)nullptr);
}


// -- bf16: the tensor-core split kernel ---------------------------------------

#define FDT_THREADS 128  // four warps: 16 keys of every tile each
#define FDT_TK 64        // keys per ring stage
#define FDT_STAGES 3     // ring depth: two stages in flight while one computes
#define FDT_M 16         // mma rows: the group's G <= 16 query heads, padded

template <int D>
struct FdtShape {
  static constexpr int CH = D / 8;          // 16-byte chunks of a row
  static constexpr int TILE = FDT_TK * CH;  // chunks of a K (or V) tile
  static constexpr int STAGE_BYTES = 2 * TILE * 16 + FDT_TK * 4;
  static constexpr int SMEM = FDT_M * CH * 16 + FDT_STAGES * STAGE_BYTES;
  // the warps' partials at the end, in the ring: [4][16][D + 2] floats
  static_assert(4 * 16 * (D + 2) * 4 <= FDT_STAGES * STAGE_BYTES, "ring");
};

// Chunk c of row r of a tile with CH chunks a row, swizzled: the same chunk
// of 8 consecutive rows lies on 8 distinct 16-byte bank groups.
__device__ __forceinline__ int swz(int r, int c, int CH) {
  return r * CH + (c ^ (r & 7));
}

// Grid (nsplit, KV_H, B), FDT_THREADS threads. Partials as the float32
// kernel's, with m in natural-log units.
template <int D>
__global__ void __launch_bounds__(FDT_THREADS) flash_decode_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
    float* __restrict__ acc_part, float* __restrict__ m_part,
    float* __restrict__ l_part, int H, int KVH, int S, float scale) {
  using Sh = FdtShape<D>;
  constexpr int CH = Sh::CH;
  extern __shared__ uint4 smem_u4[];
  uint4* q_s = smem_u4;  // [16][CH], swizzled
  unsigned char* ring = reinterpret_cast<unsigned char*>(q_s + FDT_M * CH);
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x, G = H / KVH;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long head0 = (long long)b * H + (long long)kvh * G;
  const int s_begin = (int)((long long)split * S / nsplit);
  const int s_end = (int)((long long)(split + 1) * S / nsplit);
  const int ntiles = (s_end - s_begin + FDT_TK - 1) / FDT_TK;
  const long long kv0 = ((long long)b * KVH + kvh) * S;
  const __nv_bfloat16* kg = k + kv0 * D;
  const __nv_bfloat16* vg = v + kv0 * D;
  const float* bg = bias + (long long)b * S;
  const float neg = __fmul_rn(FD_NEG, TC_LOG2E);  // -1e30 in base 2

  // Q rows past G are zero (their results are dropped)
  for (int c = tid; c < FDT_M * CH; c += FDT_THREADS) {
    const int r = c / CH, ch = c % CH;
    cp_async16(q_s + swz(r, ch, CH), q + (head0 + min(r, G - 1)) * D + ch * 8,
               r < G ? 16 : 0);
  }
  // Tile t into stage t % FDT_STAGES: K, V and the bias slice; keys past
  // the split are zero-filled (and get -inf below)
  auto load = [&](int t) {
    uint4* ks = reinterpret_cast<uint4*>(ring + (t % FDT_STAGES) * Sh::STAGE_BYTES);
    uint4* vs = ks + Sh::TILE;
    float* bs = reinterpret_cast<float*>(vs + Sh::TILE);
    const int k0 = s_begin + t * FDT_TK;
    for (int c = tid; c < Sh::TILE; c += FDT_THREADS) {
      const int r = c / CH, ch = c % CH, key = k0 + r;
      const bool ok = key < s_end;
      const long long off = (long long)(ok ? key : s_begin) * D + ch * 8;
      cp_async16(ks + swz(r, ch, CH), kg + off, ok ? 16 : 0);
      cp_async16(vs + swz(r, ch, CH), vg + off, ok ? 16 : 0);
    }
    if (tid < FDT_TK) {
      const int key = k0 + tid;
      const bool ok = key < s_end;
      cp_async4(bs + tid, bg + (ok ? key : s_begin), ok ? 4 : 0);
    }
  };
#pragma unroll
  for (int t = 0; t < FDT_STAGES - 1; ++t) {
    if (t < ntiles) load(t);
    cp_async_commit();
  }

  // This thread's rows (heads) lane / 4 and lane / 4 + 8 of the fragment.
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
  float m[2] = {neg, neg}, l[2] = {0.0f, 0.0f};
  const int kw = 16 * warp;  // this warp's keys in every tile

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<FDT_STAGES - 2>();
    __syncthreads();  // tile t is in; tile t - 1's stage is free
    if (t + FDT_STAGES - 1 < ntiles) load(t + FDT_STAGES - 1);
    cp_async_commit();
    const uint4* ks =
        reinterpret_cast<const uint4*>(ring + (t % FDT_STAGES) * Sh::STAGE_BYTES);
    const uint4* vs = ks + Sh::TILE;
    const float* bs = reinterpret_cast<const float*>(vs + Sh::TILE);
    const int k0 = s_begin + t * FDT_TK;

    // scores (16 heads x 16 keys) = Q . K^T
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], bk[4];
      ldmatrix_x4(a, q_s + swz(lane % 8 + ((lane / 8) % 2) * 8,
                               2 * kk + lane / 16, CH));
      ldmatrix_x4(bk, ks + swz(kw + lane % 8 + (lane / 16) * 8,
                               2 * kk + (lane / 8) % 2, CH));
      mma_bf16_16816(sc[0], a, bk[0], bk[1]);
      mma_bf16_16816(sc[1], a, bk[2], bk[3]);
    }
    // logits in base 2, (dot * scale + bias) * log2 e, as the reference
    // orders them; keys past the split -inf. Element (nb, i): head lane / 4
    // + 8 (i / 2), key kw + 8 nb + 2 (lane % 4) + i % 2.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kt = kw + 8 * nb + 2 * (lane % 4) + (i & 1);
        float x = -CUDART_INF_F;
        if (k0 + kt < s_end)
          x = __fmul_rn(__fadd_rn(__fmul_rn(sc[nb][i], scale), bs[kt]),
                        TC_LOG2E);
        sc[nb][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = ex2(__fsub_rn(m[r], mx[r]));
      m[r] = mx[r];
      l[r] = __fmul_rn(l[r], alpha[r]);  // this thread's share of the sum
    }
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sc[nb][i] = ex2(__fsub_rn(sc[nb][i], m[i >> 1]));
        l[i >> 1] = __fadd_rn(l[i >> 1], sc[nb][i]);
      }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] = __fmul_rn(acc[j][0], alpha[0]);
      acc[j][1] = __fmul_rn(acc[j][1], alpha[0]);
      acc[j][2] = __fmul_rn(acc[j][2], alpha[1]);
      acc[j][3] = __fmul_rn(acc[j][3], alpha[1]);
    }
    // P (16 x 16 keys) as the A fragment, hi + lo
    uint32_t phi[4], plo[4];
    split_bf16(sc[0][0], sc[0][1], phi[0], plo[0]);
    split_bf16(sc[0][2], sc[0][3], phi[1], plo[1]);
    split_bf16(sc[1][0], sc[1][1], phi[2], plo[2]);
    split_bf16(sc[1][2], sc[1][3], phi[3], plo[3]);
    // acc += P . V, V through ldmatrix.trans: two 8-column blocks a load
#pragma unroll
    for (int j = 0; j < D / 8; j += 2) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, vs + swz(kw + lane % 8 + ((lane / 8) % 2) * 8,
                                     j + lane / 16, CH));
      mma_bf16_16816(acc[j], phi, bv[0], bv[1]);
      mma_bf16_16816(acc[j], plo, bv[0], bv[1]);
      mma_bf16_16816(acc[j + 1], phi, bv[2], bv[3]);
      mma_bf16_16816(acc[j + 1], plo, bv[2], bv[3]);
    }
  }

  // Merge the four warps' (m, l, acc) in shared memory, then write the
  // split's partial.
  cp_async_wait<0>();
  __syncthreads();  // the ring is free
  float* red = reinterpret_cast<float*>(ring);  // [4][16][D + 2]
  const int r0 = lane / 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 1));
    l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 2));
    float* row = red + (warp * 16 + r0 + 8 * r) * (D + 2);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      row[8 * j + 2 * (lane % 4)] = acc[j][2 * r];
      row[8 * j + 2 * (lane % 4) + 1] = acc[j][2 * r + 1];
    }
    if (lane % 4 == 0) {
      row[D] = m[r];
      row[D + 1] = l[r];
    }
  }
  __syncthreads();
  for (int e = tid; e < G * D; e += FDT_THREADS) {
    const int g = e / D, d = e % D;
    float mw[4], mx = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      mw[w] = red[(w * 16 + g) * (D + 2) + D];
      mx = fmaxf(mx, mw[w]);
    }
    float num = 0.0f, den = 0.0f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float* row = red + (w * 16 + g) * (D + 2);
      const float f = ex2(__fsub_rn(mw[w], mx));
      num = __fadd_rn(num, __fmul_rn(f, row[d]));
      den = __fadd_rn(den, __fmul_rn(f, row[D + 1]));
    }
    const long long slot = (head0 + g) * nsplit + split;
    acc_part[slot * D + d] = num;
    if (d == 0) {
      m_part[slot] = __fmul_rn(mx, FD_LN2);
      l_part[slot] = den;
    }
  }
}

// -- launchers ------------------------------------------------------------------

template <int D>
static int fd_launch(const float* q, const float* k, const float* v,
                     const float* bias, float* out, float* acc_part,
                     float* m_part, float* l_part, int B, int H, int KVH,
                     int S, int nsplit, float scale, cudaStream_t s) {
  const int G = H / KVH;
  const size_t smem = sizeof(float) * ((size_t)G * D + FD_TK * (D + 4) +
                                       FD_TK * D + G * (FD_TK + 1) + 3 * G);
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_split_kernel<float, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_decode_split_kernel<float, D>
      <<<dim3(nsplit, KVH, B), FD_THREADS, smem, s>>>(
          q, k, v, bias, acc_part, m_part, l_part, H, KVH, S, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_decode_combine_kernel<float><<<dim3(H, B), D, 0, s>>>(
      acc_part, m_part, l_part, out, H, nsplit, D);
  return (int)cudaGetLastError();
}

template <int D>
static int fdt_launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
                      const __nv_bfloat16* v, const float* bias,
                      __nv_bfloat16* out, float* acc_part, float* m_part,
                      float* l_part, int B, int H, int KVH, int S, int nsplit,
                      float scale, cudaStream_t s) {
  const int smem = FdtShape<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  flash_decode_tc_kernel<D><<<dim3(nsplit, KVH, B), FDT_THREADS, smem, s>>>(
      q, k, v, bias, acc_part, m_part, l_part, H, KVH, S, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_decode_combine_kernel<__nv_bfloat16><<<dim3(H, B), D, 0, s>>>(
      acc_part, m_part, l_part, out, H, nsplit, D);
  return (int)cudaGetLastError();
}

// The wrapper checks the shapes: H % KVH == 0, D in {64, 128, 256},
// 1 <= nsplit <= S. Partials (16-byte aligned): acc B * H * nsplit * D
// floats, then m and l B * H * nsplit floats each.
// float32, CUDA cores: (H / KVH) * D <= 4 * FD_THREADS * FD_SLOTS.
extern "C" int flash_decode_launch(const float* q, const float* k,
                                   const float* v, const float* bias,
                                   float* out, float* acc_part, float* m_part,
                                   float* l_part, int B, int H, int KVH, int S,
                                   int D, int nsplit, float scale,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 64:
      return fd_launch<64>(q, k, v, bias, out, acc_part, m_part, l_part, B, H,
                           KVH, S, nsplit, scale, s);
    case 128:
      return fd_launch<128>(q, k, v, bias, out, acc_part, m_part, l_part, B,
                            H, KVH, S, nsplit, scale, s);
    case 256:
      return fd_launch<256>(q, k, v, bias, out, acc_part, m_part, l_part, B,
                            H, KVH, S, nsplit, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

// bf16, tensor cores: H / KVH <= FDT_M.
extern "C" int flash_decode_tc_launch(const void* q, const void* k,
                                      const void* v, const float* bias,
                                      void* out, float* acc_part,
                                      float* m_part, float* l_part, int B,
                                      int H, int KVH, int S, int D, int nsplit,
                                      float scale, void* stream) {
  typedef const __nv_bfloat16* P;
  __nv_bfloat16* o = (__nv_bfloat16*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 64:
      return fdt_launch<64>((P)q, (P)k, (P)v, bias, o, acc_part, m_part,
                            l_part, B, H, KVH, S, nsplit, scale, s);
    case 128:
      return fdt_launch<128>((P)q, (P)k, (P)v, bias, o, acc_part, m_part,
                             l_part, B, H, KVH, S, nsplit, scale, s);
    case 256:
      return fdt_launch<256>((P)q, (P)k, (P)v, bias, o, acc_part, m_part,
                             l_part, B, H, KVH, S, nsplit, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
