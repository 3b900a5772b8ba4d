// One-token decode attention over a KV cache, with GQA and an additive bias.
//
// Replaces flash_decode of src/repro/kernels/flash_decode.py: for each batch
// row b and query head h, softmax(q . K^T / sqrt(D) + bias[b]) . V over the
// cache of KV head h / G (G = H / KV_H), out in q's dtype. One kernel a
// dtype computes the splits of the cache:
//   * bf16: flash_decode_tc_kernel, both products on the tensor cores, and
//     the combine kernel merges the splits (a second launch);
//   * float32: flash_decode_f32_kernel on the CUDA cores, as the reference
//     computes in float32 and the tensor cores' TF32 keeps ~3 decimal
//     digits, too few for the float32 tolerances. It merges the splits in
//     the same launch: one device operation a call.
//
// Bound on the card: bytes. Every K and V element is read once; the
// arithmetic is 4 * B * H * S * D operations, 4 G of them a K/V element
// pair (16 operations a byte at G = 16), below the byte time on the tensor
// cores. What the designs do about it:
//   * one block per (S-split, KV head, batch row) handles all G query heads
//     of its group, so each K/V tile is read once per group (the TPU grid
//     (B, H, S / block_s) reads it G times);
//   * the wrapper chooses the number of splits (flash_decode.py
//     decode_splits for bf16, decode_splits_f32 for float32) so that small
//     batches still give enough blocks to fill the SMs (flash-decoding);
//     split i covers keys [i S / n, (i + 1) S / n), and the splits' (m, l,
//     acc) partials are merged in split order;
//   * K, V and the bias slice stream through a ring filled by 16-byte
//     cp.async, so the next tiles are in flight while one is computed; one
//     block barrier a tile releases a stage. Each warp takes its own keys
//     of every tile with its own online softmax for all G heads, and the
//     warps merge once, at the end of the split, in shared memory;
//   * bf16: stages of TK keys, FDT_STAGES deep (the tile, tuning's block_s:
//     64, 128 or 256 keys, as far as three stages fit shared memory at the
//     head dim; FDT_TK = 64 is the builtin, 101 KB a block at D = 128, two
//     blocks an SM); the tiles stay bf16 in shared memory, rows swizzled so
//     ldmatrix reads them without bank conflicts. The G heads are the 16
//     rows of mma.sync m16n8k16 (padded); each warp takes 16 keys of every
//     64 of a tile, one online-softmax step each. P goes to the P . V
//     product as hi + lo, two bf16 fragments, so it carries p to ~2^-16
//     (the bytes bound leaves the tensor cores idle);
//   * float32: stages of 32 KB of K and V (4096 / D keys; at D = 16, 128
//     keys, 16 KB, so that a warp's 32 keys give each lane one), FD_STAGES
//     deep, so that a split of phase D's shape (64 keys) is in flight at
//     once and two blocks share an SM. A warp's quarter of a tile: in
//     Q . K^T each key takes 32 / (keys a warp) lanes, which hold its K row
//     in registers and sum their slices of each dot by shuffles; the
//     softmax runs a lane a head over the warp's keys; in P . V a lane owns
//     float4 columns of the group's G x D output. The last block of each
//     (batch row, KV head) to finish, found by an atomic ticket after a
//     __threadfence that publishes its partials, merges the splits as the
//     combine kernel does and resets its counter. Partials and counters
//     live in a scratch that the wrapper keeps per (device, stream).
//
// Online softmax as the reference: m starts at -1e30 (not -inf), so a row
// whose every key carries the -1e30 mask averages V as the reference does
// and is not NaN. Keys past S (the cache's ragged end) are left out, not
// masked: no padding is needed. Both kernels run the softmax in base 2
// (logits times log2 e, the same -1e30 in base 2).
#include <math_constants.h>

#include "attention.cuh"
#include "tensor_core.cuh"

// The checked build (-DFDT_CHECK_BOUNDS; flash_decode.py out_of_bounds):
// every cp.async source that reads (a copy of 0 bytes reads nothing), every
// __ldcg and every global load and store of both dtypes' kernels and of the
// combine kernel is held against the byte ranges of the launch's operands
// (q, k, v, the bias, the output, the partials and the counters), which the
// host sets before it (flash_decode_check_set). An access outside them is
// not made (a copy zero-fills, a load reads 0) but counted, and the first
// FDT_CHECK_RECORDS are kept as (address, bytes, source line)
// (flash_decode_check_get). The kernels are otherwise these ones: the same
// instances, tiles, splits and launch shapes.
#ifdef FDT_CHECK_BOUNDS
#define FDT_CHECK_RANGES 10
#define FDT_CHECK_RECORDS 64
__device__ unsigned long long fdt_check_lo[FDT_CHECK_RANGES];
__device__ unsigned long long fdt_check_hi[FDT_CHECK_RANGES];
__device__ int fdt_check_n;
__device__ unsigned fdt_check_count;
__device__ unsigned long long fdt_check_rec[FDT_CHECK_RECORDS][3];

__device__ __noinline__ void fdt_check_fail(const void* p, int bytes,
                                            int line) {
  const unsigned k = atomicAdd(&fdt_check_count, 1u);
  if (k < FDT_CHECK_RECORDS) {
    fdt_check_rec[k][0] = (unsigned long long)p;
    fdt_check_rec[k][1] = (unsigned long long)bytes;
    fdt_check_rec[k][2] = (unsigned long long)line;
  }
}

__device__ __forceinline__ bool fdt_check(const void* p, int bytes,
                                          int line) {
  const unsigned long long a = (unsigned long long)p;
  for (int i = 0; i < fdt_check_n; ++i)
    if (a >= fdt_check_lo[i] && a + bytes <= fdt_check_hi[i]) return true;
  fdt_check_fail(p, bytes, line);
  return false;
}

__device__ __forceinline__ void fdt_checked_cp16(void* dst, const void* src,
                                                 int n, int line) {
  cp_async16(dst, src, n == 0 || fdt_check(src, 16, line) ? n : 0);
}
__device__ __forceinline__ void fdt_checked_cp4(void* dst, const void* src,
                                                int n, int line) {
  cp_async4(dst, src, n == 0 || fdt_check(src, 4, line) ? n : 0);
}
template <typename T>
__device__ __forceinline__ T fdt_checked_ld(const T* p, int line) {
  return fdt_check(p, sizeof(T), line) ? *p : T();
}
template <typename T>
__device__ __forceinline__ T fdt_checked_ldcg(const T* p, int line) {
  return fdt_check(p, sizeof(T), line) ? (__ldcg)(p) : T();
}

#define cp_async16(d, s, n) fdt_checked_cp16((d), (s), (n), __LINE__)
#define cp_async4(d, s, n) fdt_checked_cp4((d), (s), (n), __LINE__)
#define __ldcg(p) fdt_checked_ldcg((p), __LINE__)
#define FDT_LD(p) fdt_checked_ld((p), __LINE__)
#define FDT_ST(p) fdt_check((p), sizeof(*(p)), __LINE__)

// The operands' byte ranges [lo, hi) of the next launch, and a zero count.
extern "C" int flash_decode_check_set(const unsigned long long* lo,
                                      const unsigned long long* hi, int n) {
  if (n < 0 || n > FDT_CHECK_RANGES) return (int)cudaErrorInvalidValue;
  const unsigned zero = 0;
  cudaError_t e = cudaMemcpyToSymbol(fdt_check_lo, lo, 8 * n);
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(fdt_check_hi, hi, 8 * n);
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(fdt_check_n, &n, sizeof(int));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(fdt_check_count, &zero, sizeof(unsigned));
  // landed before the launch, whatever stream it takes
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return (int)e;
}

// The last launch's count of accesses outside the ranges and its records
// (FDT_CHECK_RECORDS x 3 words), after the launch has finished.
extern "C" int flash_decode_check_get(unsigned* count,
                                      unsigned long long* rec) {
  cudaError_t e =
      cudaMemcpyFromSymbol(count, fdt_check_count, sizeof(unsigned));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(rec, fdt_check_rec, sizeof(fdt_check_rec));
  return (int)e;
}
#else
#define FDT_LD(p) (*(p))
#define FDT_ST(p) true
#endif

#define FD_NEG (-1e30f)  // the reference's initial running max
#define FD_LN2 0.6931471805599453f
#define FD_MAX_DEVICES 64

// -- float32: the CUDA-core split kernel, merged in the same launch ------------

#define FD_THREADS 128  // four warps: a quarter of every tile's keys each
#define FD_WARPS 4
#define FD_STAGES 3     // ring depth: two tiles in flight while one computes
#define FD_SMALL 4      // float4 accumulators a lane when G * D <= 512
#define FD_LARGE 32     // ... when G * D <= 4096 (MAX_GROUP_WIDTH)
#define FD_MERGE_WORDS 8192  // most G * nsplit: the merge's e and l in the ring

template <int D>
struct FdShape {
  // keys a stage: 32 KB of K and V, at most a key a lane of each warp
  static constexpr int TK =
      4096 / D < 32 * FD_WARPS ? 4096 / D : 32 * FD_WARPS;
  static constexpr int KPW = TK / FD_WARPS;  // keys a warp a tile
  static constexpr int P = 32 / KPW;         // lanes a key in Q . K^T
  static constexpr int D4 = D / 4;
  static constexpr int KS4 = D4 + 1;    // K rows padded: a lane's float4s of
                                        // one load lie on distinct bank groups
  static constexpr int NK4 = D4 / P;    // float4s of a K row a lane holds
  static constexpr int LS = KPW + 1;    // a head's logits in a warp's tile
  static constexpr int STAGE4 = TK * KS4 + TK * D4 + TK / 4;  // K, V, bias
  // the stages, or the warps' accumulators at the end where those need
  // more (D = 16: 56 KB of stages, 64 KB of accumulators at G D = 4096)
  static constexpr int MERGE = FD_WARPS * 4096 * 4;
  static constexpr int RING = 16 * FD_STAGES * STAGE4 > MERGE
                                  ? 16 * FD_STAGES * STAGE4
                                  : MERGE;
  // bytes for G heads: the ring, q, and each warp's logits, m, l, alpha
  static constexpr int smem(int G) {
    return RING + 16 * G * D4 + 4 * FD_WARPS * G * (LS + 3);
  }
  // the warps' accumulators meet in the ring at the end, then the merge's
  // e and l
  static_assert(MERGE <= RING, "merge area");
  static_assert(2 * FD_MERGE_WORDS * 4 <= RING, "merge words");
  static_assert(P >= 1 && D4 % P == 0, "lanes a key");
};

// Grid (nsplit, KV_H, B). Partials acc (B, H, nsplit, D), m (base 2) and l
// (B, H, nsplit); counters (B, KV_H), 0 between launches. A: float4
// accumulators a lane, G * D <= 128 A.
template <int D, int A>
__global__ void __launch_bounds__(FD_THREADS) flash_decode_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ bias,
    float* __restrict__ out, float* __restrict__ acc_part,
    float* __restrict__ m_part, float* __restrict__ l_part,
    int* __restrict__ counters, int H, int KVH, int S, float scale) {
  using Sh = FdShape<D>;
  constexpr int TK = Sh::TK, KPW = Sh::KPW, P = Sh::P, D4 = Sh::D4,
                KS4 = Sh::KS4, LS = Sh::LS;
  constexpr float NEG_L2 = FD_NEG * TC_LOG2E;  // -1e30 in base 2
  extern __shared__ float4 smem4[];
  float4* ring = smem4;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x, G = H / KVH, GD4 = G * D4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float4* q_s = ring + Sh::RING / 16;  // [G][D4]
  // warp w's logits [G][LS], then its m, l and alpha [G] each
  float* w_all = reinterpret_cast<float*>(q_s + GD4);
  const int WSZ = G * (LS + 3);
  float* lg = w_all + warp * WSZ;
  float* m_w = lg + G * LS;
  float* l_w = m_w + G;
  float* a_w = l_w + G;
  const long long head0 = (long long)b * H + (long long)kvh * G;
  const int s_begin = (int)((long long)split * S / nsplit);
  const int s_end = (int)((long long)(split + 1) * S / nsplit);
  const int ntiles = (s_end - s_begin + TK - 1) / TK;
  const long long kv0 = ((long long)b * KVH + kvh) * S;
  const float* kg = k + kv0 * D;
  const float* vg = v + kv0 * D;
  const float* bg = bias + (long long)b * S;

  for (int c = tid; c < GD4; c += FD_THREADS)
    cp_async16(q_s + c, q + head0 * D + c * 4, 16);
  // Tile t into stage t % FD_STAGES: K, V and the bias slice; keys past
  // the split are zero-filled (and get -inf below)
  auto load = [&](int t) {
    float4* ks = ring + (t % FD_STAGES) * Sh::STAGE4;
    float4* vs = ks + TK * KS4;
    float* bs = reinterpret_cast<float*>(vs + TK * D4);
    const int k0 = s_begin + t * TK;
#pragma unroll
    for (int it = 0; it < TK * D4 / FD_THREADS; ++it) {
      const int c = tid + it * FD_THREADS;
      const int r = c / D4, c4 = c % D4, key = k0 + r;
      const bool ok = key < s_end;
      const long long off = (long long)(ok ? key : s_begin) * D + c4 * 4;
      cp_async16(ks + r * KS4 + c4, kg + off, ok ? 16 : 0);
      cp_async16(vs + r * D4 + c4, vg + off, ok ? 16 : 0);
    }
    if (tid < TK) {
      const int key = k0 + tid;
      const bool ok = key < s_end;
      cp_async4(bs + tid, bg + (ok ? key : s_begin), ok ? 4 : 0);
    }
  };
#pragma unroll
  for (int t = 0; t < FD_STAGES - 1; ++t) {
    if (t < ntiles) load(t);
    cp_async_commit();
  }
  for (int g = lane; g < G; g += 32) {
    m_w[g] = NEG_L2;
    l_w[g] = 0.0f;
  }
  float4 acc[A];
#pragma unroll
  for (int s = 0; s < A; ++s) acc[s] = make_float4(0.f, 0.f, 0.f, 0.f);
  // Q . K^T: lane = key kk of the warp's slice x part; the part's float4
  // columns are part + P i
  const int kk = lane / P, part = lane % P;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<FD_STAGES - 2>();
    __syncthreads();  // tile t is in; tile t - 1's stage is free
    if (t + FD_STAGES - 1 < ntiles) load(t + FD_STAGES - 1);
    cp_async_commit();
    const float4* ks = ring + (t % FD_STAGES) * Sh::STAGE4;
    const float4* vs = ks + TK * KS4;
    const float* bs = reinterpret_cast<const float*>(vs + TK * D4);
    const int kw0 = warp * KPW;  // this warp's keys in the tile
    const int key_w = s_begin + t * TK + kw0;
    if (key_w >= s_end) continue;  // none in this split
    float4 kr[Sh::NK4];
#pragma unroll
    for (int i = 0; i < Sh::NK4; ++i) kr[i] = ks[(kw0 + kk) * KS4 + part + P * i];
    const bool ok = key_w + kk < s_end;
    const float bv = bs[kw0 + kk];
    __syncwarp();  // the previous tile's P . V has read lg
    // logits in base 2, (dot * scale + bias) * log2 e, as the reference
    // orders them; keys past the split -inf
    // (four heads at a time: four independent FMA chains)
    for (int g0 = 0; g0 < G; g0 += 4) {
      float dot[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < Sh::NK4; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          dot[u] = dot4(q_s[min(g0 + u, G - 1) * D4 + part + P * i], kr[i],
                        dot[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int o = P / 2; o > 0; o >>= 1)
          dot[u] = __fadd_rn(dot[u], __shfl_xor_sync(0xffffffffu, dot[u], o));
        if (part == 0 && g0 + u < G)
          lg[(g0 + u) * LS + kk] =
              ok ? __fmul_rn(__fadd_rn(__fmul_rn(dot[u], scale), bv), TC_LOG2E)
                 : -CUDART_INF_F;
      }
    }
    __syncwarp();
    // online softmax, a lane a head over the warp's KPW keys
    for (int g = lane; g < G; g += 32) {
      float* row = lg + g * LS;
      const float mo = m_w[g];
      float mx = mo;
#pragma unroll
      for (int j = 0; j < KPW; ++j) mx = fmaxf(mx, row[j]);
      const float al = ex2(__fsub_rn(mo, mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < KPW; ++j) {
        const float pr = ex2(__fsub_rn(row[j], mx));
        row[j] = pr;
        sum = __fadd_rn(sum, pr);
      }
      l_w[g] = __fadd_rn(__fmul_rn(l_w[g], al), sum);
      m_w[g] = mx;
      a_w[g] = al;
    }
    __syncwarp();
    // acc[s] (head f / D4, float4 column f % D4 of f = 32 s + lane) =
    // acc * alpha + sum_j p[head][j] v[j]
#pragma unroll
    for (int s = 0; s < A; ++s) {
      const int f = s * 32 + lane;
      if (f < GD4) acc[s] = scale4(acc[s], a_w[f / D4]);
    }
#pragma unroll 4
    for (int j = 0; j < KPW; ++j) {
#pragma unroll
      for (int s = 0; s < A; ++s) {
        const int f = s * 32 + lane;
        if (f < GD4)
          acc[s] = axpy4(lg[(f / D4) * LS + j], vs[(kw0 + j) * D4 + f % D4],
                         acc[s]);
      }
    }
  }

  // The four warps' (m, l, acc) -> this split's partial
  cp_async_wait<0>();
  __syncthreads();  // the ring is free; every warp's m and l are final
#pragma unroll
  for (int s = 0; s < A; ++s) {
    const int f = s * 32 + lane;
    if (f < GD4) ring[warp * GD4 + f] = acc[s];
  }
  __syncthreads();
  for (int f = tid; f < GD4; f += FD_THREADS) {
    const int g = f / D4;
    float mw[FD_WARPS], mx = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < FD_WARPS; ++w) {
      mw[w] = w_all[w * WSZ + G * LS + g];
      mx = fmaxf(mx, mw[w]);
    }
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
    float den = 0.0f;
#pragma unroll
    for (int w = 0; w < FD_WARPS; ++w) {
      const float e = ex2(__fsub_rn(mw[w], mx));
      num = axpy4(e, ring[w * GD4 + f], num);
      den = __fmaf_rn(e, w_all[w * WSZ + G * LS + G + g], den);
    }
    const long long slot = (head0 + g) * nsplit + split;
    float4* dst = reinterpret_cast<float4*>(acc_part + slot * D) + f % D4;
    if (FDT_ST(dst)) *dst = num;
    if (f % D4 == 0) {
      if (FDT_ST(m_part + slot)) m_part[slot] = mx;
      if (FDT_ST(l_part + slot)) l_part[slot] = den;
    }
  }

  // The last split of this (batch row, KV head) to finish merges them all
  __shared__ int last_s;
  __threadfence();  // this block's partials are visible before its ticket
  __syncthreads();
  int* counter = counters + (long long)b * KVH + kvh;
  if (tid == 0)
    last_s = FDT_ST(counter) && atomicAdd(counter, 1) == nsplit - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  // out = sum_s e_s acc_s / max(sum_s e_s l_s, 1e-30), e_s = 2^(m_s - max
  // m), in split order as flash_decode_combine_kernel. The partials of
  // other blocks are read through L2. First a warp a head: the max of its
  // m, l and the max of m, then e of every split, into shared memory (G
  // nsplit <= FD_MERGE_WORDS each, in the spent ring); then each thread's
  // sums, whose loads of acc do not wait for the sums before them
  float* e_s = reinterpret_cast<float*>(ring);  // [G][nsplit]
  float* l_s = e_s + G * nsplit;                // [G][nsplit]
  for (int g = warp; g < G; g += FD_WARPS) {
    const long long hs = (head0 + g) * nsplit;
    float mx = -CUDART_INF_F;
    for (int s = lane; s < nsplit; s += 32) {
      const float ms = __ldcg(m_part + hs + s);
      e_s[g * nsplit + s] = ms;
      l_s[g * nsplit + s] = __ldcg(l_part + hs + s);
      mx = fmaxf(mx, ms);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    for (int s = lane; s < nsplit; s += 32)  // the lane's own m, above
      e_s[g * nsplit + s] = ex2(__fsub_rn(e_s[g * nsplit + s], mx));
  }
  __syncthreads();
  for (int f = tid; f < GD4; f += FD_THREADS) {
    const int g = f / D4;
    const float* ee = e_s + g * nsplit;
    const float* ll = l_s + g * nsplit;
    const float4* ap = reinterpret_cast<const float4*>(
        acc_part + (head0 + g) * nsplit * D) + f % D4;
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
    float den = 0.0f;
    auto add = [&](int s) {
      num = axpy4(ee[s], __ldcg(ap + (long long)s * D4), num);
      den = __fmaf_rn(ee[s], ll[s], den);
    };
    // (32 splits' loads in flight where the registers allow)
    if constexpr (A == FD_SMALL) {
#pragma unroll 32
      for (int s = 0; s < nsplit; ++s) add(s);
    } else {
#pragma unroll 8
      for (int s = 0; s < nsplit; ++s) add(s);
    }
    den = fmaxf(den, 1e-30f);
    float4* dst = reinterpret_cast<float4*>(out + (head0 + g) * D) + f % D4;
    if (FDT_ST(dst))
      *dst = make_float4(__fdiv_rn(num.x, den), __fdiv_rn(num.y, den),
                         __fdiv_rn(num.z, den), __fdiv_rn(num.w, den));
  }
  if (tid == 0 && FDT_ST(counter)) *counter = 0;
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
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, FDT_LD(m + s));
  float num = 0.0f, den = 0.0f;
  for (int s = 0; s < nsplit; ++s) {
    const float e = expf(FDT_LD(m + s) - mx);
    num = __fmaf_rn(e, FDT_LD(acc_part + (head * nsplit + s) * D + d), num);
    den = __fmaf_rn(e, FDT_LD(l + s), den);
  }
  if (FDT_ST(out + head * D + d))
    out[head * D + d] =
        from_f(__fdiv_rn(num, fmaxf(den, 1e-30f)), (T*)nullptr);
}


// -- bf16: the tensor-core split kernel ---------------------------------------

#define FDT_THREADS 128  // four warps: 16 keys of every 64 of a tile each
#define FDT_TK 64        // keys per ring stage of the builtin tile
#define FDT_STAGES 3     // ring depth: two stages in flight while one computes
#define FDT_M 16         // mma rows: the group's G <= 16 query heads, padded
#define FDT_SMEM_MAX 232448  // shared memory a block can have

template <int D, int TK>
struct FdtShape {
  static constexpr int CH = D / 8;      // 16-byte chunks of a row
  static constexpr int TILE = TK * CH;  // chunks of a K (or V) tile
  static constexpr int STAGE_BYTES = 2 * TILE * 16 + TK * 4;
  static constexpr int SMEM = FDT_M * CH * 16 + FDT_STAGES * STAGE_BYTES;
  // the warps' partials at the end, in the ring: [4][16][D + 2] floats
  static_assert(4 * 16 * (D + 2) * 4 <= FDT_STAGES * STAGE_BYTES, "ring");
  static_assert(TK % 64 == 0, "16 keys a warp a step");
};

// Chunk c of row r of a tile with CH chunks a row, swizzled: the same chunk
// of 8 consecutive rows lies on 8 distinct 16-byte bank groups.
__device__ __forceinline__ int swz(int r, int c, int CH) {
  return r * CH + (c ^ (r & 7));
}

// Grid (nsplit, KV_H, B), FDT_THREADS threads, stages of TK keys. Partials
// as the float32 kernel's, with m in natural-log units.
template <int D, int TK>
__global__ void __launch_bounds__(FDT_THREADS) flash_decode_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
    float* __restrict__ acc_part, float* __restrict__ m_part,
    float* __restrict__ l_part, int H, int KVH, int S, float scale) {
  using Sh = FdtShape<D, TK>;
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
  const int ntiles = (s_end - s_begin + TK - 1) / TK;
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
    const int k0 = s_begin + t * TK;
    for (int c = tid; c < Sh::TILE; c += FDT_THREADS) {
      const int r = c / CH, ch = c % CH, key = k0 + r;
      const bool ok = key < s_end;
      const long long off = (long long)(ok ? key : s_begin) * D + ch * 8;
      cp_async16(ks + swz(r, ch, CH), kg + off, ok ? 16 : 0);
      cp_async16(vs + swz(r, ch, CH), vg + off, ok ? 16 : 0);
    }
    for (int r = tid; r < TK; r += FDT_THREADS) {
      const int key = k0 + r;
      const bool ok = key < s_end;
      cp_async4(bs + r, bg + (ok ? key : s_begin), ok ? 4 : 0);
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

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<FDT_STAGES - 2>();
    __syncthreads();  // tile t is in; tile t - 1's stage is free
    if (t + FDT_STAGES - 1 < ntiles) load(t + FDT_STAGES - 1);
    cp_async_commit();
    const uint4* ks =
        reinterpret_cast<const uint4*>(ring + (t % FDT_STAGES) * Sh::STAGE_BYTES);
    const uint4* vs = ks + Sh::TILE;
    const float* bs = reinterpret_cast<const float*>(vs + Sh::TILE);
    const int k0 = s_begin + t * TK;
#pragma unroll 1
    for (int sub = 0; sub < TK / 64; ++sub) {  // one online-softmax step
      const int kw = 16 * warp + 64 * sub;     // this warp's keys
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
    if (FDT_ST(acc_part + slot * D + d)) acc_part[slot * D + d] = num;
    if (d == 0) {
      if (FDT_ST(m_part + slot)) m_part[slot] = __fmul_rn(mx, FD_LN2);
      if (FDT_ST(l_part + slot)) l_part[slot] = den;
    }
  }
}

// -- launchers ------------------------------------------------------------------

template <int D, int A>
static int fd_instance(const float* q, const float* k, const float* v,
                     const float* bias, float* out, float* acc_part,
                     float* m_part, float* l_part, int* counters, int B, int H,
                     int KVH, int S, int nsplit, float scale, cudaStream_t s) {
  // the shared memory limit is raised once a card, to the most G needs
  static bool raised[FD_MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= FD_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(flash_decode_f32_kernel<D, A>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               FdShape<D>::smem(128 * A / D));
    if (err != cudaSuccess) return (int)err;
    raised[dev] = true;
  }
  flash_decode_f32_kernel<D, A>
      <<<dim3(nsplit, KVH, B), FD_THREADS, FdShape<D>::smem(H / KVH), s>>>(
          q, k, v, bias, out, acc_part, m_part, l_part, counters, H, KVH, S,
          scale);
  return (int)cudaGetLastError();
}

template <int D>
static int fd_launch(const float* q, const float* k, const float* v,
                     const float* bias, float* out, float* acc_part,
                     float* m_part, float* l_part, int* counters, int B, int H,
                     int KVH, int S, int nsplit, float scale, cudaStream_t s) {
  const int width = H / KVH * D;
  if (H / KVH * nsplit > FD_MERGE_WORDS) return (int)cudaErrorInvalidValue;
  if (width <= 128 * FD_SMALL)
    return fd_instance<D, FD_SMALL>(q, k, v, bias, out, acc_part, m_part,
                                  l_part, counters, B, H, KVH, S, nsplit,
                                  scale, s);
  if (width <= 128 * FD_LARGE)
    return fd_instance<D, FD_LARGE>(q, k, v, bias, out, acc_part, m_part,
                                  l_part, counters, B, H, KVH, S, nsplit,
                                  scale, s);
  return (int)cudaErrorInvalidValue;
}

template <int D, int TK>
static int fdt_instance(const __nv_bfloat16* q, const __nv_bfloat16* k,
                        const __nv_bfloat16* v, const float* bias,
                        __nv_bfloat16* out, float* acc_part, float* m_part,
                        float* l_part, int B, int H, int KVH, int S, int nsplit,
                        float scale, cudaStream_t s) {
  const int smem = FdtShape<D, TK>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_tc_kernel<D, TK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  flash_decode_tc_kernel<D, TK><<<dim3(nsplit, KVH, B), FDT_THREADS, smem, s>>>(
      q, k, v, bias, acc_part, m_part, l_part, H, KVH, S, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_decode_combine_kernel<__nv_bfloat16><<<dim3(H, B), D, 0, s>>>(
      acc_part, m_part, l_part, out, H, nsplit, D);
  return (int)cudaGetLastError();
}

// The instance of stages of `tk` keys at head dim D: 64, 128 or 256 keys
// where three stages fit shared memory (flash_decode.py instance picks the
// largest at or below the tile); any other tk is refused.
template <int D>
static int fdt_launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
                      const __nv_bfloat16* v, const float* bias,
                      __nv_bfloat16* out, float* acc_part, float* m_part,
                      float* l_part, int B, int H, int KVH, int S, int nsplit,
                      int tk, float scale, cudaStream_t s) {
  if (tk == FDT_TK)
    return fdt_instance<D, FDT_TK>(q, k, v, bias, out, acc_part, m_part,
                                   l_part, B, H, KVH, S, nsplit, scale, s);
  if constexpr (FdtShape<D, 128>::SMEM <= FDT_SMEM_MAX) {
    if (tk == 128)
      return fdt_instance<D, 128>(q, k, v, bias, out, acc_part, m_part,
                                  l_part, B, H, KVH, S, nsplit, scale, s);
  }
  if constexpr (FdtShape<D, 256>::SMEM <= FDT_SMEM_MAX) {
    if (tk == 256)
      return fdt_instance<D, 256>(q, k, v, bias, out, acc_part, m_part,
                                  l_part, B, H, KVH, S, nsplit, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}


// The wrapper checks the shapes: H % KVH == 0, D in {64, 128, 256} (and 16
// in float32),
// 1 <= nsplit <= S. Partials (16-byte aligned): acc B * H * nsplit * D
// floats, then m and l B * H * nsplit floats each.
// float32, CUDA cores: (H / KVH) * D <= 128 * FD_LARGE, (H / KVH) * nsplit
// <= FD_MERGE_WORDS; counters: B * KVH
// ints, 0 between launches, used by one stream at a time.
extern "C" int flash_decode_launch(const float* q, const float* k,
                                   const float* v, const float* bias,
                                   float* out, float* acc_part, float* m_part,
                                   float* l_part, int* counters, int B, int H,
                                   int KVH, int S, int D, int nsplit,
                                   float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16:
      return fd_launch<16>(q, k, v, bias, out, acc_part, m_part, l_part,
                           counters, B, H, KVH, S, nsplit, scale, s);
    case 64:
      return fd_launch<64>(q, k, v, bias, out, acc_part, m_part, l_part,
                           counters, B, H, KVH, S, nsplit, scale, s);
    case 128:
      return fd_launch<128>(q, k, v, bias, out, acc_part, m_part, l_part,
                            counters, B, H, KVH, S, nsplit, scale, s);
    case 256:
      return fd_launch<256>(q, k, v, bias, out, acc_part, m_part, l_part,
                            counters, B, H, KVH, S, nsplit, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

// bf16, tensor cores: H / KVH <= FDT_M; tk keys a stage (the tile, last).
extern "C" int flash_decode_tc_launch(const void* q, const void* k,
                                      const void* v, const float* bias,
                                      void* out, float* acc_part,
                                      float* m_part, float* l_part, int B,
                                      int H, int KVH, int S, int D, int nsplit,
                                      float scale, void* stream, int tk) {
  typedef const __nv_bfloat16* P;
  __nv_bfloat16* o = (__nv_bfloat16*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 64:
      return fdt_launch<64>((P)q, (P)k, (P)v, bias, o, acc_part, m_part,
                            l_part, B, H, KVH, S, nsplit, tk, scale, s);
    case 128:
      return fdt_launch<128>((P)q, (P)k, (P)v, bias, o, acc_part, m_part,
                             l_part, B, H, KVH, S, nsplit, tk, scale, s);
    case 256:
      return fdt_launch<256>((P)q, (P)k, (P)v, bias, o, acc_part, m_part,
                             l_part, B, H, KVH, S, nsplit, tk, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
