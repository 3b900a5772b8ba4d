// Causal or full flash attention over whole sequences, with GQA, for bf16
// operands on Hopper's tensor cores.
//
// Replaces flash_prefill of src/repro/kernels/flash_prefill.py for bf16: for
// each (b, h) and query row i, softmax(q_i . K^T / sqrt(D), masked to keys
// j <= i when causal) . V over KV head h / G (G = H / KV), out in bf16.
// float32 operands keep flash_prefill.cu's CUDA-core kernel: the reference
// computes both products in float32, and the tensor cores' TF32 keeps ~3
// decimal digits, too few for the float32 tolerances.
//
// Bound on the card: operations, 4 * B * H * S^2 * D (half of it when
// causal) against the tensor cores' 989 TFLOP/s. What the design does:
//   * one block of 1 + BQ / 64 warpgroups per (BQ query rows, head, batch
//     row): a producer warpgroup gives up its registers (setmaxnreg) and
//     one of its threads issues TMA loads; BQ / 64 consumer warpgroups own
//     64 query rows each. Causal grids run the query tiles heaviest first;
//   * Q is loaded once; K and V tiles of BK keys stream through a ring of
//     STAGES stages with full / empty mbarriers, so the next tiles land
//     while this one is computed. Every tile is stored as 64-column panels
//     in the 128-byte swizzle that wgmma descriptors read directly. The
//     tensor maps are 3-D, (D, S, heads), so a tile that crosses S is
//     zero-filled inside its own head;
//   * S = Q . K^T is a wgmma with both operands in shared memory (m64 x BK
//     x 16 steps); the online softmax runs on the accumulator fragment in
//     registers in base 2 (the scale and log2 e folded into one FFMA with
//     the max), row max and sum by quad shuffles; O += P . V is a wgmma
//     with P from registers and V read transposed (MN-major) from shared
//     memory;
//   * each consumer pipelines its own products (FA3's intra-warpgroup
//     overlap): it issues S of tile t + 1 and O += P . V of tile t
//     together, and runs tile t + 1's softmax while P . V is on the
//     tensor cores (not at D = 256 with two consumers, whose registers
//     cannot hold both: FptShape::OVERLAP); K is then needed a tile early,
//     so the ring has three stages where shared memory allows;
//   * P is rounded to bf16 for the product as hi + lo, two bf16 products,
//     so P . V carries p to ~2^-16: a single bf16 P (2^-9) breaks the bf16
//     tolerance on rows whose softmax sits on few keys, such as the first
//     rows of a causal sequence. The row sum l is taken from the float32 p;
//   * the reference's constants: m starts at -1e30, the causal mask is
//     -1e30, the denominator is max(l, 1e-30). Causal key tiles wholly above
//     a warpgroup's rows are skipped (after the first tile, which holds key
//     0, has set m, they would add exp(-1e30 - m) = 0); keys past S get
//     -inf, so a padded key never joins the softmax; query rows past S are
//     not written.
// The tile (BQ, BK) is tuning's (block_q, block_k): BQ 64 or 128 query
// rows, BK 64 or 128 keys, an instance each where two stages fit shared
// memory, three stages where three fit (FptShape). The builtin, FPT_BQ =
// 128 and BK 128, is three stages at D <= 128 (Q 32 KB and K + V 192 KB at
// D = 128: 225 KB of the 227 KB); D = 256 takes BK = 64 and two stages,
// where Q is 64 KB and two stages of K + V 128 KB.
//
// Host side: the tensor maps are encoded with libcuda's
// cuTensorMapEncodeTiled, fetched at run time through the runtime's
// entry-point query (no -lcuda at link time), and passed as
// __grid_constant__ kernel parameters.
#include <cuda.h>
#include <math_constants.h>

#include "tensor_core.cuh"
#include "wgmma.cuh"

// The checked build (-DFPT_CHECK_BOUNDS; flash_prefill.py out_of_bounds):
// each 4-byte store of the output is held against the byte ranges of the
// launch's operands, which the host sets before it
// (flash_prefill_tc_check_set); a store outside them is not made but
// counted, the first FPT_CHECK_RECORDS kept as (address, bytes, source
// line) (flash_prefill_tc_check_get). The loads are TMA boxes, which read
// nothing outside their tensor map's dims (zeros fill the rest), so the
// host holds each map instead: its base and dims times 2 bytes must be one
// of the ranges set (FPT_ERR_MAP_RANGE otherwise). The kernel is the same,
// setmaxnreg included.
#ifdef FPT_CHECK_BOUNDS
#define FPT_CHECK_RANGES 8
#define FPT_CHECK_RECORDS 64
#define FPT_ERR_MAP_RANGE 20000
__device__ unsigned long long fpt_check_lo[FPT_CHECK_RANGES];
__device__ unsigned long long fpt_check_hi[FPT_CHECK_RANGES];
__device__ int fpt_check_n;
__device__ unsigned fpt_check_count;
__device__ unsigned long long fpt_check_rec[FPT_CHECK_RECORDS][3];
// the host's copy of the ranges, for the maps
static unsigned long long fpt_host_lo[FPT_CHECK_RANGES];
static unsigned long long fpt_host_hi[FPT_CHECK_RANGES];
static int fpt_host_n;

__device__ __noinline__ void fpt_check_fail(unsigned long long a,
                                            long long bytes, int line) {
  const unsigned k = atomicAdd(&fpt_check_count, 1u);
  if (k < FPT_CHECK_RECORDS) {
    fpt_check_rec[k][0] = a;
    fpt_check_rec[k][1] = (unsigned long long)bytes;
    fpt_check_rec[k][2] = (unsigned long long)line;
  }
}

__device__ bool fpt_check(unsigned long long a, long long bytes, int line) {
  for (int i = 0; i < fpt_check_n; ++i)
    if (a >= fpt_check_lo[i] && a + bytes <= fpt_check_hi[i]) return true;
  fpt_check_fail(a, bytes, line);
  return false;
}

#define FPT_STORE_OK(p, bytes) \
  fpt_check((unsigned long long)(p), (bytes), __LINE__)

// Whether a map of (D, S, heads) bf16 elements at ptr spans one range set.
static bool fpt_map_ok(const void* ptr, int D, int S, int heads) {
  const unsigned long long lo = (unsigned long long)ptr;
  const unsigned long long hi = lo + 2ull * D * S * heads;
  for (int i = 0; i < fpt_host_n; ++i)
    if (fpt_host_lo[i] == lo && fpt_host_hi[i] == hi) return true;
  return false;
}

// The operands' byte ranges [lo, hi) of the next launch, and a zero count.
extern "C" int flash_prefill_tc_check_set(const unsigned long long* lo,
                                          const unsigned long long* hi,
                                          int n) {
  if (n < 0 || n > FPT_CHECK_RANGES) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n; ++i) {
    fpt_host_lo[i] = lo[i];
    fpt_host_hi[i] = hi[i];
  }
  fpt_host_n = n;
  const unsigned zero = 0;
  cudaError_t e = cudaMemcpyToSymbol(fpt_check_lo, lo, 8 * n);
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(fpt_check_hi, hi, 8 * n);
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(fpt_check_n, &n, sizeof(int));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(fpt_check_count, &zero, sizeof(unsigned));
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return (int)e;
}

// The last launch's count of accesses outside the ranges and its records
// (FPT_CHECK_RECORDS x 3 words), after the launch has finished.
extern "C" int flash_prefill_tc_check_get(unsigned* count,
                                          unsigned long long* rec) {
  cudaError_t e =
      cudaMemcpyFromSymbol(count, fpt_check_count, sizeof(unsigned));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(rec, fpt_check_rec, sizeof(fpt_check_rec));
  return (int)e;
}
#else
#define FPT_STORE_OK(p, bytes) true
#endif

#define FPT_BQ 128        // query rows per block of the builtin tile
#define FPT_BK 128        // keys per tile of the builtin tile
#define FPT_THREADS 384   // the most threads a block: producer + two consumers
#define FPT_SMEM_MAX 232448  // shared memory a block can have
#define FPT_NEG (-1e30f)  // the reference's mask value and initial max
// Error codes beyond cudaError_t: no cuTensorMapEncodeTiled found; a tensor
// map it refused (plus its CUresult).
#define FPT_ERR_NO_ENCODE 9000
#define FPT_ERR_TENSOR_MAP 10000

// Bytes of shared memory of a block of the (BQ, BK) tile at head dim D
// with `stages` K / V stages: 1 KB for aligning the tiles to the swizzle
// atom, Q, the ring, the barriers.
constexpr int fpt_smem(int D, int BQ, int BK, int stages) {
  return 1024 + BQ * D * 2 + 2 * stages * BK * D * 2 + 8 * (1 + 2 * stages);
}

// The shape of the (BQ, BK) tile at head dim D; FITS when two stages fit
// shared memory (an instance exists).
template <int D, int BQ, int BK_>
struct FptShape {
  static constexpr int BK = BK_;                  // keys per tile
  static constexpr int CONSUMERS = BQ / 64;       // warpgroups of 64 rows
  static constexpr int THREADS = 128 * (1 + CONSUMERS);
  // a consumer's registers after setmaxnreg: the launch gives each lane
  // 168 (FPT_THREADS' budget) and the producer keeps 24, so two consumers
  // take 240 each (3 x 168 = 24 + 2 x 240) and one the most, 256
  static constexpr int CONSUMER_REGS = CONSUMERS == 1 ? 256 : 240;
  // Whether a consumer issues tile t + 1's scores while tile t's P . V
  // runs: O (D / 2 floats a thread), the scores and P (BK / 2 each) live
  // at once. At D = 256 two consumers' 240 registers hold O and one of
  // the other two, not both (40 bytes spilled): there the scores wait.
  static constexpr bool OVERLAP = !(D >= 256 && CONSUMERS == 2);
  static constexpr int PANELS = D / 64;           // 128-byte column panels
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;     // one K (or V) tile
  // the K / V ring's depth: three stages where they fit
  static constexpr int STAGES =
      fpt_smem(D, BQ, BK, 3) <= FPT_SMEM_MAX ? 3 : 2;
  static constexpr int SMEM = fpt_smem(D, BQ, BK, STAGES);
  static constexpr bool FITS = fpt_smem(D, BQ, BK, 2) <= FPT_SMEM_MAX;
  static_assert(BQ == 64 || BQ == 128, "one or two consumer warpgroups");
  static_assert(BK == 64 || BK == 128, "the wgmma forms of wgmma.cuh");
};

static_assert(FptShape<128, FPT_BQ, FPT_BK>::STAGES == 3 &&
                  FptShape<256, FPT_BQ, 64>::STAGES == 2,
              "the builtin tile's rings (three stages up to D = 128)");

// Grid (ceil(S / BQ), H, B), FptShape::THREADS threads. The register
// budget is FPT_THREADS' (168 a thread at launch) for every tile, so that
// setmaxnreg moves the same registers from the producer to each consumer.
template <int D, int BQ, int BK_>
__global__ void __launch_bounds__(FPT_THREADS, 1) flash_prefill_tc_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
    int H, int KV, int S, int causal, float scale_log2) {
  using Sh = FptShape<D, BQ, BK_>;
  constexpr int BK = Sh::BK;
  constexpr float NEG_L2 = FPT_NEG * TC_LOG2E;  // -1e30 in base 2
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* k_s = q_s + Sh::Q_BYTES;                // [stage][panel][BK][64]
  unsigned char* v_s = k_s + Sh::STAGES * Sh::KV_BYTES;  // the same
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + Sh::STAGES * Sh::KV_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + Sh::STAGES;

  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int k_end = causal ? min(S, q0 + BQ) : S;
  const int ntiles = (k_end + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < Sh::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], Sh::CONSUMERS * 128);  // every consumer thread
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // -- producer: one thread keeps the ring full --------------------------
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, Sh::Q_BYTES);
      for (int p = 0; p < Sh::PANELS; ++p)
        tma_load_3d(q_s + p * BQ * 128, &tq, q_full, p * 64, q0, b * H + h);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % Sh::STAGES;
        mbar_wait(&empty[s], ((t / Sh::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * Sh::KV_BYTES);
        for (int p = 0; p < Sh::PANELS; ++p) {
          tma_load_3d(k_s + s * Sh::KV_BYTES + p * BK * 128, &tk, &full[s],
                      p * 64, t * BK, b * KV + kvh);
          tma_load_3d(v_s + s * Sh::KV_BYTES + p * BK * 128, &tv, &full[s],
                      p * 64, t * BK, b * KV + kvh);
        }
      }
    }
  } else {
    // -- consumers: 64 query rows each -------------------------------------
    setmaxnreg_inc<Sh::CONSUMER_REGS>();
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg, warp = tid / 32, lane = tid % 32;
    const int wq0 = q0 + 64 * c;          // this warpgroup's first row
    const int r_lo = 16 * warp + lane / 4;  // rows r_lo and r_lo + 8 of 64
    // causal: the tiles past n_mine lie wholly above this warpgroup's rows
    const int n_mine = causal ? min(ntiles, (wq0 + 63) / BK + 1) : ntiles;
    float sc[BK / 2];                     // scores, then p (m64 x BK)
    float o[D / 2];                       // output accumulator (m64 x D)
    uint32_t phi[BK / 16][4], plo[BK / 16][4];  // P as wgmma A fragments
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    float m[2] = {NEG_L2, NEG_L2}, l[2] = {0.0f, 0.0f}, alpha[2];

    // S = Q . K^T of tile t, issued (one commit group)
    auto issue_scores = [&](int t) {
      const int s = t % Sh::STAGES;
      mbar_wait(&full[s], (t / Sh::STAGES) & 1);
      const unsigned char* ks = k_s + s * Sh::KV_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int p = kk / 4, off = (kk % 4) * 32;
        wgmma_ss(sc,
                 wgmma_desc(q_s + p * BQ * 128 + c * 64 * 128 + off, 16,
                            1024),
                 wgmma_desc(ks + p * BK * 128 + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    // O += P . V of tile t, V read transposed (K = 16 keys a step, N = D),
    // P as hi + lo; issued (one commit group)
    auto issue_pv = [&](int t) {
      const unsigned char* vs = v_s + (t % Sh::STAGES) * Sh::KV_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv = wgmma_desc(vs + kk * 16 * 128, BK * 128, 1024);
        wgmma_rs(o, phi[kk], dv);
        wgmma_rs(o, plo[kk], dv);
      }
      wgmma_commit();
    };
    // The online softmax of tile t in base 2 on the score fragment, into
    // p: element (nb, i) is row r_lo + 8 (i / 2), key k0 + 8 nb + 2 (lane %
    // 4) + i % 2. Tiles at the diagonal or past S mask their scores (x = s
    // * scale log2 e); the others take the max of the raw scores and p =
    // 2^(s c - m) in one FFMA (the scale c is positive). Sets m, alpha
    // (the rescale of what came before) and this thread's share of l.
    auto softmax = [&](int t) {
      const int k0 = t * BK;
      const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > wq0);
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
      if (edge) {
#pragma unroll
        for (int nb = 0; nb < BK / 8; ++nb)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = k0 + nb * 8 + (lane % 4) * 2 + (i & 1);
            float x = __fmul_rn(sc[nb * 4 + i], scale_log2);
            if (key >= S)
              x = -CUDART_INF_F;
            else if (causal && key > wq0 + r_lo + (i >> 1) * 8)
              x = NEG_L2;
            sc[nb * 4 + i] = x;
            mx[i >> 1] = fmaxf(mx[i >> 1], x);
          }
      } else {
#pragma unroll
        for (int nb = 0; nb < BK / 8; ++nb)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            mx[i >> 1] = fmaxf(mx[i >> 1], sc[nb * 4 + i]);
#pragma unroll
        for (int r = 0; r < 2; ++r) mx[r] = __fmul_rn(mx[r], scale_log2);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        mx[r] = fmaxf(m[r], mx[r]);
        alpha[r] = ex2(__fsub_rn(m[r], mx[r]));
        m[r] = mx[r];
        l[r] = __fmul_rn(l[r], alpha[r]);
      }
#pragma unroll
      for (int nb = 0; nb < BK / 8; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = sc[nb * 4 + i];
          const float p = edge ? ex2(__fsub_rn(x, m[i >> 1]))
                               : ex2(__fmaf_rn(x, scale_log2, -m[i >> 1]));
          sc[nb * 4 + i] = p;
          l[i >> 1] = __fadd_rn(l[i >> 1], p);
        }
    };
    // O *= alpha; P (m64 x BK) -> A fragments: step kk covers the key
    // blocks 2 kk and 2 kk + 1
    auto rescale_and_split = [&]() {
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb) {
        o[nb * 4 + 0] = __fmul_rn(o[nb * 4 + 0], alpha[0]);
        o[nb * 4 + 1] = __fmul_rn(o[nb * 4 + 1], alpha[0]);
        o[nb * 4 + 2] = __fmul_rn(o[nb * 4 + 2], alpha[1]);
        o[nb * 4 + 3] = __fmul_rn(o[nb * 4 + 3], alpha[1]);
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const float* a = sc + 8 * kk;
        split_bf16(a[0], a[1], phi[kk][0], plo[kk][0]);
        split_bf16(a[2], a[3], phi[kk][1], plo[kk][1]);
        split_bf16(a[4], a[5], phi[kk][2], plo[kk][2]);
        split_bf16(a[6], a[7], phi[kk][3], plo[kk][3]);
      }
    };

    mbar_wait(q_full, 0);
    issue_scores(0);
    wgmma_wait<0>();
    reg_fence(sc);
    softmax(0);
    rescale_and_split();
    // Straight-line wgmma issue in the loop (a conditional issue makes
    // ptxas serialize the products): the last tile is peeled.
    for (int t = 0; t + 1 < n_mine; ++t) {
      if constexpr (Sh::OVERLAP) {
        issue_scores(t + 1);
        issue_pv(t);
        wgmma_wait<1>();  // tile t + 1's scores, while tile t's P . V runs
        reg_fence(sc);
        softmax(t + 1);
        wgmma_wait<0>();
        reg_fence(o);
        reg_fence(phi);
        reg_fence(plo);
        mbar_arrive(&empty[t % Sh::STAGES]);
      } else {
        issue_pv(t);
        wgmma_wait<0>();
        reg_fence(o);
        reg_fence(phi);
        reg_fence(plo);
        mbar_arrive(&empty[t % Sh::STAGES]);
        // the scores start anew: their last values (tile t's P) are dead
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sc[i] = 0.0f;
        issue_scores(t + 1);
        wgmma_wait<0>();
        reg_fence(sc);
        softmax(t + 1);
      }
      rescale_and_split();
    }
    issue_pv(n_mine - 1);
    wgmma_wait<0>();
    reg_fence(o);
    reg_fence(phi);
    reg_fence(plo);
    mbar_arrive(&empty[(n_mine - 1) % Sh::STAGES]);
    for (int t = n_mine; t < ntiles; ++t) {  // release the tiles it skips
      mbar_wait(&full[t % Sh::STAGES], (t / Sh::STAGES) & 1);
      mbar_arrive(&empty[t % Sh::STAGES]);
    }

    // out = O / max(l, 1e-30), rows past S not written
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 1));
      l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 2));
      const int row = wq0 + r_lo + 8 * r;
      if (row >= S) continue;
      const float den = fmaxf(l[r], 1e-30f);
      __nv_bfloat16* orow = out + (((long long)b * H + h) * S + row) * D;
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb)
        if (FPT_STORE_OK(orow + nb * 8 + (lane % 4) * 2, 4))
          *reinterpret_cast<uint32_t*>(orow + nb * 8 + (lane % 4) * 2) =
              pack_bf16(__fdiv_rn(o[nb * 4 + 2 * r], den),
                        __fdiv_rn(o[nb * 4 + 2 * r + 1], den));
    }
  }
}

// cuTensorMapEncodeTiled's signature (cuda.h), fetched from libcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A (D, S, heads) bf16 tensor, row-major (S, D) per head, read in boxes of
// 64 columns x `rows` rows of one head, 128-byte swizzled; outside the
// tensor the box is zero-filled.
static int make_map(EncodeTiledFn enc, CUtensorMap* map, const void* ptr,
                    int D, int S, int heads, int rows) {
  cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads};
  cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                   const_cast<void*>(ptr), dims, strides, box, elem,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : FPT_ERR_TENSOR_MAP + (int)r;
}

template <int D, int BQ, int BK>
static int fpt_launch(const void* q, const void* k, const void* v, void* out,
                      int B, int H, int KV, int S, int causal, float scale,
                      void* stream) {
  using Sh = FptShape<D, BQ, BK>;
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return FPT_ERR_NO_ENCODE;
  CUtensorMap tq, tk, tv;
  int err = make_map(enc, &tq, q, D, S, B * H, BQ);
  if (err == 0) err = make_map(enc, &tk, k, D, S, B * KV, BK);
  if (err == 0) err = make_map(enc, &tv, v, D, S, B * KV, BK);
  if (err != 0) return err;
#ifdef FPT_CHECK_BOUNDS
  if (!fpt_map_ok(q, D, S, B * H) || !fpt_map_ok(k, D, S, B * KV) ||
      !fpt_map_ok(v, D, S, B * KV))
    return FPT_ERR_MAP_RANGE;
#endif
  const int smem = Sh::SMEM;
  cudaError_t cerr = cudaFuncSetAttribute(
      flash_prefill_tc_kernel<D, BQ, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cerr != cudaSuccess) return (int)cerr;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_prefill_tc_kernel<D, BQ, BK>
      <<<grid, Sh::THREADS, smem, (cudaStream_t)stream>>>(
          tq, tk, tv, (__nv_bfloat16*)out, H, KV, S, causal,
          scale * TC_LOG2E);
  return (int)cudaGetLastError();
}

// The instance of the (bq, bk) tile at head dim D, where it fits
// (flash_prefill.py instance picks the largest at or below the tile); any
// other tile is refused.
template <int D, int BQ>
static int fpt_keys(const void* q, const void* k, const void* v, void* out,
                    int B, int H, int KV, int S, int causal, float scale,
                    void* stream, int bk) {
  if (bk == 64)
    return fpt_launch<D, BQ, 64>(q, k, v, out, B, H, KV, S, causal, scale,
                                   stream);
  if constexpr (FptShape<D, BQ, 128>::FITS) {
    if (bk == 128)
      return fpt_launch<D, BQ, 128>(q, k, v, out, B, H, KV, S, causal,
                                      scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <int D>
static int fpt_rows(const void* q, const void* k, const void* v, void* out,
                      int B, int H, int KV, int S, int causal, float scale,
                      void* stream, int bq, int bk) {
  if (bq == 64)
    return fpt_keys<D, 64>(q, k, v, out, B, H, KV, S, causal, scale, stream,
                           bk);
  if (bq == 128)
    return fpt_keys<D, 128>(q, k, v, out, B, H, KV, S, causal, scale, stream,
                            bk);
  return (int)cudaErrorInvalidValue;
}

// bf16 q (B, H, S, D), k / v (B, KV, S, D), out (B, H, S, D), all
// contiguous and 16-byte aligned; D in {64, 128, 256}; H % KV == 0; S >= 1;
// the tile (bq, bk) last.
extern "C" int flash_prefill_tc_launch(const void* q, const void* k,
                                       const void* v, void* out, int B, int H,
                                       int KV, int S, int D, int causal,
                                       float scale, void* stream, int bq,
                                       int bk) {
  switch (D) {
    case 64:
      return fpt_rows<64>(q, k, v, out, B, H, KV, S, causal, scale, stream,
                            bq, bk);
    case 128:
      return fpt_rows<128>(q, k, v, out, B, H, KV, S, causal, scale, stream,
                             bq, bk);
    case 256:
      return fpt_rows<256>(q, k, v, out, B, H, KV, S, causal, scale, stream,
                             bq, bk);
  }
  return (int)cudaErrorInvalidValue;
}
