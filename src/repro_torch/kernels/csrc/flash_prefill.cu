// Causal or full flash attention over whole sequences, with GQA, for
// float32 operands on the CUDA cores.
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
//   * balanced work: a persistent grid (the blocks that fit on the card at
//     once, by the occupancy of this instance) takes work items (query tile
//     of FP_BQ rows, head, batch row) from a ticket counter, heaviest first
//     (causal: the last query tile first; flash_prefill.py work_order is
//     the same order). The tail is then one light item, not the blocks that
//     the scheduler happened to give the heavy tiles. The counter lives in
//     a scratch that the wrapper keeps per (device, stream); the last block
//     to leave resets it;
//   * a copy ring: K and V tiles of BK keys stream through FP_STAGES stages
//     filled by 16-byte cp.async.cg, so the copy of tile t + 1 overlaps the
//     products on tile t; one block barrier a tile releases a stage. The
//     query tile loads once an item;
//   * warps that work alone: a warp owns RW query rows and KW keys of every
//     tile (the block's four warps split the rows, and at D = 64 also the
//     keys: two warps a row set, each with its own online softmax, merged
//     once at the end of the item in shared memory);
//   * register tiles: in Q . K^T a thread owns TM rows x TN keys of scores
//     (8 x 8 at D = 64; 4 x 8 at 128 and 4 x 4 at 256, where the output
//     tile takes the registers; 4 x 8 at 16) and reads Q and K as float4s,
//     16 FMAs a float4 at D = 64; it issues them component by component, so
//     a score's four FMAs stand 2 TM apart. Q rows are stored with their
//     float4 columns swizzled by row group, K rows padded, so each load
//     reads distinct bank groups. In P . V it owns TM rows x D / 8 columns
//     and reads P as float4s from its warp's key-major tile, V as float4s.
//     At D = 16 a row has four float4 columns for its eight lanes: two
//     lanes share a column, each takes every other key of the tile, and
//     the pair sums its accumulators by one shuffle at the end of the item;
//   * the softmax in registers: each score row stays in the 8 lanes that
//     computed it, row max by shuffles, each lane's share of the row sum
//     summed once at the end. In base 2, as flash_prefill_tc.cu: blocks
//     that need a mask take x = s c (c = scale log2 e), the reference's
//     -1e30 in base 2 above the diagonal and -inf past S, p = 2^(x - m);
//     the others the raw max times c and p = 2^(s c - m) in one FFMA;
//     m starts at -1e30 in base 2;
//   * causal: key blocks wholly above a warp's rows are skipped. A warp that
//     has already seen key 0 would add 2^(-1e30 log2 e - m) = 0 for them; one
//     that has not (the second key warp of the first tile) keeps m = -1e30
//     and l = 0 and weighs 0 in the merge, as the masked keys do in the
//     reference. Keys above the diagonal inside a block get -1e30;
//   * keys past S (a ragged last tile) are zero-filled and get -inf, causal
//     or not: a padded key never joins the softmax. Query rows past S are
//     not written.
// Shared memory: 189 KB at D = 64, 187 KB at 128, 209 KB at 256: one block
// of four warps an SM; 43 KB at 16 (the reduced configs' head dim): five.
// The launch raises the limit with cudaFuncSetAttribute once a card and
// sizes the grid by the occupancy it then reports.
//
// The tile: FP_BQ query rows an item and BK keys a tile (FpShape<D, BK>).
// Tuning's (block_q, block_k) selects the instance with the largest BK at
// or below block_k (flash_prefill.py instance): at D = 64 keys tiles of 128
// (the builtin) or 64 (four row warps, as at D = 128: 90 KB); at 128 and
// 256 the one each; at 16 keys tiles of 64 (four row warps, 43 KB; 128
// keys would put 76 KB of P beside 2 stages for no fewer tile steps at the
// short sequences of the reduced configs). Query rows stay FP_BQ: two
// items' Q would not fit beside the ring.
#include <math_constants.h>

#include "attention.cuh"
#include "tensor_core.cuh"

// The checked build (-DFP_CHECK_BOUNDS; flash_prefill.py out_of_bounds):
// every cp.async source that reads (a copy of 0 bytes reads nothing), every
// output store and the ticket's atomics are held against the byte ranges of
// the launch's operands (q, k, v, the output and the ticket), which the host
// sets before it (flash_prefill_check_set). An access outside them is not
// made (a copy zero-fills, a store is dropped) but counted, and the first
// FP_CHECK_RECORDS are kept as (address, bytes, source line)
// (flash_prefill_check_get). The kernel is otherwise this one: the same
// instances, tiles and launch shapes.
#ifdef FP_CHECK_BOUNDS
#define FP_CHECK_RANGES 8
#define FP_CHECK_RECORDS 64
__device__ unsigned long long fp_check_lo[FP_CHECK_RANGES];
__device__ unsigned long long fp_check_hi[FP_CHECK_RANGES];
__device__ int fp_check_n;
__device__ unsigned fp_check_count;
__device__ unsigned long long fp_check_rec[FP_CHECK_RECORDS][3];

__device__ __noinline__ void fp_check_fail(const void* p, int bytes,
                                           int line) {
  const unsigned k = atomicAdd(&fp_check_count, 1u);
  if (k < FP_CHECK_RECORDS) {
    fp_check_rec[k][0] = (unsigned long long)p;
    fp_check_rec[k][1] = (unsigned long long)bytes;
    fp_check_rec[k][2] = (unsigned long long)line;
  }
}

__device__ __forceinline__ bool fp_check(const void* p, int bytes, int line) {
  const unsigned long long a = (unsigned long long)p;
  for (int i = 0; i < fp_check_n; ++i)
    if (a >= fp_check_lo[i] && a + bytes <= fp_check_hi[i]) return true;
  fp_check_fail(p, bytes, line);
  return false;
}

__device__ __forceinline__ void fp_checked_cp16(void* dst, const void* src,
                                                int n, int line) {
  cp_async16(dst, src, n == 0 || fp_check(src, 16, line) ? n : 0);
}

#define cp_async16(d, s, n) fp_checked_cp16((d), (s), (n), __LINE__)
#define FP_ST(p) fp_check((p), sizeof(*(p)), __LINE__)

// The operands' byte ranges [lo, hi) of the next launch, and a zero count.
extern "C" int flash_prefill_check_set(const unsigned long long* lo,
                                       const unsigned long long* hi, int n) {
  if (n < 0 || n > FP_CHECK_RANGES) return (int)cudaErrorInvalidValue;
  const unsigned zero = 0;
  cudaError_t e = cudaMemcpyToSymbol(fp_check_lo, lo, 8 * n);
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(fp_check_hi, hi, 8 * n);
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(fp_check_n, &n, sizeof(int));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(fp_check_count, &zero, sizeof(unsigned));
  // landed before the launch, whatever stream it takes
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return (int)e;
}

// The last launch's count of accesses outside the ranges and its records
// (FP_CHECK_RECORDS x 3 words), after the launch has finished.
extern "C" int flash_prefill_check_get(unsigned* count,
                                       unsigned long long* rec) {
  cudaError_t e =
      cudaMemcpyFromSymbol(count, fp_check_count, sizeof(unsigned));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(rec, fp_check_rec, sizeof(fp_check_rec));
  return (int)e;
}
#else
#define FP_ST(p) true
#endif

#define FP_BQ 64            // query rows an item
#define FP_STAGES 2         // ring depth: one tile in flight while one computes
#define FP_NEG (-1e30f)     // the reference's mask value and initial max
#define FP_MAX_DEVICES 64

// ROW_WARPS x KEY_WARPS warps; BK keys a tile. An instance a specialization;
// the first at each D is its builtin tile.
template <int D, int BK_>
struct FpShape;
template <>
struct FpShape<64, 128> {
  static constexpr int ROW_WARPS = 2, KEY_WARPS = 2, BK = 128;
};
template <>
struct FpShape<64, 64> {
  static constexpr int ROW_WARPS = 4, KEY_WARPS = 1, BK = 64;
};
template <>
struct FpShape<128, 64> {
  static constexpr int ROW_WARPS = 4, KEY_WARPS = 1, BK = 64;
};
template <>
struct FpShape<256, 32> {
  static constexpr int ROW_WARPS = 4, KEY_WARPS = 1, BK = 32;
};
template <>
struct FpShape<16, 64> {
  static constexpr int ROW_WARPS = 4, KEY_WARPS = 1, BK = 64;
};

template <int D, int BK_>
struct FpTile : FpShape<D, BK_> {
  using Sh = FpShape<D, BK_>;
  static constexpr int WARPS = Sh::ROW_WARPS * Sh::KEY_WARPS;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int RW = FP_BQ / Sh::ROW_WARPS;  // query rows a warp
  static constexpr int KW = Sh::BK / Sh::KEY_WARPS;  // keys a warp a tile
  static constexpr int TM = RW / 4;                  // rows a thread
  static constexpr int TN = KW / 8;                  // keys a thread
  static constexpr int D4 = D / 4;
  // in P . V a row's 8 lanes own CL float4 columns (8; D4 = 4 at D = 16),
  // KH lanes a column, each taking every KH-th key; TC float4s a lane
  static constexpr int CL = D4 < 8 ? D4 : 8;
  static constexpr int KH = 8 / CL;
  static constexpr int TC = D4 / CL;
  // Q and K rows: D + 4 floats, so the 8 key lanes of a float4 load sit on
  // distinct 16-byte bank groups; V rows are read one at a time (D floats)
  static constexpr int KS4 = D4 + 1;
  static constexpr int PS = RW + 4;  // P^T rows (a key's RW rows + pad)
  static constexpr int STAGE4 = Sh::BK * KS4 + Sh::BK * D4;  // float4s
  static constexpr int Q4 = FP_BQ * KS4;
  static constexpr int P4 = WARPS * KW * PS / 4;
  static constexpr int SMEM = 16 * (Q4 + FP_STAGES * STAGE4 + P4);
  // the key warps' merge reuses the ring: [ROW_WARPS][RW][D + 4] floats
  static_assert(Sh::KEY_WARPS == 1 ||
                    FP_BQ * (D + 4) <= 4 * FP_STAGES * STAGE4, "merge area");
  static_assert(TM % 4 == 0, "P^T float4s");
  static_assert(D4 >= 4 && D4 % CL == 0, "column groups");
  static_assert(Sh::KEY_WARPS == 1 || KH == 1, "merge columns");
};

// Item n of the ticket order: query tile T - 1 - n / (H B), then batch row
// and head (n % (H B) = b H + h). flash_prefill.py work_order repeats it.
__device__ __forceinline__ void fp_item(int n, int T, int H, int B, int& tile,
                                        int& h, int& b) {
  const int per_tile = H * B;
  tile = T - 1 - n / per_tile;
  const int r = n % per_tile;
  b = r / H;
  h = r % H;
}

// One tile's online softmax of a thread's TM rows x TN keys (keys key0 +
// 8 j, rows row0 + i; a row's other keys in the lanes xor 1, 2, 4), in base
// 2 with c = scale log2 e > 0. MASK: x = s c, -1e30 above the diagonal
// (causal), -inf past S, p = 2^(x - m). Without a mask: the max of the raw
// scores times c (the same value: rounding is monotonic), p = 2^(s c - m)
// in one FFMA, as flash_prefill_tc.cu. Leaves p in sc, sets m, alpha (the
// rescale of what came before) and this lane's share of l.
template <int TM, int TN, bool MASK>
__device__ __forceinline__ void fp_softmax(float (&sc)[TM][TN], float (&m)[TM],
                                           float (&l)[TM], float (&alpha)[TM],
                                           float c, int key0, int row0, int S,
                                           int causal) {
  constexpr float NEG_L2 = FP_NEG * TC_LOG2E;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      if (MASK) {
        const int key = key0 + 8 * j;
        float x = __fmul_rn(sc[i][j], c);
        if (key >= S) x = -CUDART_INF_F;
        else if (causal && key > row0 + i) x = NEG_L2;
        sc[i][j] = x;
      }
      mx = fmaxf(mx, sc[i][j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    if (!MASK) mx = __fmul_rn(mx, c);
    mx = fmaxf(m[i], mx);
    alpha[i] = ex2(__fsub_rn(m[i], mx));
    m[i] = mx;
    l[i] = __fmul_rn(l[i], alpha[i]);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      sc[i][j] = MASK ? ex2(__fsub_rn(sc[i][j], mx))
                      : ex2(__fmaf_rn(sc[i][j], c, -mx));
      l[i] = __fadd_rn(l[i], sc[i][j]);
    }
  }
}

// Persistent grid of FpTile<D, BK>::THREADS-thread blocks; ticket[0] the
// next item, ticket[1] the blocks that have left (both 0 between launches).
template <int D, int BK_>
__global__ void __launch_bounds__(FpTile<D, BK_>::THREADS, 1)
    flash_prefill_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    int* __restrict__ ticket, int B, int H, int KV, int S, int causal,
    float scale_log2) {
  using Tl = FpTile<D, BK_>;
  constexpr int BK = Tl::BK, KW = Tl::KW, RW = Tl::RW, TM = Tl::TM,
                TN = Tl::TN, TC = Tl::TC, D4 = Tl::D4, KS4 = Tl::KS4,
                PS = Tl::PS, ROW_WARPS = Tl::ROW_WARPS, NT = Tl::THREADS,
                CL = Tl::CL, KH = Tl::KH;
  constexpr float NEG_L2 = FP_NEG * TC_LOG2E;  // -1e30 in base 2
  extern __shared__ float4 smem4[];
  float4* q_s = smem4;                         // [FP_BQ][KS4], swizzled
  float4* ring = q_s + Tl::Q4;                 // stages of K [BK][KS4], V [BK][D4]
  float* p_all = reinterpret_cast<float*>(ring + FP_STAGES * Tl::STAGE4);
  __shared__ int item_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rw = warp % ROW_WARPS, kw = warp / ROW_WARPS;
  const int rg = lane >> 3, cg = lane & 7;  // row group, key / column group
  // P . V: this lane's float4 columns col + CL c, its keys kp + KH n
  const int col = KH == 1 ? cg : cg % CL, kp = KH == 1 ? 0 : cg / CL;
  float* p_s = p_all + warp * KW * PS;      // this warp's P^T [KW][PS]
  const int T = (S + FP_BQ - 1) / FP_BQ;
  const int n_items = T * H * B;
  const int G = H / KV;
  // this thread's rows in the item: rw RW + rg TM + i; Q row r is stored
  // with its float4 column c at c ^ ((r / TM) & 3) = c ^ rg, so the four
  // row groups of a warp read four bank groups
  const int row0 = rw * RW + rg * TM;

  for (;;) {
    __syncthreads();  // the previous item's shared memory is consumed
    if (tid == 0) item_s = FP_ST(ticket) ? atomicAdd(ticket, 1) : n_items;
    __syncthreads();
    const int item = item_s;
    if (item >= n_items) break;
    int tile, h, b;
    fp_item(item, T, H, B, tile, h, b);
    const int q0 = tile * FP_BQ;
    const int kvh = h / G;
    const float* qm = q + ((long long)b * H + h) * S * D;
    const float* km = k + ((long long)b * KV + kvh) * S * D;
    const float* vm = v + ((long long)b * KV + kvh) * S * D;
    const int k_end = causal ? min(S, q0 + FP_BQ) : S;
    const int ntiles = (k_end + BK - 1) / BK;

    // Q (rows past S zero) with tile 0, then tile 1
    for (int c = tid; c < FP_BQ * D4; c += NT) {
      const int r = c / D4, c4 = c % D4;
      const bool ok = q0 + r < S;
      cp_async16(q_s + r * KS4 + (c4 ^ ((r / TM) & 3)),
                 qm + (long long)(ok ? q0 + r : 0) * D + c4 * 4, ok ? 16 : 0);
    }
    auto load = [&](int t) {
      float4* ks = ring + (t % FP_STAGES) * Tl::STAGE4;
      float4* vs = ks + BK * KS4;
      const int k0 = t * BK;
      for (int c = tid; c < BK * D4; c += NT) {
        const int r = c / D4, c4 = c % D4;
        const bool ok = k0 + r < S;
        const long long off = (long long)(ok ? k0 + r : 0) * D + c4 * 4;
        cp_async16(ks + r * KS4 + c4, km + off, ok ? 16 : 0);
        cp_async16(vs + r * D4 + c4, vm + off, ok ? 16 : 0);
      }
    };
#pragma unroll
    for (int t = 0; t < FP_STAGES - 1; ++t) {
      if (t < ntiles) load(t);
      cp_async_commit();
    }

    float4 acc[TM][TC];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int c = 0; c < TC; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
    float m[TM], l[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      m[i] = NEG_L2;
      l[i] = 0.0f;  // this lane's share: its keys' p
    }
    // the last query row of this warp, for the causal skip
    const int warp_last_row = q0 + rw * RW + RW - 1;

    for (int t = 0; t < ntiles; ++t) {
      cp_async_wait<FP_STAGES - 2>();
      __syncthreads();  // tile t is in; tile t - 1's stage is free
      if (t + FP_STAGES - 1 < ntiles) load(t + FP_STAGES - 1);
      cp_async_commit();
      const float4* ks = ring + (t % FP_STAGES) * Tl::STAGE4;
      const float4* vs = ks + BK * KS4;
      const int kb = kw * KW;      // this warp's keys in the tile
      const int key0 = t * BK + kb;
      if (key0 >= S || (causal && key0 > warp_last_row)) continue;

      // scores of rows row0 + i, keys kb + cg + 8 j
      float sc[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) sc[i][j] = 0.0f;
#pragma unroll 2
      for (int d4 = 0; d4 < D4; ++d4) {
        float4 qv[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) qv[i] = q_s[(row0 + i) * KS4 + (d4 ^ rg)];
        // two keys at a time, component by component: a score's four
        // FMAs (in dot4's order) stand 2 TM FMAs apart, past the latency
#pragma unroll
        for (int j = 0; j < TN; j += 2) {
          const float4 k0 = ks[(kb + cg + 8 * j) * KS4 + d4];
          const float4 k1 = ks[(kb + cg + 8 * j + 8) * KS4 + d4];
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            sc[i][j] = __fmaf_rn(qv[i].x, k0.x, sc[i][j]);
            sc[i][j + 1] = __fmaf_rn(qv[i].x, k1.x, sc[i][j + 1]);
          }
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            sc[i][j] = __fmaf_rn(qv[i].y, k0.y, sc[i][j]);
            sc[i][j + 1] = __fmaf_rn(qv[i].y, k1.y, sc[i][j + 1]);
          }
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            sc[i][j] = __fmaf_rn(qv[i].z, k0.z, sc[i][j]);
            sc[i][j + 1] = __fmaf_rn(qv[i].z, k1.z, sc[i][j + 1]);
          }
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            sc[i][j] = __fmaf_rn(qv[i].w, k0.w, sc[i][j]);
            sc[i][j + 1] = __fmaf_rn(qv[i].w, k1.w, sc[i][j + 1]);
          }
        }
      }
      // the online softmax in base 2 over the warp's keys
      float alpha[TM];
      if (key0 + KW > S || (causal && key0 + KW - 1 > q0 + rw * RW))
        fp_softmax<TM, TN, true>(sc, m, l, alpha, scale_log2, key0 + cg,
                                 q0 + row0, S, causal);
      else
        fp_softmax<TM, TN, false>(sc, m, l, alpha, scale_log2, key0 + cg,
                                  q0 + row0, S, causal);
      // P^T: key kb' = cg + 8 j, rows rg TM + i as float4s
      __syncwarp();  // the previous tile's P . V has read p_s
#pragma unroll
      for (int j = 0; j < TN; ++j)
#pragma unroll
        for (int i = 0; i < TM; i += 4)
          *reinterpret_cast<float4*>(p_s + (cg + 8 * j) * PS + rg * TM + i) =
              make_float4(sc[i][j], sc[i + 1][j], sc[i + 2][j], sc[i + 3][j]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int c = 0; c < TC; ++c) acc[i][c] = scale4(acc[i][c], alpha[i]);
      __syncwarp();
      // acc[i][c] += sum_key p[row i][key] v[key][float4 col + CL c]
#pragma unroll 4
      for (int kk = kp; kk < KW; kk += KH) {
        float p[TM];
#pragma unroll
        for (int i = 0; i < TM; i += 4) {
          const float4 p4 =
              *reinterpret_cast<const float4*>(p_s + kk * PS + rg * TM + i);
          p[i] = p4.x;
          p[i + 1] = p4.y;
          p[i + 2] = p4.z;
          p[i + 3] = p4.w;
        }
        float4 vv[TC];
#pragma unroll
        for (int c = 0; c < TC; ++c) vv[c] = vs[(kb + kk) * D4 + col + CL * c];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int c = 0; c < TC; ++c) acc[i][c] = axpy4(p[i], vv[c], acc[i][c]);
      }
    }

    // the row sums: each lane holds its keys' share
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      l[i] = __fadd_rn(l[i], __shfl_xor_sync(0xffffffffu, l[i], 1));
      l[i] = __fadd_rn(l[i], __shfl_xor_sync(0xffffffffu, l[i], 2));
      l[i] = __fadd_rn(l[i], __shfl_xor_sync(0xffffffffu, l[i], 4));
    }
    // the lanes that share a column add their keys' halves
    if constexpr (KH > 1) {
      static_assert(KH == 2, "one shuffle a pair");
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int c = 0; c < TC; ++c) {
          float4& a = acc[i][c];
          a.x = __fadd_rn(a.x, __shfl_xor_sync(0xffffffffu, a.x, CL));
          a.y = __fadd_rn(a.y, __shfl_xor_sync(0xffffffffu, a.y, CL));
          a.z = __fadd_rn(a.z, __shfl_xor_sync(0xffffffffu, a.z, CL));
          a.w = __fadd_rn(a.w, __shfl_xor_sync(0xffffffffu, a.w, CL));
        }
    }
    float* om = out + ((long long)b * H + h) * S * D;
    if constexpr (Tl::KEY_WARPS == 1) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int row = q0 + row0 + i;
        if (row >= S || kp != 0) continue;
        const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
        for (int c = 0; c < TC; ++c) {
          const float4 a = acc[i][c];
          float4* dst = reinterpret_cast<float4*>(
              om + (long long)row * D + (col + CL * c) * 4);
          if (FP_ST(dst))
            *dst = make_float4(__fdiv_rn(a.x, den), __fdiv_rn(a.y, den),
                               __fdiv_rn(a.z, den), __fdiv_rn(a.w, den));
        }
      }
    } else {
      // the second key warp of each row set hands (m, l, acc) to the first
      // through the ring, which the first merges and writes
      cp_async_wait<0>();
      __syncthreads();  // the ring is free
      float* red = reinterpret_cast<float*>(ring);  // [FP_BQ][D + 4]
      if (kw == 1) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          float* rr = red + (row0 + i) * (D + 4);
#pragma unroll
          for (int c = 0; c < TC; ++c)
            *reinterpret_cast<float4*>(rr + (cg + 8 * c) * 4) = acc[i][c];
          if (cg == 0) {
            rr[D] = m[i];
            rr[D + 1] = l[i];
          }
        }
      }
      __syncthreads();
      if (kw == 0) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int row = q0 + row0 + i;
          if (row >= S) continue;
          const float* rr = red + (row0 + i) * (D + 4);
          const float m1 = rr[D], l1 = rr[D + 1];
          const float mm = fmaxf(m[i], m1);
          const float f0 = ex2(__fsub_rn(m[i], mm));
          const float f1 = ex2(__fsub_rn(m1, mm));
          const float den = fmaxf(
              __fadd_rn(__fmul_rn(f0, l[i]), __fmul_rn(f1, l1)), 1e-30f);
#pragma unroll
          for (int c = 0; c < TC; ++c) {
            const float4 a = acc[i][c];
            const float4 o = *reinterpret_cast<const float4*>(
                rr + (cg + 8 * c) * 4);
            float4* dst = reinterpret_cast<float4*>(
                om + (long long)row * D + (cg + 8 * c) * 4);
            if (FP_ST(dst)) *dst = make_float4(
                __fdiv_rn(__fadd_rn(__fmul_rn(f0, a.x), __fmul_rn(f1, o.x)), den),
                __fdiv_rn(__fadd_rn(__fmul_rn(f0, a.y), __fmul_rn(f1, o.y)), den),
                __fdiv_rn(__fadd_rn(__fmul_rn(f0, a.z), __fmul_rn(f1, o.z)), den),
                __fdiv_rn(__fadd_rn(__fmul_rn(f0, a.w), __fmul_rn(f1, o.w)), den));
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  // the last block to leave resets the ticket for the next launch
  if (tid == 0 && FP_ST(ticket + 1)) {
    __threadfence();
    if (atomicAdd(ticket + 1, 1) == (int)gridDim.x - 1) {
      atomicExch(ticket, 0);
      atomicExch(ticket + 1, 0);
    }
  }
}

template <int D, int BK>
static int fp_instance(const float* q, const float* k, const float* v,
                       float* out, int* ticket, int B, int H, int KV, int S,
                       int causal, float scale, cudaStream_t stream) {
  constexpr int smem = FpTile<D, BK>::SMEM;
  // blocks that fit on each card at once (0 until its first launch)
  static int slots[FP_MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= FP_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (slots[dev] == 0) {
    err = cudaFuncSetAttribute(flash_prefill_kernel<D, BK>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, flash_prefill_kernel<D, BK>, FpTile<D, BK>::THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    slots[dev] = per_sm * sms;
  }
  const long long items = (long long)((S + FP_BQ - 1) / FP_BQ) * H * B;
  const int grid = (int)(items < slots[dev] ? items : slots[dev]);
  flash_prefill_kernel<D, BK>
      <<<grid, FpTile<D, BK>::THREADS, smem, stream>>>(
          q, k, v, out, ticket, B, H, KV, S, causal, scale * TC_LOG2E);
  return (int)cudaGetLastError();
}

// float32 q (B, H, S, D), k / v (B, KV, S, D); D in {16, 64, 128, 256};
// H % KV == 0; S >= 1. ticket: two ints, 0 between launches, used by one
// stream at a time. bk: keys a tile of an instance at D (FpShape), last.
extern "C" int flash_prefill_launch(const float* q, const float* k,
                                    const float* v, float* out, int* ticket,
                                    int B, int H, int KV, int S, int D,
                                    int causal, float scale, void* stream,
                                    int bk) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64 && bk == 128)
    return fp_instance<64, 128>(q, k, v, out, ticket, B, H, KV, S, causal,
                                scale, s);
  if (D == 64 && bk == 64)
    return fp_instance<64, 64>(q, k, v, out, ticket, B, H, KV, S, causal,
                               scale, s);
  if (D == 128 && bk == 64)
    return fp_instance<128, 64>(q, k, v, out, ticket, B, H, KV, S, causal,
                                scale, s);
  if (D == 256 && bk == 32)
    return fp_instance<256, 32>(q, k, v, out, ticket, B, H, KV, S, causal,
                                scale, s);
  if (D == 16 && bk == 64)
    return fp_instance<16, 64>(q, k, v, out, ticket, B, H, KV, S, causal,
                               scale, s);
  return (int)cudaErrorInvalidValue;
}
