// Causal GQA flash attention (prefill), sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention/kernel.py:
// flash_attention (_flash_kernel; public wrapper ops.mha).  Layout is the
// wrapper's: q (B, S, H, D), k/v (B, S, KV, D), out (B, S, H, D),
// H % KV == 0, and the KV head of query head h is h / (H / KV).  The scale
// is the true 1/sqrt(D): the TPU wrapper's padded-D rescale is not carried
// over.
//
// Bound on the H100: 4 * B * H * D * S(S+1)/2 causal operations against
// 2 * B * S * (H + KV) * D * itemsize bytes.  At prompt length it is bound
// by operations (olmo-1b's prefill, B = 4, S = 1024, 16 heads of 128:
// 17.2 G operations, 0.017 ms at 989 TFLOP/s bf16); at the serving
// request's S = 64 by bytes (0.3 us), far below the cost of a launch.
//
// Two routes, chosen by dtype, neither a fallback of the other:
//
// bfloat16 -- tensor cores (flash_fwd_bf16), FlashAttention-2's shape.
//   One CTA of 4 warps per (64-row query tile, head, batch); each warp owns
//   16 query rows.  The grid walks query tiles last to first, so the
//   longest causal rows start first.  Q is staged once in shared memory and
//   read as mma A fragments (ldmatrix) at each k-step: holding them in
//   registers instead spills at D = 128.  K and V
//   come in 64-row tiles by 16-byte cp.async into a two-stage ring: the
//   next tile is in flight while this one computes.  Rows are padded by 8
//   elements (16 bytes), so the 8 rows an ldmatrix phase reads fall on 8
//   distinct 16-byte bank groups for every D taken.  S = Q K^T is
//   mma.sync m16n8k16 bf16 -> f32 (D/16 k-steps, 8 n-tiles a warp) and
//   stays in registers.  The online softmax runs on them in f32: row max
//   and sum reduced over the lane quad by shuffles, exp2 with
//   scale * log2(e) folded in; the causal mask and the keys past S apply
//   only on the tiles that reach them (with BQ == BK, the diagonal tile
//   and the tile holding S - 1).  The S accumulator layout is reused as the
//   A fragment of P V, 16 keys at a time; V's B fragments come from
//   ldmatrix.trans.  O accumulates in f32 registers, is divided by the row
//   sum, rounded to bf16, staged in the Q buffer and written with 16-byte
//   stores.
//
//   P precision: P is split into kPParts = 3 bf16 parts, each the bf16
//   rounding of what the parts before it leave (24 bits of P, float32's),
//   and P V is three products: twice the operations of one bf16 P.  The
//   TPU kernel rounds P to bf16 once (p.astype(v.dtype), kernel.py:50), and
//   so did this kernel at first: on the H100 that flipped the bf16 rounding
//   of a large share of the outputs against the float32 plain version and
//   moved olmo-1b's prefill logits past chip_smoke.py's four-ulp gate
//   (random weights amplify each flipped rounding).  Two parts (16 bits)
//   passed it with no margin; three halve the flips again.  The row sum
//   adds the unsplit float32 P.  PERF.md has the readings.
//
// float32 -- CUDA cores (flash_fwd_f32), the first port's kernel.  TF32
//   would keep about three decimal digits, and the float32 paths are the
//   precision checks (2e-5), so float32 stays on scalar FMAs: one CTA of
//   256 threads per (64-row query tile, head, batch), Q and K/V tiles in
//   shared memory as float32 (rows padded by one float), four lanes per
//   query row splitting its 64 scores and a quarter of its accumulator.
//
// Both forward routes write, when given a non-null pointer, each query
// row's log-sum-exp over its scaled scores (float32, (B, H, S)): the
// backward recomputes P from it.  Serving passes null and writes none.
//
// Backward (flash_attention_bwd), for training.  The TPU package has no
// backward kernel: JAX differentiates its plain chunked attention, so the
// gradient to match is exact softmax attention's (autograd of the plain
// version).  Bound on the H100 (olmo-1b's training shape, B = 4, S = 1024,
// 16 heads of 128, bf16): five causal products (S and dP recomputed, dV,
// dK, dQ), 43 G operations, 0.044 ms at 989 TFLOP/s, against about 134
// MB of traffic (q, k, v, o, dO read, dq, dk, dv written, the LSE and
// delta), 0.040 ms.  On both routes P and dS keep float32's 24 bits: the
// forward showed that one bfloat16 P moves outputs past a four-ulp gate,
// and dS = P (dP - delta) is a difference of near-equal terms.  Both
// routes use no atomics and sum in a fixed order, so two calls on the same
// inputs give the same bytes (GQA's dK and dV are summed over the G query
// heads inside one CTA).  Each output is rounded once.  flash_bwd_delta
// runs first on both: delta = rowsum(dO * O), one warp per query row.
//
// bfloat16 -- tensor cores, FlashAttention-2's backward on mma.sync:
//   * flash_bwd_dkdv_bf16: one CTA of 4 warps per (KV head, batch, 64-key
//     tile); the first key tiles, which the causal mask leaves the most
//     query tiles, start first.  Each warp owns 16 keys.  K and V are bf16
//     in shared memory, padded as the forward's tiles, and this warp's
//     rows of them are the A fragments of S^T = K Q^T and dP^T = V dO^T:
//     with keys as rows, P^T and dS^T come out of the accumulators in the
//     layout dV += P^T dO and dK += dS^T Q take as A, so no accumulator is
//     transposed.  The CTA walks the G query heads of its KV head and the
//     query tiles the mask keeps; each tile's Q, dO, lse and delta arrive
//     by cp.async into a two-stage ring, the next in flight while this
//     one computes.  S^T and dP^T are m16n8k16 bf16 -> f32 products
//     (exact products, float32 sums).  P^T = exp2(S^T scale log2(e) -
//     lse log2(e)) and dS^T = P^T (dP^T - delta) are formed in float32
//     registers, the causal mask and the rows past S applied only on the
//     tiles that reach them (a warp skips a half whose queries all precede
//     its keys).  Each is then split into kPParts = 3 bf16 parts, each the
//     bf16 rounding of what the parts before it leave, as the forward
//     splits P: three mma for each of dV and dK, and nothing goes through
//     shared memory.  dO's and Q's B fragments come from ldmatrix.trans.
//     dK and dV stay in float32 registers until one rounded write,
//     through the warp's own rows of sK and sV, then 16-byte stores.
//     Registers at D = 128: the dK and dV accumulators alone take 128 a
//     thread, and S^T and dP^T of a 64-query tile 64 more, so each query
//     tile is taken in halves of kQSub = 32 queries: 255 registers, no
//     spills (ptxas); the smaller head dims take the whole tile (160, 230
//     and 248 registers at D = 32, 64, 80, no spills).
//   * flash_bwd_dq_bf16: one CTA of 4 warps per (head, batch, 64-query
//     tile), longest rows first; each warp owns 16 query rows.  Q and dO
//     are staged once and read as A fragments (ldmatrix); K and V tiles
//     come through the cp.async ring as B fragments.  S and dP on the
//     tensor cores, P and dS in float32, dS split into three parts as the
//     A fragment of dQ += dS K (K through ldmatrix.trans); dQ scaled and
//     rounded once, through the warp's own rows of sQ (242 registers at
//     D = 128, no spills).
//   Thirteen causal products in all (S and dP in each kernel, dV, dK and
//   dQ at three parts each), 2.6 times the bound's five.  Each kernel
//   takes about 105 KB of shared memory at D = 128: two CTAs an SM.
//
// float32 -- CUDA cores, the first backward's kernels: TF32 would keep
//   about three decimal digits, and the float32 route is the 2e-5
//   precision check, so every product runs on scalar FMAs:
//   * flash_bwd_dkdv_f32: one CTA of 256 threads per (KV head, batch,
//     64-key tile).  K and V stay in shared memory; the CTA walks the G
//     query heads of its KV head and the query tiles the causal mask
//     keeps, recomputes S = Q K^T and dP = dO V^T (a 4 x 4 register tile
//     a thread), P = exp(S - lse) and dS = P (dP - delta), and accumulates
//     dV += P^T dO and dK += dS^T Q in registers (4 keys x D/16 columns a
//     thread) until one write;
//   * flash_bwd_dq_f32: one CTA per (head, batch, 64-query tile), walking
//     its key tiles, dQ += dS K in registers.
//   Tiles are float32 in shared memory, rows padded by one float so the
//   16 keys a warp reads at one column fall on 16 banks.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

using cp_async::smem_addr;

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kPParts = 3;               // bf16 parts P is split into

// -- float32: CUDA-core FMAs --------------------------------------------------

constexpr int kF32Threads = 256;

template <int D>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) *
         (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int S, int H, int KV, float scale,
              int causal) {
  constexpr int LQ = D + 1;        // padded row of sQ / sK
  constexpr int LP = kBK + 1;      // padded row of sP
  constexpr int NC = D / 4;        // accumulator columns per thread
  constexpr int NS = kBK / 4;      // scores per thread per tile
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * LQ;
  float* sV = sK + kBK * LQ;
  float* sP = sV + kBK * D;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int r = tid >> 2;          // query row of this thread in the tile
  const int sub = tid & 3;         // lane within the row's quad
  const int q0 = qt * kBQ;
  const int64_t q_row = static_cast<int64_t>(H) * D;
  const int64_t kv_row = static_cast<int64_t>(KV) * D;
  const float* qb = q + static_cast<int64_t>(b) * S * q_row + h * D;
  const float* kb = k + static_cast<int64_t>(b) * S * kv_row + kvh * D;
  const float* vb = v + static_cast<int64_t>(b) * S * kv_row + kvh * D;

  for (int e = tid; e < kBQ * D; e += kF32Threads) {
    const int rr = e / D, d = e % D, s = q0 + rr;
    sQ[rr * LQ + d] = s < S ? qb[s * q_row + d] * scale : 0.f;
  }

  float m = -INFINITY, l = 0.f;
  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.f;

  const int qpos = q0 + r;
  const int n_kv = (S + kBK - 1) / kBK;
  const int kv_end = causal ? min(n_kv, qt + 1) : n_kv;  // kBQ == kBK
  for (int kt = 0; kt < kv_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();               // previous tile's sK/sV/sP reads are done
    for (int e = tid; e < kBK * D; e += kF32Threads) {
      const int rr = e / D, d = e % D, s = k0 + rr;
      const bool in = s < S;
      sK[rr * LQ + d] = in ? kb[s * kv_row + d] : 0.f;
      sV[rr * D + d] = in ? vb[s * kv_row + d] : 0.f;
    }
    __syncthreads();

    float sc[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) sc[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = sQ[r * LQ + d];
#pragma unroll
      for (int j = 0; j < NS; ++j) sc[j] += qd * sK[(sub + 4 * j) * LQ + d];
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int kpos = k0 + sub + 4 * j;
      const bool ok = kpos < S && (!causal || kpos <= qpos);
      sc[j] = ok ? sc[j] : -INFINITY;
      mx = fmaxf(mx, sc[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    // a row with every key masked so far keeps m = -inf: nothing to rescale
    const float corr = m_new == -INFINITY ? 1.f : expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float p = sc[j] == -INFINITY ? 0.f : expf(sc[j] - m_new);
      sP[r * LP + sub + 4 * j] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] *= corr;
    __syncwarp();                  // the row's quad reads what it just wrote
    for (int kk = 0; kk < kBK; ++kk) {
      const float p = sP[r * LP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[c] += p * sV[kk * D + sub + 4 * c];
    }
  }

  if (qpos < S) {
    float* ob = o + static_cast<int64_t>(b) * S * q_row + h * D +
                static_cast<int64_t>(qpos) * q_row;
    const float den = fmaxf(l, 1e-20f);
#pragma unroll
    for (int c = 0; c < NC; ++c) ob[sub + 4 * c] = acc[c] / den;
    // scores were scaled as Q was staged: m is in the scaled units
    if (lse != nullptr && sub == 0)
      lse[(static_cast<int64_t>(b) * H + h) * S + qpos] = m + logf(den);
  }
}

// -- bfloat16: tensor cores -----------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kWarps = kBQ / 16;          // 16 query rows each
constexpr int kThreads = 32 * kWarps;
static_assert(kBQ == kBK, "one tile shape for Q, K and V");

template <int D>
struct Tile {
  static constexpr int kLd = D + 8;       // padded row, elements (16 bytes)
  static constexpr int kElems = kBK * kLd;
  static constexpr int kChunks = D / 8;   // 16-byte chunks of a row
  // Q (reused for the output), then two stages of K and two of V
  static constexpr size_t kSmem = sizeof(bf16) * 5 * kElems;
};

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

// One k-step of an A fragment (16 columns) from two accumulator n-tiles,
// x0 (columns 0-7) and x1 (8-15), split into kPParts bf16 parts, each the
// bf16 rounding of what the parts before it leave.
__device__ __forceinline__ void split_a(const float (&x0)[4],
                                        const float (&x1)[4],
                                        uint32_t (&a)[kPParts][4]) {
  float r[8] = {x0[0], x0[1], x0[2], x0[3], x1[0], x1[1], x1[2], x1[3]};
#pragma unroll
  for (int part = 0; part < kPParts; ++part) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[part][i] = pack_bf16(r[2 * i], r[2 * i + 1]);
      const float2 back = unpack_bf16(a[part][i]);
      r[2 * i] -= back.x;
      r[2 * i + 1] -= back.y;
    }
  }
}

// Rows r0 .. r0 + 63 of a (rows, stride) bf16 matrix into a padded tile;
// rows at or past S are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int64_t stride, int r0, int S,
                                          int tid) {
  using T = Tile<D>;
  static_assert(kBK * T::kChunks % kThreads == 0, "whole chunks a thread");
#pragma unroll
  for (int i = 0; i < kBK * T::kChunks / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / T::kChunks, col = (c % T::kChunks) * 8;
    const bool in = r0 + r < S;
    cp_async::copy16(dst + r * T::kLd + col,
                     src + (in ? (r0 + r) * stride : 0) + col, in);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o,
               float* __restrict__ lse, int S, int H, int KV, float scale_log2,
               int causal) {
  using T = Tile<D>;
  constexpr int Ld = T::kLd;
  constexpr int KS = D / 16;              // k-steps of Q K^T
  constexpr int NT = D / 8;               // n-tiles of P V
  constexpr int SN = kBK / 8;             // n-tiles of S
  static_assert(D % 16 == 0, "head dim a multiple of 16");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + T::kElems;              // stages at sK, sK + kElems
  bf16* sV = sK + 2 * T::kElems;

  const int n_q = (S + kBQ - 1) / kBQ;
  const int qt = n_q - 1 - static_cast<int>(blockIdx.z);   // longest first
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma row group, lane in quad
  const int q0 = qt * kBQ;
  const int wq0 = q0 + warp * 16;         // this warp's first query row
  const int64_t q_row = static_cast<int64_t>(H) * D;
  const int64_t kv_row = static_cast<int64_t>(KV) * D;
  const bf16* qb = q + static_cast<int64_t>(b) * S * q_row + h * D;
  const bf16* kb = k + static_cast<int64_t>(b) * S * kv_row + kvh * D;
  const bf16* vb = v + static_cast<int64_t>(b) * S * kv_row + kvh * D;

  const int n_kv = (S + kBK - 1) / kBK;
  const int kv_end = causal ? min(n_kv, qt + 1) : n_kv;    // kBQ == kBK

  load_tile<D>(sQ, qb, q_row, q0, S, tid);
  load_tile<D>(sK, kb, kv_row, 0, S, tid);
  load_tile<D>(sV, vb, kv_row, 0, S, tid);
  cp_async::commit();

  // ldmatrix row offsets of this lane: A (and V^T) tiles take rows
  // (lane & 7) + 8 * ((lane >> 3) & 1) and column half lane >> 4; K's
  // B tiles take rows (lane & 7) + 8 * (lane >> 4), column half
  // (lane >> 3) & 1.
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 8 * (lane >> 4);
  const int b_row = (lane & 7) + 8 * (lane >> 4), b_col = 8 * ((lane >> 3) & 1);

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};    // rows g and g + 8, raw scores
  float l[2] = {0.f, 0.f};                // this lane's part of the row sum

  for (int kt = 0; kt < kv_end; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < kv_end) {
      load_tile<D>(sK + (st ^ 1) * T::kElems, kb, kv_row, (kt + 1) * kBK, S,
                   tid);
      load_tile<D>(sV + (st ^ 1) * T::kElems, vb, kv_row, (kt + 1) * kBK, S,
                   tid);
    }
    cp_async::commit();
    cp_async::wait<1>();               // tile kt (and Q) have landed
    __syncthreads();
    const int k0 = kt * kBK;
    const bf16* cK = sK + st * T::kElems;
    const bf16* cV = sV + st * T::kElems;

    float s[SN][4];
#pragma unroll
    for (int j = 0; j < SN; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4];
      ldsm_x4(smem_addr(sQ + (warp * 16 + a_row) * Ld + ks * 16 + a_col), qa);
#pragma unroll
      for (int jp = 0; jp < SN / 2; ++jp) {
        uint32_t bk[4];
        ldsm_x4(smem_addr(cK + (jp * 16 + b_row) * Ld + ks * 16 + b_col), bk);
        mma_bf16(s[2 * jp], qa, bk[0], bk[1]);
        mma_bf16(s[2 * jp + 1], qa, bk[2], bk[3]);
      }
    }

    // only the tiles that reach past this warp's first row or past S mask
    if ((causal && k0 + kBK - 1 > wq0) || k0 + kBK > S) {
      const int qr = wq0 + g;
#pragma unroll
      for (int j = 0; j < SN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + j * 8 + 2 * t + (e & 1);
          const int qpos = qr + 8 * (e >> 1);
          if (kpos >= S || (causal && kpos > qpos)) s[j][e] = -INFINITY;
        }
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < SN; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float base[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // a row with every key masked so far keeps max -inf: subtract 0
      base[i] = mx[i] == -INFINITY ? 0.f : mx[i] * scale_log2;
      const float corr = exp2f(m[i] * scale_log2 - base[i]);
      m[i] = mx[i];
      l[i] *= corr;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][2 * i] *= corr;
        acc[n][2 * i + 1] *= corr;
      }
    }

    // P V, 16 keys at a time: P's k-step kk is S's n-tiles 2kk (A
    // fragment registers a0, a1: rows g, g + 8) and 2kk + 1 (a2, a3), split
    // into bf16 parts; each is formed just before its products, so only
    // one k-step of P is live in registers.
#pragma unroll
    for (int kk = 0; kk < SN / 2; ++kk) {
#pragma unroll
      for (int j = 2 * kk; j < 2 * kk + 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = exp2f(fmaf(s[j][e], scale_log2, -base[e >> 1]));
        l[0] += s[j][0] + s[j][1];
        l[1] += s[j][2] + s[j][3];
      }
      uint32_t pf[kPParts][4];
      split_a(s[2 * kk], s[2 * kk + 1], pf);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bv[4];
        ldsm_x4_trans(
            smem_addr(cV + (kk * 16 + a_row) * Ld + np * 16 + a_col), bv);
#pragma unroll
        for (int part = 0; part < kPParts; ++part) {
          mma_bf16(acc[2 * np], pf[part], bv[0], bv[1]);
          mma_bf16(acc[2 * np + 1], pf[part], bv[2], bv[3]);
        }
      }
    }
    __syncthreads();                      // stage st is refilled next
  }

  // the row sums over the quad; the output tile through sQ (a warp writes
  // only its own rows, whose Q it has read for the last time), then
  // 16-byte stores of the rows below S
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = __fdividef(1.f, fmaxf(l[i], 1e-20f));   // no slow-path call
    // lse = ln(sum_j exp(scale * s_j)): the row max m is in raw scores
    const int row = wq0 + g + 8 * i;
    if (lse != nullptr && t == 0 && row < S)
      lse[(static_cast<int64_t>(b) * H + h) * S + row] =
          (m[i] * scale_log2 + log2f(fmaxf(l[i], 1e-20f))) *
          0.6931471805599453f;
  }
  const int orow = warp * 16 + g;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(sQ + orow * Ld + col) =
        pack_bf16(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(sQ + (orow + 8) * Ld + col) =
        pack_bf16(acc[n][2] * inv[1], acc[n][3] * inv[1]);
  }
  __syncthreads();
  bf16* ob = o + static_cast<int64_t>(b) * S * q_row + h * D;
#pragma unroll
  for (int i = 0; i < kBQ * T::kChunks / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / T::kChunks, col = (c % T::kChunks) * 8;
    if (q0 + r < S)
      *reinterpret_cast<uint4*>(ob + (q0 + r) * q_row + col) =
          *reinterpret_cast<const uint4*>(sQ + r * Ld + col);
  }
}

// -- backward: delta, both dtypes ---------------------------------------------

constexpr int kBwdThreads = 256;          // 16 x 16: (row group, column group)
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// delta[b, h, s] = sum_d dO[b, s, h, d] * O[b, s, h, d]: one warp a row.
template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                float* __restrict__ delta, int B, int S, int H) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kBwdThreads / 32) +
                      (threadIdx.x >> 5);       // (b, s, h), h fastest
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<int64_t>(B) * S * H) return;
  const T* orow = o + row * D;
  const T* drow = dout + row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc += to_f32(orow[d]) * to_f32(drow[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = static_cast<int>(row % H);
    const int64_t bs = row / H;
    const int s = static_cast<int>(bs % S), b = static_cast<int>(bs / S);
    delta[(static_cast<int64_t>(b) * H + h) * S + s] = acc;
  }
}

// -- backward, float32: CUDA-core FMAs ------------------------------------------

// Rows r0 .. r0 + 63 of a (rows, stride) matrix into a float32 tile with
// rows of Ld floats; rows at or past S are zero-filled.
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int64_t stride, int r0, int S,
                                           int Ld, int tid) {
  for (int e = tid; e < kBK * D; e += kBwdThreads) {
    const int r = e / D, d = e % D, s = r0 + r;
    dst[r * Ld + d] = s < S ? src[s * stride + d] : 0.f;
  }
}

template <int D>
constexpr size_t bwd_smem_bytes(int n_square) {
  // four (64, D + 1) tiles, n_square (64, 65) tiles, and lse / delta rows
  return sizeof(float) *
         (4 * kBK * (D + 1) + n_square * kBQ * (kBK + 1) + 2 * kBQ);
}

// S = Q K^T and dP = dO V^T for a 64 x 64 tile: rows rg + 16a and keys
// cg + 16c (a, c < 4) of this thread, then P and dS written to shared
// memory (sP may be null: the dQ pass needs dS only).
template <int D>
__device__ __forceinline__ void tile_p_ds(
    const float* sQ, const float* sdO, const float* sK, const float* sV,
    const float* sL, const float* sD, float* sP, float* sdS, int rg, int cg,
    int q0, int k0, int S, int causal, float scale_log2) {
  constexpr int L = D + 1, LP = kBK + 1;
  float sc[4][4], dp[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) sc[a][c] = dp[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qa[4], da[4], kc[4], vc[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qa[a] = sQ[(rg + 16 * a) * L + d];
      da[a] = sdO[(rg + 16 * a) * L + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      kc[c] = sK[(cg + 16 * c) * L + d];
      vc[c] = sV[(cg + 16 * c) * L + d];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sc[a][c] = fmaf(qa[a], kc[c], sc[a][c]);
        dp[a][c] = fmaf(da[a], vc[c], dp[a][c]);
      }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = rg + 16 * a, qpos = q0 + i;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = cg + 16 * c, kpos = k0 + j;
      const bool ok = qpos < S && kpos < S && (!causal || kpos <= qpos);
      // sL holds lse * log2(e): P = exp(scale * s - lse)
      const float p = ok ? exp2f(fmaf(sc[a][c], scale_log2, -sL[i])) : 0.f;
      if (sP != nullptr) sP[i * LP + j] = p;
      sdS[i * LP + j] = p * (dp[a][c] - sD[i]);
    }
  }
}

// lse * log2(e) and delta of query rows q0 .. q0 + 63 (zero past S)
__device__ __forceinline__ void stage_stats(float* sL, float* sD,
                                            const float* lse,
                                            const float* delta, int q0, int S,
                                            int tid) {
  if (tid < kBQ) {
    const int s = q0 + tid;
    sL[tid] = s < S ? lse[s] * kLog2e : 0.f;
    sD[tid] = s < S ? delta[s] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dk, float* __restrict__ dv, int S, int H,
                   int KV, float scale, int causal) {
  constexpr int L = D + 1, LP = kBK + 1, NC = D / 16;
  static_assert(D % 16 == 0, "head dim a multiple of 16");
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kBK * L;
  float* sQ = sV + kBK * L;
  float* sdO = sQ + kBQ * L;
  float* sP = sdO + kBQ * L;
  float* sdS = sP + kBQ * LP;
  float* sL = sdS + kBQ * LP;
  float* sD = sL + kBQ;

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int kt = blockIdx.z;              // causal: the first tiles work most
  const int G = H / KV;
  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int k0 = kt * kBK;
  const int64_t q_row = static_cast<int64_t>(H) * D;
  const int64_t kv_row = static_cast<int64_t>(KV) * D;
  const int64_t kv_off = static_cast<int64_t>(b) * S * kv_row + kvh * D;
  const float scale_log2 = scale * kLog2e;

  stage_rows<D>(sK, k + kv_off, kv_row, k0, S, L, tid);
  stage_rows<D>(sV, v + kv_off, kv_row, k0, S, L, tid);

  // this thread's keys rg + 16a and columns cg + 16c
  float acc_k[4][NC], acc_v[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[a][c] = acc_v[a][c] = 0.f;

  const int n_q = (S + kBQ - 1) / kBQ;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const int64_t q_off = static_cast<int64_t>(b) * S * q_row + h * D;
    const int64_t st_off = (static_cast<int64_t>(b) * H + h) * S;
    for (int qt = causal ? kt : 0; qt < n_q; ++qt) {   // kBQ == kBK
      const int q0 = qt * kBQ;
      __syncthreads();                    // the last tile's reads are done
      stage_rows<D>(sQ, q + q_off, q_row, q0, S, L, tid);
      stage_rows<D>(sdO, dout + q_off, q_row, q0, S, L, tid);
      stage_stats(sL, sD, lse + st_off, delta + st_off, q0, S, tid);
      __syncthreads();
      tile_p_ds<D>(sQ, sdO, sK, sV, sL, sD, sP, sdS, rg, cg, q0, k0, S, causal,
                   scale_log2);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q over the tile's 64 query rows
#pragma unroll 2
      for (int i = 0; i < kBQ; ++i) {
        float pa[4], sa[4], oc[NC], qc[NC];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pa[a] = sP[i * LP + rg + 16 * a];
          sa[a] = sdS[i * LP + rg + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          oc[c] = sdO[i * L + cg + 16 * c];
          qc[c] = sQ[i * L + cg + 16 * c];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            acc_v[a][c] = fmaf(pa[a], oc[c], acc_v[a][c]);
            acc_k[a][c] = fmaf(sa[a], qc[c], acc_k[a][c]);
          }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int s = k0 + rg + 16 * a;
    if (s >= S) continue;
    float* dkr = dk + kv_off + s * kv_row;
    float* dvr = dv + kv_off + s * kv_row;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dkr[cg + 16 * c] = acc_k[a][c] * scale;
      dvr[cg + 16 * c] = acc_v[a][c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dq, int S, int H, int KV, float scale,
                 int causal) {
  constexpr int L = D + 1, LP = kBK + 1, NC = D / 16;
  static_assert(D % 16 == 0, "head dim a multiple of 16");
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kBK * L;
  float* sQ = sV + kBK * L;
  float* sdO = sQ + kBQ * L;
  float* sdS = sdO + kBQ * L;
  float* sL = sdS + kBQ * LP;
  float* sD = sL + kBQ;

  const int n_q = (S + kBQ - 1) / kBQ;
  const int qt = n_q - 1 - static_cast<int>(blockIdx.z);   // longest first
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int q0 = qt * kBQ;
  const int64_t q_row = static_cast<int64_t>(H) * D;
  const int64_t kv_row = static_cast<int64_t>(KV) * D;
  const int64_t q_off = static_cast<int64_t>(b) * S * q_row + h * D;
  const int64_t kv_off = static_cast<int64_t>(b) * S * kv_row + kvh * D;
  const int64_t st_off = (static_cast<int64_t>(b) * H + h) * S;
  const float scale_log2 = scale * kLog2e;

  stage_rows<D>(sQ, q + q_off, q_row, q0, S, L, tid);
  stage_rows<D>(sdO, dout + q_off, q_row, q0, S, L, tid);
  stage_stats(sL, sD, lse + st_off, delta + st_off, q0, S, tid);

  // this thread's rows rg + 16a and columns cg + 16c
  float acc[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = 0.f;

  const int n_kv = (S + kBK - 1) / kBK;
  const int kv_end = causal ? min(n_kv, qt + 1) : n_kv;   // kBQ == kBK
  for (int kt = 0; kt < kv_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                      // the last tile's reads are done
    stage_rows<D>(sK, k + kv_off, kv_row, k0, S, L, tid);
    stage_rows<D>(sV, v + kv_off, kv_row, k0, S, L, tid);
    __syncthreads();
    tile_p_ds<D>(sQ, sdO, sK, sV, sL, sD, nullptr, sdS, rg, cg, q0, k0, S,
                 causal, scale_log2);
    __syncthreads();
    // dQ += dS K over the tile's 64 keys
#pragma unroll 2
    for (int j = 0; j < kBK; ++j) {
      float sa[4], kc[NC];
#pragma unroll
      for (int a = 0; a < 4; ++a) sa[a] = sdS[(rg + 16 * a) * LP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) kc[c] = sK[j * L + cg + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[a][c] = fmaf(sa[a], kc[c], acc[a][c]);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int s = q0 + rg + 16 * a;
    if (s >= S) continue;
    float* dqr = dq + q_off + s * q_row;
#pragma unroll
    for (int c = 0; c < NC; ++c) dqr[cg + 16 * c] = acc[a][c] * scale;
  }
}

// -- backward, bfloat16: tensor cores ------------------------------------------

template <int D>
struct BwdTile {
  using T = Tile<D>;
  // queries of S^T and dP^T a dK/dV warp holds at once: at D = 128 the dK
  // and dV accumulators take 128 registers a thread, so the 64-query tile
  // is taken in halves
  static constexpr int kQSub = D >= 128 ? 32 : kBQ;
  // dK/dV: K and V, two stages of Q and dO, two stages of lse and delta
  static constexpr size_t kSmemKV =
      sizeof(bf16) * 6 * T::kElems + sizeof(float) * 4 * kBQ;
  // dQ: Q and dO, two stages of K and V
  static constexpr size_t kSmemQ = sizeof(bf16) * 6 * T::kElems;
};
static_assert(kThreads == 2 * kBQ, "one thread a row of lse or delta");

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int S, int H, int KV, float scale,
                    int causal) {
  using T = Tile<D>;
  constexpr int Ld = T::kLd;
  constexpr int KS = D / 16;              // k-steps of K Q^T and V dO^T
  constexpr int NT = D / 8;               // n-tiles of dK and dV
  constexpr int QS = BwdTile<D>::kQSub;
  constexpr int SN = QS / 8;              // n-tiles of S^T and dP^T
  static_assert(D % 16 == 0 && kBQ % QS == 0, "tile shapes");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + T::kElems;
  bf16* sQ = sV + T::kElems;              // stages at sQ, sQ + kElems
  bf16* sdO = sQ + 2 * T::kElems;
  float* sL = reinterpret_cast<float*>(sdO + 2 * T::kElems);   // 2 stages
  float* sDl = sL + 2 * kBQ;

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int kt = blockIdx.z;              // causal: the first tiles work most
  const int G = H / KV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = kt * kBK;
  const int wk0 = k0 + warp * 16;         // this warp's first key
  const int64_t q_row = static_cast<int64_t>(H) * D;
  const int64_t kv_row = static_cast<int64_t>(KV) * D;
  const int64_t kv_off = static_cast<int64_t>(b) * S * kv_row + kvh * D;
  const float scale_log2 = scale * kLog2e;

  // the CTA's steps: query tiles qt0 .. n_q - 1 of each of the G heads
  const int n_q = (S + kBQ - 1) / kBQ;
  const int qt0 = causal ? kt : 0;        // kBQ == kBK
  const int per_head = n_q - qt0;
  const int n_steps = G * per_head;

  // Q, dO, lse and delta of step i into stage st
  auto stage = [&](int i, int st) {
    const int h = kvh * G + i / per_head;
    const int q0 = (qt0 + i % per_head) * kBQ;
    const int64_t q_off = static_cast<int64_t>(b) * S * q_row + h * D;
    load_tile<D>(sQ + st * T::kElems, q + q_off, q_row, q0, S, tid);
    load_tile<D>(sdO + st * T::kElems, dout + q_off, q_row, q0, S, tid);
    const int r = tid % kBQ;
    const bool in = q0 + r < S;
    const float* src = (tid < kBQ ? lse : delta) +
                       (static_cast<int64_t>(b) * H + h) * S + (in ? q0 + r : 0);
    cp_async::copy4((tid < kBQ ? sL : sDl) + st * kBQ + r, src, in);
  };

  load_tile<D>(sK, k + kv_off, kv_row, k0, S, tid);
  load_tile<D>(sV, v + kv_off, kv_row, k0, S, tid);
  stage(0, 0);
  cp_async::commit();

  // ldmatrix row offsets of this lane, as in the forward
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 8 * (lane >> 4);
  const int b_row = (lane & 7) + 8 * (lane >> 4), b_col = 8 * ((lane >> 3) & 1);

  float acc_k[NT][4], acc_v[NT][4];       // rows: keys g, g + 8 of the warp
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  for (int i = 0; i < n_steps; ++i) {
    const int st = i & 1;
    if (i + 1 < n_steps) stage(i + 1, st ^ 1);
    cp_async::commit();
    cp_async::wait<1>();                  // step i (and K, V) have landed
    __syncthreads();
    const int q0 = (qt0 + i % per_head) * kBQ;
    const bf16* cQ = sQ + st * T::kElems;
    const bf16* cdO = sdO + st * T::kElems;
    const float* cL = sL + st * kBQ;
    const float* cD = sDl + st * kBQ;

#pragma unroll
    for (int hq = 0; hq < kBQ / QS; ++hq) {
      const int qs0 = q0 + hq * QS;       // the half's first query
      // every query past S, or before this warp's first key: P = 0
      if (qs0 >= S || (causal && qs0 + QS - 1 < wk0)) continue;

      // S^T = K Q^T and dP^T = V dO^T: rows keys, columns queries
      float s[SN][4], dp[SN][4];
#pragma unroll
      for (int j = 0; j < SN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ka[4], va[4];
        ldsm_x4(smem_addr(sK + (warp * 16 + a_row) * Ld + ks * 16 + a_col), ka);
        ldsm_x4(smem_addr(sV + (warp * 16 + a_row) * Ld + ks * 16 + a_col), va);
#pragma unroll
        for (int jp = 0; jp < SN / 2; ++jp) {
          const int row = hq * QS + jp * 16 + b_row;
          uint32_t bq[4], bo[4];
          ldsm_x4(smem_addr(cQ + row * Ld + ks * 16 + b_col), bq);
          ldsm_x4(smem_addr(cdO + row * Ld + ks * 16 + b_col), bo);
          mma_bf16(s[2 * jp], ka, bq[0], bq[1]);
          mma_bf16(s[2 * jp + 1], ka, bq[2], bq[3]);
          mma_bf16(dp[2 * jp], va, bo[0], bo[1]);
          mma_bf16(dp[2 * jp + 1], va, bo[2], bo[3]);
        }
      }

      // P^T into s, dS^T into dp; the mask only where it reaches
      const bool edge = (causal && wk0 + 15 > qs0) || qs0 + QS > S ||
                        wk0 + 16 > S;
#pragma unroll
      for (int j = 0; j < SN; ++j) {
        const int col = hq * QS + j * 8 + 2 * t;   // query in the tile
        const float2 l2 = *reinterpret_cast<const float2*>(cL + col);
        const float2 d2 = *reinterpret_cast<const float2*>(cD + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lq = (e & 1) ? l2.y : l2.x;
          float p = exp2f(fmaf(s[j][e], scale_log2, -lq * kLog2e));
          if (edge) {
            const int kpos = wk0 + g + 8 * (e >> 1), qpos = q0 + col + (e & 1);
            if (qpos >= S || kpos >= S || (causal && kpos > qpos)) p = 0.f;
          }
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - ((e & 1) ? d2.y : d2.x));
        }
      }

      // dV += P^T dO and dK += dS^T Q, 16 queries a k-step
#pragma unroll
      for (int kk = 0; kk < SN / 2; ++kk) {
        uint32_t pa[kPParts][4], da[kPParts][4];
        split_a(s[2 * kk], s[2 * kk + 1], pa);
        split_a(dp[2 * kk], dp[2 * kk + 1], da);
        const int row = hq * QS + kk * 16 + a_row;
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bo[4], bq[4];
          ldsm_x4_trans(smem_addr(cdO + row * Ld + np * 16 + a_col), bo);
          ldsm_x4_trans(smem_addr(cQ + row * Ld + np * 16 + a_col), bq);
#pragma unroll
          for (int part = 0; part < kPParts; ++part) {
            mma_bf16(acc_v[2 * np], pa[part], bo[0], bo[1]);
            mma_bf16(acc_v[2 * np + 1], pa[part], bo[2], bo[3]);
            mma_bf16(acc_k[2 * np], da[part], bq[0], bq[1]);
            mma_bf16(acc_k[2 * np + 1], da[part], bq[2], bq[3]);
          }
        }
      }
    }
    __syncthreads();                      // stage st is refilled next
  }

  // dK and dV into the warp's own rows of sK and sV (only this warp read
  // them), then 16-byte stores of the rows below S
  const int orow = warp * 16 + g;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(sK + orow * Ld + col) =
        pack_bf16(acc_k[n][0] * scale, acc_k[n][1] * scale);
    *reinterpret_cast<uint32_t*>(sK + (orow + 8) * Ld + col) =
        pack_bf16(acc_k[n][2] * scale, acc_k[n][3] * scale);
    *reinterpret_cast<uint32_t*>(sV + orow * Ld + col) =
        pack_bf16(acc_v[n][0], acc_v[n][1]);
    *reinterpret_cast<uint32_t*>(sV + (orow + 8) * Ld + col) =
        pack_bf16(acc_v[n][2], acc_v[n][3]);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kBK * T::kChunks / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / T::kChunks, col = (c % T::kChunks) * 8;
    if (k0 + r < S) {
      const int64_t off = kv_off + (k0 + r) * kv_row + col;
      *reinterpret_cast<uint4*>(dk + off) =
          *reinterpret_cast<const uint4*>(sK + r * Ld + col);
      *reinterpret_cast<uint4*>(dv + off) =
          *reinterpret_cast<const uint4*>(sV + r * Ld + col);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dq,
                  int S, int H, int KV, float scale, int causal) {
  using T = Tile<D>;
  constexpr int Ld = T::kLd;
  constexpr int KS = D / 16;              // k-steps of Q K^T and dO V^T
  constexpr int NT = D / 8;               // n-tiles of dQ
  constexpr int SN = kBK / 8;             // n-tiles of S and dP
  static_assert(D % 16 == 0, "head dim a multiple of 16");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + T::kElems;
  bf16* sK = sdO + T::kElems;             // stages at sK, sK + kElems
  bf16* sV = sK + 2 * T::kElems;

  const int n_q = (S + kBQ - 1) / kBQ;
  const int qt = n_q - 1 - static_cast<int>(blockIdx.z);   // longest first
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kBQ;
  const int wq0 = q0 + warp * 16;         // this warp's first query row
  const int64_t q_row = static_cast<int64_t>(H) * D;
  const int64_t kv_row = static_cast<int64_t>(KV) * D;
  const int64_t q_off = static_cast<int64_t>(b) * S * q_row + h * D;
  const bf16* kb = k + static_cast<int64_t>(b) * S * kv_row + kvh * D;
  const bf16* vb = v + static_cast<int64_t>(b) * S * kv_row + kvh * D;
  const float scale_log2 = scale * kLog2e;

  const int n_kv = (S + kBK - 1) / kBK;
  const int kv_end = causal ? min(n_kv, qt + 1) : n_kv;    // kBQ == kBK

  load_tile<D>(sQ, q + q_off, q_row, q0, S, tid);
  load_tile<D>(sdO, dout + q_off, q_row, q0, S, tid);
  load_tile<D>(sK, kb, kv_row, 0, S, tid);
  load_tile<D>(sV, vb, kv_row, 0, S, tid);
  cp_async::commit();

  // lse * log2(e) and delta of this lane's rows g and g + 8 (zero past S)
  float lq[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wq0 + g + 8 * i;
    const int64_t at = (static_cast<int64_t>(b) * H + h) * S + row;
    lq[i] = row < S ? lse[at] * kLog2e : 0.f;
    dl[i] = row < S ? delta[at] : 0.f;
  }

  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 8 * (lane >> 4);
  const int b_row = (lane & 7) + 8 * (lane >> 4), b_col = 8 * ((lane >> 3) & 1);

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kt = 0; kt < kv_end; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < kv_end) {
      load_tile<D>(sK + (st ^ 1) * T::kElems, kb, kv_row, (kt + 1) * kBK, S,
                   tid);
      load_tile<D>(sV + (st ^ 1) * T::kElems, vb, kv_row, (kt + 1) * kBK, S,
                   tid);
    }
    cp_async::commit();
    cp_async::wait<1>();                  // tile kt (and Q, dO) have landed
    __syncthreads();
    const int k0 = kt * kBK;
    const bf16* cK = sK + st * T::kElems;
    const bf16* cV = sV + st * T::kElems;

    // S = Q K^T and dP = dO V^T
    float s[SN][4], dp[SN][4];
#pragma unroll
    for (int j = 0; j < SN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4], oa[4];
      ldsm_x4(smem_addr(sQ + (warp * 16 + a_row) * Ld + ks * 16 + a_col), qa);
      ldsm_x4(smem_addr(sdO + (warp * 16 + a_row) * Ld + ks * 16 + a_col), oa);
#pragma unroll
      for (int jp = 0; jp < SN / 2; ++jp) {
        uint32_t bk[4], bv[4];
        ldsm_x4(smem_addr(cK + (jp * 16 + b_row) * Ld + ks * 16 + b_col), bk);
        ldsm_x4(smem_addr(cV + (jp * 16 + b_row) * Ld + ks * 16 + b_col), bv);
        mma_bf16(s[2 * jp], qa, bk[0], bk[1]);
        mma_bf16(s[2 * jp + 1], qa, bk[2], bk[3]);
        mma_bf16(dp[2 * jp], oa, bv[0], bv[1]);
        mma_bf16(dp[2 * jp + 1], oa, bv[2], bv[3]);
      }
    }

    // dS into dp; the mask only on the tiles that reach past this warp's
    // first row or past S
    const bool edge = (causal && k0 + kBK - 1 > wq0) || k0 + kBK > S;
#pragma unroll
    for (int j = 0; j < SN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[j][e], scale_log2, -lq[e >> 1]));
        if (edge) {
          const int kpos = k0 + j * 8 + 2 * t + (e & 1);
          const int qpos = wq0 + g + 8 * (e >> 1);
          if (kpos >= S || (causal && kpos > qpos)) p = 0.f;
        }
        dp[j][e] = p * (dp[j][e] - dl[e >> 1]);
      }

    // dQ += dS K, 16 keys a k-step
#pragma unroll
    for (int kk = 0; kk < SN / 2; ++kk) {
      uint32_t da[kPParts][4];
      split_a(dp[2 * kk], dp[2 * kk + 1], da);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4_trans(
            smem_addr(cK + (kk * 16 + a_row) * Ld + np * 16 + a_col), bk);
#pragma unroll
        for (int part = 0; part < kPParts; ++part) {
          mma_bf16(acc[2 * np], da[part], bk[0], bk[1]);
          mma_bf16(acc[2 * np + 1], da[part], bk[2], bk[3]);
        }
      }
    }
    __syncthreads();                      // stage st is refilled next
  }

  // dQ through the warp's own rows of sQ, then 16-byte stores below S
  const int orow = warp * 16 + g;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(sQ + orow * Ld + col) =
        pack_bf16(acc[n][0] * scale, acc[n][1] * scale);
    *reinterpret_cast<uint32_t*>(sQ + (orow + 8) * Ld + col) =
        pack_bf16(acc[n][2] * scale, acc[n][3] * scale);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kBQ * T::kChunks / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / T::kChunks, col = (c % T::kChunks) * 8;
    if (q0 + r < S)
      *reinterpret_cast<uint4*>(dq + q_off + (q0 + r) * q_row + col) =
          *reinterpret_cast<const uint4*>(sQ + r * Ld + col);
  }
}

// -- backward launch ----------------------------------------------------------

// delta, then the route's dK/dV kernel and its dQ kernel, on one stream
template <typename T, int D, typename DkdvKernel, typename DqKernel>
int launch_bwd(DkdvKernel dkdv, size_t smem_kv, DqKernel dq_kernel,
               size_t smem_q, int threads, const void* q, const void* k,
               const void* v, const void* o, const float* lse,
               const void* dout, float* delta, void* dq, void* dk, void* dv,
               int B, int S, int H, int KV, float scale, int causal,
               cudaStream_t stream) {
  const auto* tq = static_cast<const T*>(q);
  const auto* tk = static_cast<const T*>(k);
  const auto* tv = static_cast<const T*>(v);
  const auto* tdo = static_cast<const T*>(dout);
  const int64_t rows = static_cast<int64_t>(B) * S * H;
  constexpr int kRowsPerCta = kBwdThreads / 32;
  flash_bwd_delta<T, D><<<static_cast<unsigned>((rows + kRowsPerCta - 1) / kRowsPerCta),
                          kBwdThreads, 0, stream>>>(static_cast<const T*>(o), tdo,
                                                    delta, B, S, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int n_t = (S + kBK - 1) / kBK;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_kv));
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv<<<dim3(KV, B, n_t), threads, smem_kv, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), S,
      H, KV, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(dq_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_q));
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<<<dim3(H, B, n_t), threads, smem_q, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), S, H, KV, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd_dtype(const void* q, const void* k, const void* v,
                     const void* o, const float* lse, const void* dout,
                     float* delta, void* dq, void* dk, void* dv, int B, int S,
                     int H, int KV, int dtype, float scale, int causal,
                     cudaStream_t stream) {
  if (dtype == 0)
    return launch_bwd<float, D>(
        flash_bwd_dkdv_f32<D>, bwd_smem_bytes<D>(2), flash_bwd_dq_f32<D>,
        bwd_smem_bytes<D>(1), kBwdThreads, q, k, v, o, lse, dout, delta, dq,
        dk, dv, B, S, H, KV, scale, causal, stream);
  if (dtype == 1)
    return launch_bwd<bf16, D>(
        flash_bwd_dkdv_bf16<D>, BwdTile<D>::kSmemKV, flash_bwd_dq_bf16<D>,
        BwdTile<D>::kSmemQ, kThreads, q, k, v, o, lse, dout, delta, dq, dk,
        dv, B, S, H, KV, scale, causal, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// -- launch ---------------------------------------------------------------------

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int S, int H, int KV, float scale,
               int causal, cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd_f32<D><<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, H, KV,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int S, int H, int KV, float scale,
                int causal, cudaStream_t stream) {
  constexpr size_t smem = Tile<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B, (S + kBQ - 1) / kBQ);
  flash_fwd_bf16<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, S, H, KV,
      scale * 1.4426950408889634f, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int S, int H, int KV, int dtype, float scale, int causal,
           cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32<D>(q, k, v, o, lse, B, S, H, KV, scale, causal, stream);
  if (dtype == 1)
    return launch_bf16<D>(q, k, v, o, lse, B, S, H, KV, scale, causal, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).  All
// tensors contiguous; bfloat16 ones 16-byte aligned.
// lse: null, or (B, H, S) float32 for each query row's log-sum-exp.
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    void* lse, int B, int S, int H, int KV, int D, int dtype,
                    float scale, int causal, void* stream) {
  if (B <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  auto st = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<float*>(lse);
  switch (D) {
    case 32: return launch<32>(q, k, v, o, l, B, S, H, KV, dtype, scale, causal, st);
    case 64: return launch<64>(q, k, v, o, l, B, S, H, KV, dtype, scale, causal, st);
    case 80: return launch<80>(q, k, v, o, l, B, S, H, KV, dtype, scale, causal, st);
    case 128: return launch<128>(q, k, v, o, l, B, S, H, KV, dtype, scale, causal, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward: q, k, v, o, dout and the forward's lse in, dq, dk, dv out
// (q's, k's and v's shapes and dtype); delta is (B, H, S) float32 scratch.
// All contiguous.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* lse, const void* dout,
                        void* delta, void* dq, void* dk, void* dv, int B,
                        int S, int H, int KV, int D, int dtype, float scale,
                        int causal, void* stream) {
  if (B <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<float*>(delta);
  switch (D) {
    case 32: return launch_bwd_dtype<32>(q, k, v, o, l, dout, dl, dq, dk, dv, B, S, H, KV, dtype, scale, causal, st);
    case 64: return launch_bwd_dtype<64>(q, k, v, o, l, dout, dl, dq, dk, dv, B, S, H, KV, dtype, scale, causal, st);
    case 80: return launch_bwd_dtype<80>(q, k, v, o, l, dout, dl, dq, dk, dv, B, S, H, KV, dtype, scale, causal, st);
    case 128: return launch_bwd_dtype<128>(q, k, v, o, l, dout, dl, dq, dk, dv, B, S, H, KV, dtype, scale, causal, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
