// GQA decode attention: one query token per sequence over a KV cache, sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/decode_attention/kernel.py:
// decode_attention (public wrapper ops.gqa_decode).  Layout is the model's:
// q (B, 1, H, D), the cache k/v (B, S, KV, D) read through its strides (no
// transposed copy), kv_len (B,) int32, out (B, 1, H, D) contiguous.  Query
// head h belongs to KV head h / G, G = H / KV <= 8.  Sequence b attends over
// cache positions [0, kv_len[b]); the rest is left out of the softmax, and a
// sequence with kv_len 0 gets zeros (as the TPU kernel gives).
//
// Bound on the H100: bytes.  Each valid cache row is read once (K and V),
// against 4 * G * D operations per row and KV head -- about G operations
// per byte, far below the ~295 at which the tensor cores would bound it.
// So the design streams the cache at the memory's rate and keeps the
// per-key arithmetic off the issue slots.
//
// Flash decoding, one kernel a call (decode_split_*): one CTA per (key
//   range, KV head, b) computes the partial softmax of its G query heads
//   over its range -- running max (in log2 units of the scaled scores),
//   normaliser and unnormalised accumulator, float32 -- into scratch.  The
//   valid prefix is dealt out in whole kTile-key tiles, n_split runs that
//   differ by at most one tile (the wrapper picks n_split so that the card
//   fills).  The last CTA of each (b, KV head) to finish -- a counter per
//   pair, bumped after a fence -- merges the ranges: each (range, head)'s
//   weight computed once (a warp per head, a lane per range), then the
//   threads walk the ranges in order over (head, four head dims) and
//   normalise, and it resets the counter for the next call.  With one
//   range (n_split = 1: B * KV fills the card alone) the CTA normalises
//   its own partial and writes the output directly.  Merging in the last
//   CTA needs no second launch, and computing each weight once keeps the
//   merge short.  No atomic sums and a fixed order of sums, so two calls
//   on the same inputs give the same bytes, whichever CTA is last.
//
// bfloat16 (decode_split_bf16) -- tensor cores.  On the CUDA cores each key
//   would cost G dot products of five dependent shuffles each, G exps and
//   G * D FMAs; instead the G query heads of a KV head are the rows of an
//   mma.sync m16n8k16 bf16 -> f32 tile (rows past G zero, their outputs never written), as
//   the TPU kernel's (G, D) x (bk, D)^T product on the MXU.  A CTA of
//   kWarps warps streams kTile = 16 * kWarps keys a tile: K and V arrive by
//   16-byte cp.async into a kStages-deep ring, rows padded by 16 bytes so
//   each ldmatrix phase hits eight distinct bank groups; rows past the
//   range are zero-filled.  Warp w takes keys [16w, 16w + 16) of each tile:
//   S = Q K^T is D / 16 k-steps of two n-tiles (Q's A fragments held in
//   registers from the start, K's B fragments by ldmatrix), masked past
//   the range, and the online softmax runs on the accumulators in float32
//   (the row max over the lane quad by two shuffles, exp2 with
//   1/sqrt(D) * log2(e) folded in: the scale applies to S in float32, not
//   to a bf16 q).  S's accumulator layout is P's A fragment
//   (FlashAttention-2's register reuse); V's B fragments come from
//   ldmatrix.trans.  P enters P V as kPParts = 3 bf16 parts, each the bf16
//   rounding of what the parts before it leave (float32's 24 bits): one
//   bf16 P broke B3's four-ulp gate (csrc/flash_attention.cu's header).
//   The kWarps warps' partials merge through shared memory (each warp's
//   weight computed once a head) into the range's partial.  mma.sync, not
//   wgmma: the point is to take the G-fold shuffle and FMA work off the
//   issue slots, and wgmma's 64-row tiles would add nothing to G <= 8
//   rows.  The ring takes 2 * kStages * kTile * (D + 8) * 2 bytes: over
//   48 KB at D = 128, so the kernel's dynamic shared memory limit is
//   raised once per device and process (allow_smem), not per launch.
//
// float32 (decode_split_f32; q and cache float32, or float32 q over a
//   bf16 cache) -- CUDA cores: these routes are the precision checks (2e-5), and TF32 would keep about three decimal
//   digits.  Eight warps, each walking every eighth key: a lane owns head
//   dims lane, lane + 32, ..., four keys' rows in flight, G scores reduced
//   by five shuffles each, then the warps merge through shared memory.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

using bf16 = __nv_bfloat16;
using cp_async::smem_addr;

constexpr int kTile = 64;             // keys a tile; ranges are whole tiles
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kMaxSplits = 128;       // ranges a (b, KV head) at most

// Keys [lo, hi) of range `split`: the ceil(len / kTile) tiles of the valid
// prefix dealt out in n_split consecutive runs that differ by at most one
// tile (empty where there are fewer tiles than ranges).
// ops.split_ranges mirrors it.
__device__ __forceinline__ void split_range(int len, int n_split, int split,
                                            int& lo, int& hi) {
  const int tiles = (len + kTile - 1) / kTile;
  lo = min(len, split * tiles / n_split * kTile);
  hi = min(len, (split + 1) * tiles / n_split * kTile);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* kv_len;
  void* out;
  float* part_acc;   // (B, KV, n_split, G, D): unnormalised accumulators
  float* part_ml;    // (B, KV, n_split, G, 2): max (log2 units), normaliser
  int* counters;     // (B, KV): ranges done; 0 between calls
  int S, H, KV, D, n_split;
  float scale;
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
};

__device__ __forceinline__ void store4(float* o, float4 x) {
  *reinterpret_cast<float4*>(o) = x;
}
__device__ __forceinline__ void store4(bf16* o, float4 x) {
  reinterpret_cast<__nv_bfloat162*>(o)[0] = __floats2bfloat162_rn(x.x, x.y);
  reinterpret_cast<__nv_bfloat162*>(o)[1] = __floats2bfloat162_rn(x.z, x.w);
}

// Floats of shared scratch merge_ranges takes.
__host__ __device__ constexpr int merge_floats(int max_group) {
  return 2 * kMaxSplits * max_group + 8;
}

// The n_split ranges' partials of (b, KV head kvh) merged in range order
// and normalised into the G heads' rows of out (B, 1, H, D).  s: shared
// scratch of merge_floats(G) floats.
template <typename TO, int D, int NTHREADS>
__device__ __forceinline__ void merge_ranges(const Args& a, int b, int kvh,
                                             float* s) {
  constexpr int D4 = D / 4;
  const int G = a.H / a.KV, n = a.n_split * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // (range sp, head g) at base + sp * G + g
  const long long base = (static_cast<long long>(b) * a.KV + kvh) * n;
  float* s_w = s;                       // (n_split, G): max, then weight
  float* s_l = s + n;                   // (n_split, G): normaliser
  float* s_sum = s + 2 * n;             // (G): the merged normaliser
  for (int e = tid; e < n; e += NTHREADS) {
    const float2 ml = __ldcg(reinterpret_cast<const float2*>(a.part_ml) + base + e);
    s_w[e] = ml.x;
    s_l[e] = ml.y;
  }
  __syncthreads();
  for (int g = warp; g < G; g += NTHREADS / 32) {   // a warp a head
    float mx = -INFINITY;
    for (int sp = lane; sp < a.n_split; sp += 32) mx = fmaxf(mx, s_w[sp * G + g]);
    mx = warp_max(mx);
    float lsum = 0.f;
    for (int sp = lane; sp < a.n_split; sp += 32) {
      const float m = s_w[sp * G + g];
      const float w = m == -INFINITY ? 0.f : exp2f(m - mx);
      s_w[sp * G + g] = w;
      lsum += s_l[sp * G + g] * w;
    }
    lsum = warp_sum(lsum);
    if (lane == 0) s_sum[g] = fmaxf(lsum, 1e-20f);   // kv_len 0: zeros
  }
  __syncthreads();
  const float4* pa = reinterpret_cast<const float4*>(a.part_acc) + base * D4;
  TO* ob = static_cast<TO*>(a.out) + (static_cast<long long>(b) * a.H + kvh * G) * D;
  for (int e = tid; e < G * D4; e += NTHREADS) {
    const int g = e / D4, d4 = e % D4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int sp = 0; sp < a.n_split; ++sp) {
      const float w = s_w[sp * G + g];
      const float4 x = __ldcg(pa + (sp * G + g) * D4 + d4);
      acc.x += w * x.x;
      acc.y += w * x.y;
      acc.z += w * x.z;
      acc.w += w * x.w;
    }
    const float sum = s_sum[g];
    store4(ob + g * D + 4 * d4,
           make_float4(acc.x / sum, acc.y / sum, acc.z / sum, acc.w / sum));
  }
}

// After a CTA has written its range's partial: the last CTA of (b, KV
// head) to get here merges the ranges and resets the pair's counter.
template <typename TO, int D, int NTHREADS>
__device__ __forceinline__ void finish(const Args& a, int b, int kvh, float* s) {
  __shared__ int s_last;
  __threadfence();                      // this CTA's partial, device-wide
  __syncthreads();
  int* count = a.counters + static_cast<long long>(b) * a.KV + kvh;
  if (threadIdx.x == 0) s_last = atomicAdd(count, 1) == a.n_split - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();                      // and the other ranges' partials
  merge_ranges<TO, D, NTHREADS>(a, b, kvh, s);
  if (threadIdx.x == 0) *count = 0;
}

// -- bfloat16: tensor cores ---------------------------------------------------

constexpr int kWarps = 4;             // 16 keys of each tile a warp
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 2;            // K/V tiles in flight
constexpr int kPParts = 3;            // bf16 parts P is split into
static_assert(kTile == 16 * kWarps, "a warp takes 16 keys of a tile");

template <int D>
struct Ring {
  static constexpr int kLd = D + 8;               // padded row (16 bytes)
  static constexpr int kElems = kTile * kLd;      // one K or V tile
  static constexpr int kChunks = D / 8;           // 16-byte chunks of a row
  static constexpr size_t kSmem = sizeof(bf16) * 2 * kStages * kElems;
  // after the ring: the warps' partials, (kWarps, 8, D), and their
  // max, normaliser and weight, (kWarps, 8) each, float32
  static_assert(sizeof(float) * (kWarps * 8 * D + 3 * kWarps * 8 + 8) <= kSmem &&
                    sizeof(float) * merge_floats(8) <= kSmem,
                "the warps' partials and the merge's scratch fit in the ring");
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

// Rows r0 .. r0 + kTile - 1 of a (rows, stride) bf16 matrix into a padded
// tile; rows at or past hi are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int r0, int hi,
                                          int tid) {
  using R = Ring<D>;
  static_assert(kTile * R::kChunks % kThreads == 0, "whole chunks a thread");
#pragma unroll
  for (int i = 0; i < kTile * R::kChunks / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / R::kChunks, col = (c % R::kChunks) * 8;
    const bool in = r0 + r < hi;
    cp_async::copy16(dst + r * R::kLd + col,
                     src + (in ? (r0 + r) * stride : 0) + col, in);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
decode_split_bf16(Args a) {
  using R = Ring<D>;
  constexpr int Ld = R::kLd;
  constexpr int KS = D / 16;              // k-steps of Q K^T
  constexpr int NT = D / 8;               // n-tiles of P V
  static_assert(D % 16 == 0, "head dim a multiple of 16");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);   // stage st at sK + st * kElems
  bf16* sV = sK + kStages * R::kElems;

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma row (query head), lane in quad
  int lo, hi;
  split_range(min(max(a.kv_len[b], 0), a.S), a.n_split, split, lo, hi);
  const int n_t = (hi - lo + kTile - 1) / kTile;
  const float sl = a.scale * kLog2e;

  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_t) {
      load_tile<D>(sK + i * R::kElems, kb, a.k_ss, lo + i * kTile, hi, tid);
      load_tile<D>(sV + i * R::kElems, vb, a.v_ss, lo + i * kTile, hi, tid);
    }
    cp_async::commit();
  }

  // Q's A fragments, row g (head kvh * G + g; zero past G): columns 2t, 2t+1
  // and 2t+8, 2t+9 of each k-step.  Rows g + 8 are padding, always zero.
  uint32_t qa[KS][2];
  {
    const bf16* qh = static_cast<const bf16*>(a.q) + b * a.q_sb +
                     (kvh * G + min(g, G - 1)) * a.q_sh;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int d = ks * 16 + 2 * t + 8 * half;
        qa[ks][half] =
            g < G ? static_cast<uint32_t>(__bfloat16_as_ushort(qh[d])) |
                        static_cast<uint32_t>(__bfloat16_as_ushort(qh[d + 1])) << 16
                  : 0u;
      }
  }

  // ldmatrix row offsets of this lane within its warp's 16 keys: K's B
  // tiles take rows (lane & 7) + 8 * (lane >> 4), column half
  // (lane >> 3) & 1; V's (trans) rows (lane & 7) + 8 * ((lane >> 3) & 1),
  // column half lane >> 4.
  const int b_row = (lane & 7) + 8 * (lane >> 4), b_col = 8 * ((lane >> 3) & 1);
  const int v_row = (lane & 7) + 8 * ((lane >> 3) & 1), v_col = 8 * (lane >> 4);

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m = -INFINITY;                    // row g's max, raw scores
  float l = 0.f;                          // this lane's part of row g's sum

  for (int it = 0; it < n_t; ++it) {
    const int nx = it + kStages - 1;
    if (nx < n_t) {
      const int st = nx % kStages;
      load_tile<D>(sK + st * R::kElems, kb, a.k_ss, lo + nx * kTile, hi, tid);
      load_tile<D>(sV + st * R::kElems, vb, a.v_ss, lo + nx * kTile, hi, tid);
    }
    cp_async::commit();
    cp_async::wait<kStages - 1>();        // tile it has landed
    __syncthreads();
    const int st = it % kStages;
    const bf16* cK = sK + st * R::kElems + warp * 16 * Ld;
    const bf16* cV = sV + st * R::kElems + warp * 16 * Ld;
    const int k0 = lo + it * kTile + warp * 16;   // this warp's first key
    if (k0 < hi) {                        // warp-uniform
      float s[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint32_t qf[4] = {qa[ks][0], 0u, qa[ks][1], 0u};
        uint32_t bk[4];
        ldsm_x4(smem_addr(cK + b_row * Ld + ks * 16 + b_col), bk);
        mma_bf16(s[0], qf, bk[0], bk[1]);
        mma_bf16(s[1], qf, bk[2], bk[3]);
      }
      // row g's scores: keys k0 + 8j + 2t + e (e = 0, 1) in s[j][e]
      if (k0 + 16 > hi) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (k0 + 8 * j + 2 * t + e >= hi) s[j][e] = -INFINITY;
      }
      float mx = fmaxf(fmaxf(m, fmaxf(s[0][0], s[0][1])), fmaxf(s[1][0], s[1][1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float base = mx * sl;         // finite: key k0 is in the range
      const float corr = exp2f(m * sl - base);
      m = mx;
      l *= corr;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][0] *= corr;
        acc[n][1] *= corr;
      }
      float r[4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          r[2 * j + e] = exp2f(fmaf(s[j][e], sl, -base));
          l += r[2 * j + e];
        }
      // P's A fragment (row g: keys 2t, 2t+1 in a0, 2t+8, 2t+9 in a2; rows
      // g + 8 zero) in kPParts bf16 parts
      uint32_t pa[kPParts][4];
#pragma unroll
      for (int part = 0; part < kPParts; ++part) {
        pa[part][0] = pack_bf16(r[0], r[1]);
        pa[part][2] = pack_bf16(r[2], r[3]);
        pa[part][1] = pa[part][3] = 0u;
        const float2 b0 = unpack_bf16(pa[part][0]), b2 = unpack_bf16(pa[part][2]);
        r[0] -= b0.x;
        r[1] -= b0.y;
        r[2] -= b2.x;
        r[3] -= b2.y;
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bv[4];
        ldsm_x4_trans(smem_addr(cV + v_row * Ld + np * 16 + v_col), bv);
#pragma unroll
        for (int part = 0; part < kPParts; ++part) {
          mma_bf16(acc[2 * np], pa[part], bv[0], bv[1]);
          mma_bf16(acc[2 * np + 1], pa[part], bv[2], bv[3]);
        }
      }
    }
    __syncthreads();                      // stage st is refilled next
  }
  cp_async::wait<0>();
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);

  // the warps' partials through shared memory (the ring is drained)
  float* s_acc = reinterpret_cast<float*>(smem_raw);   // (kWarps, 8, D)
  float* s_m = s_acc + kWarps * 8 * D;                 // (kWarps, 8) each
  float* s_l = s_m + kWarps * 8;
  float* s_c = s_l + kWarps * 8;
  float* s_sum = s_c + kWarps * 8;                     // (8): one range's normaliser
  const bool one = a.n_split == 1;                     // one range: no merge
  __syncthreads();
  if (g < G) {
    const int row = warp * 8 + g;
    if (t == 0) {
      s_m[row] = m * sl;                  // -inf for a warp with no key
      s_l[row] = l;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s_acc[row * D + n * 8 + 2 * t] = acc[n][0];
      s_acc[row * D + n * 8 + 2 * t + 1] = acc[n][1];
    }
  }
  __syncthreads();
  const long long part =
      ((static_cast<long long>(b) * a.KV + kvh) * a.n_split + split) * G;
  if (tid < G) {                          // each warp's weight, once a head
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w * 8 + tid]);
    float lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = s_m[w * 8 + tid];
      const float c = mw == -INFINITY ? 0.f : exp2f(mw - mx);
      s_c[w * 8 + tid] = c;
      lsum += s_l[w * 8 + tid] * c;
    }
    if (one) {
      s_sum[tid] = fmaxf(lsum, 1e-20f);   // kv_len 0: zeros
    } else {
      a.part_ml[(part + tid) * 2] = mx;
      a.part_ml[(part + tid) * 2 + 1] = lsum;
    }
  }
  __syncthreads();
  constexpr int D4 = D / 4;
  const float4* s_acc4 = reinterpret_cast<const float4*>(s_acc);
  float4* out4 = reinterpret_cast<float4*>(a.part_acc) + part * D4;
  bf16* ob = static_cast<bf16*>(a.out) + (static_cast<long long>(b) * a.H + kvh * G) * D;
  for (int e = tid; e < G * D4; e += kThreads) {
    const int gg = e / D4, d4 = e % D4;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = s_c[w * 8 + gg];
      const float4 x = s_acc4[(w * 8 + gg) * D4 + d4];
      sum.x += c * x.x;
      sum.y += c * x.y;
      sum.z += c * x.z;
      sum.w += c * x.w;
    }
    if (one) {
      const float l = s_sum[gg];
      store4(ob + gg * D + 4 * d4, make_float4(sum.x / l, sum.y / l, sum.z / l, sum.w / l));
    } else {
      out4[gg * D4 + d4] = sum;
    }
  }
  if (!one) finish<bf16, D, kThreads>(a, b, kvh, reinterpret_cast<float*>(smem_raw));
}

// Raises decode_split_bf16<D>'s dynamic shared memory limit where the ring
// passes the default 48 KB: once per device and process, not per launch.
template <int D>
cudaError_t allow_smem() {
  constexpr size_t smem = Ring<D>::kSmem;
  if (smem <= 48 * 1024) return cudaSuccess;
  static std::atomic<unsigned long long> done{0};   // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(decode_split_bf16<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// -- float32: CUDA cores ------------------------------------------------------

constexpr int kF32Warps = 8;
constexpr int kF32Threads = kF32Warps * 32;
constexpr int kUnroll = 4;            // keys a warp loads before using them

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// weight of a partial with running max m against the merged max mx
__device__ __forceinline__ float rescale(float m, float mx) {
  return m == -INFINITY ? 0.f : expf(m - mx);
}

// One CTA per (key range, KV head, b): a partial softmax over the range.
template <typename TQ, typename TK, int D, int MAXG>
__global__ void __launch_bounds__(kF32Threads)
decode_split_f32(Args a) {
  constexpr int DPL = (D + 31) / 32;    // head dims per lane
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int lo, hi;
  split_range(min(max(a.kv_len[b], 0), a.S), a.n_split, split, lo, hi);

  const TQ* qb = static_cast<const TQ*>(a.q) + b * a.q_sb;
  const TK* kb = static_cast<const TK*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const TK* vb = static_cast<const TK*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  float qr[MAXG][DPL], acc[MAXG][DPL], m[MAXG], l[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      const bool ok = g < G && d < D;
      qr[g][i] = ok ? to_f(qb[(kvh * G + g) * a.q_sh + d]) * a.scale : 0.f;
      acc[g][i] = 0.f;
    }
  }

  for (int s0 = lo + warp; s0 < hi; s0 += kF32Warps * kUnroll) {
    float kr[kUnroll][DPL], vr[kUnroll][DPL];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u * kF32Warps;
      ok[u] = s < hi;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        const bool in = ok[u] && d < D;
        kr[u][i] = in ? to_f(kb[s * a.k_ss + d]) : 0.f;
        vr[u][i] = in ? to_f(vb[s * a.v_ss + d]) : 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      float sc[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) dot += qr[g][i] * kr[u][i];
        sc[u] = warp_sum(dot);
      }
      float mx = m[g];                  // ok[0] holds: s0 < hi
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (ok[u]) mx = fmaxf(mx, sc[u]);
      const float corr = rescale(m[g], mx);
      float p[kUnroll], psum = 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        p[u] = ok[u] ? expf(sc[u] - mx) : 0.f;
        psum += p[u];
      }
      l[g] = l[g] * corr + psum;
      m[g] = mx;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        float x = acc[g][i] * corr;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) x += p[u] * vr[u][i];
        acc[g][i] = x;
      }
    }
  }

  // merge the 8 warps' partials through shared memory
  __shared__ float s_m[kF32Warps][MAXG], s_l[kF32Warps][MAXG];
  __shared__ float s_acc[kF32Warps][MAXG][D];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (lane == 0) {
      s_m[warp][g] = m[g];
      s_l[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) s_acc[warp][g][d] = acc[g][i];
    }
  }
  __syncthreads();
  const long long part =
      ((static_cast<long long>(b) * a.KV + kvh) * a.n_split + split) * G;
  for (int e = threadIdx.x; e < G * D; e += kF32Threads) {
    const int g = e / D, d = e % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kF32Warps; ++w) mx = fmaxf(mx, s_m[w][g]);
    float lsum = 0.f, asum = 0.f;
#pragma unroll
    for (int w = 0; w < kF32Warps; ++w) {
      const float c = rescale(s_m[w][g], mx);
      lsum += s_l[w][g] * c;
      asum += s_acc[w][g][d] * c;
    }
    if (a.n_split == 1) {               // one range: no merge
      static_cast<TQ*>(a.out)[(part + g) * D + d] = asum / fmaxf(lsum, 1e-20f);
      continue;
    }
    a.part_acc[(part + g) * D + d] = asum;
    if (d == 0) {                       // the max in log2 units, as the merge takes it
      a.part_ml[(part + g) * 2] = mx * kLog2e;
      a.part_ml[(part + g) * 2 + 1] = lsum;
    }
  }
  if (a.n_split == 1) return;
  __shared__ float s_merge[merge_floats(MAXG)];
  finish<TQ, D, kF32Threads>(a, b, kvh, s_merge);
}

// -- launch -------------------------------------------------------------------

template <int D>
int launch_bf16(const Args& a, int B, cudaStream_t st) {
  cudaError_t err = allow_smem<D>();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_split_bf16<D><<<dim3(a.n_split, a.KV, B), kThreads, Ring<D>::kSmem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TK, int D>
int launch_f32(const Args& a, int B, cudaStream_t st) {
  const int G = a.H / a.KV;
  const dim3 grid(a.n_split, a.KV, B);
  if (G <= 1) decode_split_f32<TQ, TK, D, 1><<<grid, kF32Threads, 0, st>>>(a);
  else if (G <= 2) decode_split_f32<TQ, TK, D, 2><<<grid, kF32Threads, 0, st>>>(a);
  else if (G <= 4) decode_split_f32<TQ, TK, D, 4><<<grid, kF32Threads, 0, st>>>(a);
  else decode_split_f32<TQ, TK, D, 8><<<grid, kF32Threads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const Args& a, int B, int dtype, cudaStream_t st) {
  if (dtype == 0) return launch_f32<float, float, D>(a, B, st);
  if (dtype == 1) return launch_bf16<D>(a, B, st);
  if (dtype == 2) return launch_f32<float, bf16, D>(a, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = q and cache float32, 1 = both bfloat16, 2 = q float32 over a
// bfloat16 cache.  Strides are in elements; the head dim is contiguous (and
// for dtype 1 the cache's rows 16-byte aligned: the wrapper checks).
// part_acc / part_ml are scratch of (B, KV, n_split, G, D) / (..., G, 2)
// float32, allocated by the caller; counters (B * KV int32) is zero before
// the call and after it, and no other call uses it meanwhile.
int decode_attention(const void* q, const void* k, const void* v,
                     const void* kv_len, void* out, void* part_acc,
                     void* part_ml, void* counters, int B, int S, int H,
                     int KV, int D,
                     int n_split, int dtype, float scale, long long q_sb,
                     long long q_sh, long long k_sb, long long k_ss,
                     long long k_sh, long long v_sb, long long v_ss,
                     long long v_sh, void* stream) {
  if (B <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (KV <= 0 || H % KV != 0 || H / KV > 8 || n_split <= 0 ||
      n_split > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, static_cast<const int*>(kv_len), out,
         static_cast<float*>(part_acc), static_cast<float*>(part_ml),
         static_cast<int*>(counters), S, H, KV, D, n_split, scale,
         q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(a, B, dtype, st);
    case 64: return launch<64>(a, B, dtype, st);
    case 80: return launch<80>(a, B, dtype, st);
    case 128: return launch<128>(a, B, dtype, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
