// Chunked Mamba2 SSD scan on the tensor cores, sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/mamba2_scan/kernel.py:
// ssd_scan (public wrapper ops.mamba2_ssd).  It evaluates, per (b, head),
//   h_t = exp(A dt_t) h_{t-1} + dt_t B_t^T x_t,   y_t = C_t h_t
// chunk by chunk, as the model's ssd_chunked does (models/mamba2.py):
//   cum = inclusive cumsum of dt A over the chunk
//   M   = (C B^T) o exp(cum_t - cum_s)[s <= t] o dt_s
//   y   = M x + exp(cum) o (C h)
//   h  <- exp(cum_last) h + (B o exp(cum_last - cum) dt)^T x
// Layout is the model's: x (Bz, L, H, P) read through its strides (float32
// or bfloat16), dt (Bz, L, H), A (H,), B and C (Bz, L, N) shared by all
// heads and indexed by batch, h0 (Bz, H, N, P), all float32 and contiguous.
// Out: y (Bz, L, H, P) and hT (Bz, H, N, P), float32 -- y without the D x
// residual, which the model adds in float32.
//
// Bound on the H100.  Every product of the chunked form is a matrix
// product with sides of N, P and the chunk length, so at prefill it is
// bound by operations, and those run on the tensor cores: at zamba2-1.2b's
// prefill (4 x 1024 steps, 64 heads, P = N = 64) about 0.04 ms of TF32
// work against 0.034 ms of bytes.  At decode (L = 1) it is bound by bytes:
// the state is read and written once.
//
// Precision: split TF32 (tf32_mma.cuh).  Every float32 operand -- C, B o w,
// M, the state -- is split into two TF32 parts (22 bits); x is exact in
// TF32 when it is bfloat16 and split when it is float32.  A product of two
// split operands takes three TF32 mma.sync, one with an exact operand two.
// No exponent is ever positive: exp(cum_t - cum_s) only for s <= t (the
// mask selects 0 above the diagonal before the product), exp(cum_t) and
// exp(cum_last - cum_s) for s in the chunk; cum is a sum of non-positive
// dt A, so every decay is in [0, 1] for any A dt, and one that underflows
// is 0, which is also what it is in float32 arithmetic.
//
// Design.  The same products as scalar FMAs, two shared loads each, at
// one 8-warp CTA an SM, are bound by shared-memory bandwidth (3.8% of the
// bound on the H100, PERF.md).  Here:
// - ssd_chunks: one CTA of 8 warps per (b, head) walks the chunks of
//   kLc = 32 steps in order (the kernel's own chunk, whatever the caller's:
//   the result does not depend on it but for rounding).  Its shared memory
//   (about 95 KB at P = N = 64) lets two CTAs share an SM, 16 warps.
// - The chunk's x, B, C and dt come by cp.async into a two-stage ring: the
//   next chunk is in flight while this one computes.  Rows are padded so
//   that each fragment load hits distinct banks.
// - Each warp computes the chunk's cumsum for itself (32 steps: one warp
//   scan, no shared memory, no barrier) and takes cum, exp(cum) and the
//   weights w by shuffles.
// - Six warps compute the causal 16 x 8 tiles of C B^T (k = N), apply the
//   decay, the mask and dt_s, and leave M split in shared memory.  The
//   state stays in registers as mma accumulators (tiles of (N, P), shared
//   out among the warps), and in shared memory as its two TF32 parts,
//   transposed to (P, N), for C h.  y = C h (scaled by exp(cum)) + M x is
//   one (16 rows, 8 columns) accumulator tile per warp and n-tile; the
//   update (B o w)^T x runs into the state's accumulators.  Three barriers
//   a chunk.
// - A ragged last chunk is zero-filled by cp.async (zero dt, x and B leave
//   the state as it was), so L need not be a multiple of the chunk.
// - ssd_step: L = 1 (a decode step), bound by the state's bytes, takes a
//   plain kernel of its own: one CTA per (b, head), the state read,
//   updated and written by coalesced float32 loads, y reduced in a fixed
//   order.  There the chunk kernel takes twice its time
//   (scripts/scan_decode_routes.py, PERF.md).

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "cp_async.cuh"
#include "scan_bwd.cuh"
#include "tf32_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using tf32::FragA;
using tf32::FragB;

constexpr int kLc = 32;                  // steps per chunk
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  const float* h0;
  float* y;
  float* hT;
  int L, H;
  long long x_sb, x_sl, x_sh;
};

// Shared-memory layout of ssd_chunks, in bytes unless named otherwise.
template <typename TX, int P, int N>
struct Layout {
  static constexpr bool kBf16 = std::is_same<TX, bf16>::value;
  // x rows: 32-bit words per row = 8 mod 32, so rows t = 0..3 of a B
  // fragment (b0 = x[t][g]) fall on distinct banks
  static constexpr int kLdX = kBf16 ? P + 16 : P + 8;      // elements
  static constexpr int kLdBC = N + 8;     // floats: B, C rows (= 8 mod 32)
  static constexpr int kLdH = N + 8;      // state as (P, N) rows
  static constexpr int kLdM = kLc + 4;    // M rows
  static constexpr int kX = kLc * kLdX * static_cast<int>(sizeof(TX));
  static constexpr int kBC = kLc * kLdBC * 4;
  static constexpr int kStage = kX + 2 * kBC + kLc * 4;    // x, B, C, dt
  static constexpr int kH = P * kLdH * 4;
  static constexpr int kM = kLc * kLdM * 4;
  static constexpr int kBytes = 2 * kStage + 2 * kH + 2 * kM;
  static_assert(kX % 16 == 0 && kBC % 16 == 0 && kH % 16 == 0, "16-byte rows");
  // the work of a warp
  static constexpr int kYN = P / 32;      // y n-tiles (of 8 columns)
  static constexpr int kNT = P / 8;       // n-tiles of the state
  static constexpr int kSTiles = (N / 16) * kNT;   // (16 x 8) state tiles
  static constexpr int kSPer = (kSTiles + kWarps - 1) / kWarps;
  static_assert(kNT % kSPer == 0, "a warp's state tiles share their rows");
};

// B fragment of x (natural k order over the chunk's steps): rows s0 + t
// and s0 + t + 4 of column p0 + g; exact for bfloat16, split for float32.
template <typename TX, int kLd>
__device__ __forceinline__ FragB x_frag(const TX* sx, int s0, int p0, int g,
                                        int t) {
  if constexpr (std::is_same<TX, bf16>::value) {
    const uint32_t b0 = tf32::from_bf16(sx[(s0 + t) * kLd + p0 + g]);
    const uint32_t b1 = tf32::from_bf16(sx[(s0 + t + 4) * kLd + p0 + g]);
    return {{b0, b1}, {0u, 0u}};
  } else {
    return tf32::split_b(sx[(s0 + t) * kLd + p0 + g],
                         sx[(s0 + t + 4) * kLd + p0 + g]);
  }
}

// A fragment of C rows r0 .. r0 + 15, columns n0 .. n0 + 7, paired k
// order: (a0, a2) = C[r0 + g][n0 + 2t, +1], (a1, a3) the same at r0 + g + 8.
template <int kLd>
__device__ __forceinline__ FragA c_frag(const float* sC, int r0, int n0,
                                        int g, int t) {
  const float2 lo = *reinterpret_cast<const float2*>(sC + (r0 + g) * kLd + n0 + 2 * t);
  const float2 hi = *reinterpret_cast<const float2*>(sC + (r0 + g + 8) * kLd + n0 + 2 * t);
  return tf32::split_a(lo.x, hi.x, lo.y, hi.y);
}

template <typename TX, int P, int N>
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunks(Args a) {
  using K = Layout<TX, P, N>;
  constexpr bool kExactX = K::kBf16;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* sHhi = reinterpret_cast<uint32_t*>(smem + 2 * K::kStage);
  uint32_t* sHlo = sHhi + P * K::kLdH;
  uint32_t* sMhi = sHlo + P * K::kLdH;
  uint32_t* sMlo = sMhi + kLc * K::kLdM;

  const int h = blockIdx.x, b = blockIdx.y;
  const int L = a.L, H = a.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float A = a.A[h];
  const long long bh = static_cast<long long>(b) * H + h;
  const TX* xb = static_cast<const TX*>(a.x) + b * a.x_sb + h * a.x_sh;
  const float* Bb = a.B + static_cast<long long>(b) * L * N;
  const float* Cb = a.C + static_cast<long long>(b) * L * N;
  const float* dtb = a.dt + static_cast<long long>(b) * L * H + h;
  float* yb = a.y + static_cast<long long>(b) * L * H * P + static_cast<long long>(h) * P;
  const int n_chunks = (L + kLc - 1) / kLc;

  auto sx = [&](int st) { return reinterpret_cast<TX*>(smem + st * K::kStage); };
  auto sB = [&](int st) { return reinterpret_cast<float*>(smem + st * K::kStage + K::kX); };
  auto sC = [&](int st) { return sB(st) + kLc * K::kLdBC; };
  auto sdt = [&](int st) { return sC(st) + kLc * K::kLdBC; };

  auto load_chunk = [&](int c, int st) {
    const int c0 = c * kLc;
    constexpr int kXPieces = P * static_cast<int>(sizeof(TX)) / 16;
    constexpr int kXPer = 16 / static_cast<int>(sizeof(TX));
    for (int e = tid; e < kLc * kXPieces; e += kThreads) {
      const int r = e / kXPieces, col = (e % kXPieces) * kXPer;
      const bool in = c0 + r < L;
      cp_async::copy16(sx(st) + r * K::kLdX + col,
                       xb + (in ? (c0 + r) * a.x_sl : 0) + col, in);
    }
    constexpr int kBPieces = N / 4;
    for (int e = tid; e < kLc * kBPieces; e += kThreads) {
      const int r = e / kBPieces, col = (e % kBPieces) * 4;
      const bool in = c0 + r < L;
      const long long off = static_cast<long long>(in ? c0 + r : 0) * N + col;
      cp_async::copy16(sB(st) + r * K::kLdBC + col, Bb + off, in);
      cp_async::copy16(sC(st) + r * K::kLdBC + col, Cb + off, in);
    }
    if (tid < kLc) {
      const bool in = c0 + tid < L;
      cp_async::copy4(sdt(st) + tid,
                      dtb + static_cast<long long>(in ? c0 + tid : 0) * H, in);
    }
  };

  // This warp's state tiles: rows n0 .. n0 + 15 (one m-tile for all of
  // them), columns sp0[i] .. sp0[i] + 7.
  const int tau0 = warp * K::kSPer;
  const bool has_state = tau0 < K::kSTiles;
  const int sn0 = (tau0 / K::kNT) * 16;
  float hacc[K::kSPer][4];
  const float* h0b = a.h0 + bh * N * P;
#pragma unroll
  for (int i = 0; i < K::kSPer; ++i) {
    const int p0 = ((tau0 + i) % K::kNT) * 8;
    float2 v0 = {0.f, 0.f}, v1 = {0.f, 0.f};
    if (has_state) {
      v0 = *reinterpret_cast<const float2*>(h0b + (sn0 + g) * P + p0 + 2 * t);
      v1 = *reinterpret_cast<const float2*>(h0b + (sn0 + g + 8) * P + p0 + 2 * t);
    }
    hacc[i][0] = v0.x;
    hacc[i][1] = v0.y;
    hacc[i][2] = v1.x;
    hacc[i][3] = v1.y;
  }
  // the state's TF32 parts, transposed to (P, N), for the next C h
  auto write_state = [&]() {
    if (!has_state) return;
#pragma unroll
    for (int i = 0; i < K::kSPer; ++i) {
      const int p0 = ((tau0 + i) % K::kNT) * 8;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + 2 * t + (e & 1), n = sn0 + g + 8 * (e >> 1);
        const tf32::Split s = tf32::split(hacc[i][e]);
        sHhi[p * K::kLdH + n] = s.hi;
        sHlo[p * K::kLdH + n] = s.lo;
      }
    }
  };
  write_state();

  load_chunk(0, 0);
  cp_async::commit();
  for (int c = 0; c < n_chunks; ++c) {
    const int st = c & 1, c0 = c * kLc;
    if (c + 1 < n_chunks) load_chunk(c + 1, st ^ 1);
    cp_async::commit();
    cp_async::wait<1>();               // chunk c has landed
    __syncthreads();                        // ... for every thread, with the state
    const TX* cx = sx(st);
    const float* cB = sB(st);
    const float* cC = sC(st);
    const float dtl = sdt(st)[lane];        // lane = step of the chunk

    // inclusive cumsum of dt A over the chunk, one step a lane
    float cum = dtl * A;
#pragma unroll
    for (int o = 1; o < kLc; o <<= 1) {
      const float v = __shfl_up_sync(kFull, cum, o);
      if (lane >= o) cum += v;
    }
    const float cum_last = __shfl_sync(kFull, cum, kLc - 1);

    // M = (C B^T) o exp(cum_t - cum_s) o dt_s on the causal tiles:
    // warps 0, 1 rows 0..15 with columns 0..7, 8..15; warps 2..5 rows
    // 16..31 with columns 0..31
    if (warp < 6) {
      const int r0 = warp < 2 ? 0 : 16;
      const int s0 = (warp < 2 ? warp : warp - 2) * 8;
      float cb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int n0 = 0; n0 < N; n0 += 8) {
        const FragA fa = c_frag<K::kLdBC>(cC, r0, n0, g, t);
        const float2 bv = *reinterpret_cast<const float2*>(cB + (s0 + g) * K::kLdBC + n0 + 2 * t);
        tf32::mma_step<false>(cb, fa, tf32::split_b(bv.x, bv.y));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tr = r0 + g + 8 * (e >> 1), sc = s0 + 2 * t + (e & 1);
        const float ct = __shfl_sync(kFull, cum, tr);
        const float cs = __shfl_sync(kFull, cum, sc);
        const float ds = __shfl_sync(kFull, dtl, sc);
        const float m = sc <= tr ? cb[e] * expf(ct - cs) * ds : 0.f;
        const tf32::Split s = tf32::split(m);
        sMhi[tr * K::kLdM + sc] = s.hi;
        sMlo[tr * K::kLdM + sc] = s.lo;
      }
    }

    // y = exp(cum) o (C h): rows r0 .. r0 + 15, n-tiles yn0 + 4 i
    const int r0 = (warp & 1) * 16;
    const int yn0 = warp >> 1;
    float yacc[K::kYN][4];
#pragma unroll
    for (int i = 0; i < K::kYN; ++i)
      yacc[i][0] = yacc[i][1] = yacc[i][2] = yacc[i][3] = 0.f;
#pragma unroll
    for (int n0 = 0; n0 < N; n0 += 8) {
      const FragA fa = c_frag<K::kLdBC>(cC, r0, n0, g, t);
#pragma unroll
      for (int i = 0; i < K::kYN; ++i) {
        const int p = (yn0 + 4 * i) * 8 + g;
        const uint2 hh = *reinterpret_cast<const uint2*>(sHhi + p * K::kLdH + n0 + 2 * t);
        const uint2 hl = *reinterpret_cast<const uint2*>(sHlo + p * K::kLdH + n0 + 2 * t);
        tf32::mma_step<false>(yacc[i], fa, FragB{{hh.x, hh.y}, {hl.x, hl.y}});
      }
    }
    {
      const float e0 = expf(__shfl_sync(kFull, cum, r0 + g));
      const float e1 = expf(__shfl_sync(kFull, cum, r0 + g + 8));
#pragma unroll
      for (int i = 0; i < K::kYN; ++i) {
        yacc[i][0] *= e0;
        yacc[i][1] *= e0;
        yacc[i][2] *= e1;
        yacc[i][3] *= e1;
      }
    }

    // h <- exp(cum_last) h + (B o w)^T x, w_s = exp(cum_last - cum_s) dt_s
    // (reads the chunk's B and x, not the state in shared memory)
    {
      const float wl = expf(cum_last - cum) * dtl;
      const float decay = expf(cum_last);
#pragma unroll
      for (int i = 0; i < K::kSPer; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[i][e] *= decay;
      if (has_state) {
#pragma unroll
        for (int s0 = 0; s0 < kLc; s0 += 8) {
          const float w0 = __shfl_sync(kFull, wl, s0 + t);
          const float w1 = __shfl_sync(kFull, wl, s0 + t + 4);
          const float* b0 = cB + (s0 + t) * K::kLdBC + sn0 + g;
          const float* b1 = cB + (s0 + t + 4) * K::kLdBC + sn0 + g;
          const FragA fa = tf32::split_a(b0[0] * w0, b0[8] * w0, b1[0] * w1, b1[8] * w1);
#pragma unroll
          for (int i = 0; i < K::kSPer; ++i) {
            const int p0 = ((tau0 + i) % K::kNT) * 8;
            tf32::mma_step<kExactX>(hacc[i], fa,
                                    x_frag<TX, K::kLdX>(cx, s0, p0, g, t));
          }
        }
      }
    }
    __syncthreads();                        // M is complete

    // y += M x over the causal k-steps of rows r0 .. r0 + 15; then store
#pragma unroll
    for (int s0 = 0; s0 < kLc; s0 += 8) {
      if (s0 > r0 + 8) break;               // above the diagonal: M is 0
      const int ra = (r0 + g) * K::kLdM + s0 + t, rb = ra + 8 * K::kLdM;
      const FragA fm{{sMhi[ra], sMhi[rb], sMhi[ra + 4], sMhi[rb + 4]},
                     {sMlo[ra], sMlo[rb], sMlo[ra + 4], sMlo[rb + 4]}};
#pragma unroll
      for (int i = 0; i < K::kYN; ++i)
        tf32::mma_step<kExactX>(yacc[i], fm,
                                x_frag<TX, K::kLdX>(cx, s0, (yn0 + 4 * i) * 8, g, t));
    }
#pragma unroll
    for (int i = 0; i < K::kYN; ++i) {
      const int p = (yn0 + 4 * i) * 8 + 2 * t;
      const int ta = c0 + r0 + g, tb = ta + 8;
      if (ta < L)
        *reinterpret_cast<float2*>(yb + static_cast<long long>(ta) * H * P + p) =
            make_float2(yacc[i][0], yacc[i][1]);
      if (tb < L)
        *reinterpret_cast<float2*>(yb + static_cast<long long>(tb) * H * P + p) =
            make_float2(yacc[i][2], yacc[i][3]);
    }
    __syncthreads();                        // the state and stage st are read
    write_state();
  }
  cp_async::wait<0>();
  if (has_state) {
    float* hTb = a.hT + bh * N * P;
#pragma unroll
    for (int i = 0; i < K::kSPer; ++i) {
      const int p0 = ((tau0 + i) % K::kNT) * 8;
      *reinterpret_cast<float2*>(hTb + (sn0 + g) * P + p0 + 2 * t) =
          make_float2(hacc[i][0], hacc[i][1]);
      *reinterpret_cast<float2*>(hTb + (sn0 + g + 8) * P + p0 + 2 * t) =
          make_float2(hacc[i][2], hacc[i][3]);
    }
  }
}

// L = 1: h = exp(A dt) h0 + dt B^T x, y = C h.  Thread (group, p) walks
// the rows n = group, group + G, ...; the G partial sums of y meet in
// shared memory and are added in a fixed order.
constexpr int kStepThreads = 256;

template <typename TX>
__global__ void __launch_bounds__(kStepThreads)
ssd_step(Args a, int P, int N) {
  __shared__ float sx[kStepThreads], sB[kStepThreads], sC[kStepThreads];
  __shared__ float red[kStepThreads];
  const int h = blockIdx.x, b = blockIdx.y, H = a.H, tid = threadIdx.x;
  const TX* xb = static_cast<const TX*>(a.x) + b * a.x_sb + h * a.x_sh;
  const float dt = a.dt[static_cast<long long>(b) * H + h];
  if (tid < P) sx[tid] = dt * to_f(xb[tid]);
  if (tid < N) {
    sB[tid] = a.B[static_cast<long long>(b) * N + tid];
    sC[tid] = a.C[static_cast<long long>(b) * N + tid];
  }
  __syncthreads();
  const float decay = expf(a.A[h] * dt);
  const int G = kStepThreads / P, p = tid % P, grp = tid / P;
  const long long base = (static_cast<long long>(b) * H + h) * N * P;
  float acc = 0.f;
  for (int n = grp; n < N; n += G) {
    const float hn = fmaf(decay, a.h0[base + n * P + p], sB[n] * sx[p]);
    a.hT[base + n * P + p] = hn;
    acc = fmaf(sC[n], hn, acc);
  }
  red[tid] = acc;
  __syncthreads();
  if (tid < P) {
    float s = 0.f;
    for (int q = 0; q < G; ++q) s += red[q * P + tid];
    a.y[(static_cast<long long>(b) * H + h) * P + tid] = s;
  }
}

template <typename TX, int P, int N>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(ssd_chunks<TX, P, N>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Layout<TX, P, N>::kBytes);
}

// f(TX{}, P, N) with P and N as integral constants, for the (x dtype, P,
// N) the chunk kernel is built for.
template <typename F>
cudaError_t with_chunks(int x_dtype, int P, int N, F&& f) {
  auto by_n = [&](auto tx, auto p) -> cudaError_t {
    switch (N) {
      case 16: return f(tx, p, std::integral_constant<int, 16>{});
      case 32: return f(tx, p, std::integral_constant<int, 32>{});
      case 64: return f(tx, p, std::integral_constant<int, 64>{});
      default: return cudaErrorInvalidValue;
    }
  };
  auto by_p = [&](auto tx) -> cudaError_t {
    switch (P) {
      case 32: return by_n(tx, std::integral_constant<int, 32>{});
      case 64: return by_n(tx, std::integral_constant<int, 64>{});
      case 128: return by_n(tx, std::integral_constant<int, 128>{});
      default: return cudaErrorInvalidValue;
    }
  };
  if (x_dtype == 0) return by_p(float{});
  if (x_dtype == 1) return by_p(bf16{});
  return cudaErrorInvalidValue;
}

template <typename TX>
cudaError_t launch_step(const Args& a, int Bz, int P, int N, cudaStream_t st) {
  if (kStepThreads % P || N > kStepThreads) return cudaErrorInvalidValue;
  ssd_step<TX><<<dim3(a.H, Bz), kStepThreads, 0, st>>>(a, P, N);
  return cudaGetLastError();
}


// -- backward ---------------------------------------------------------------
//
// ssd_bwd_chunks: the gradients of (y, hT), by the recurrence walked
// backward in float32 on the CUDA cores -- a first, simple design; B6's
// forward has no backward in the JAX package, whose model differentiates
// its plain chunked scan (models/mamba2.py: ssd_chunked).  One CTA of 256
// threads per (b, head); thread (n, q) holds row n of the state and of dh,
// the gradient into it, columns q E .. q E + E - 1 (E = N P / 256), in
// registers (scan_bwd.cuh).  Phase 1 walks the steps forward from h0 and
// writes the state before each chunk of kLc steps to a scratch (bnd).
// Phase 2 walks the chunks backward: it recomputes the chunk's states from
// its first into a second scratch (hist; each thread reads back only what
// it wrote, so no barrier), then walks the chunk's steps backward with
// a_t = exp(A dt_t):
//   dC_t[n] (this head's part) = sum_p dy_t[p] h_t[n, p]
//   dh += C_t (x) dy_t
//   dla_t = a_t <dh, h_{t-1}>,  ddt_t = A dla_t + <dh, B_t (x) x_t>
//   dB_t[n] (this head's part) = dt_t sum_p dh[n, p] x_t[p]
//   dx_t[p] = dt_t sum_n dh[n, p] B_t[n],  dA (this (b, head)'s part) += dt_t dla_t
//   dh *= a_t
// and writes dh0 at the end.  dx and the scalars sum over rows: shuffles
// within the warp, then the warps' partials in shared memory, added in
// warp order once a chunk.  dA, dB and dC sum over b and t, or over the
// heads: the CTA writes its parts and ssd_bwd_sum adds them in index
// order.  No atomics: two calls give the same bytes.  No exponent is
// positive: only a_t <= 1 multiplies.
//
// Bound: the chunked form's products at split TF32 on the tensor cores
// and the bytes of x, dy, dx and the rest are about equal (PERF.md); this
// design moves the recomputed states through L2 and spends several
// CUDA-core instructions a state element and step.

struct BwdArgs {
  const void* x;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  const float* h0;
  const float* dy;       // (Bz, L, H, P), contiguous
  const float* dhT;      // (Bz, H, N, P), or null: zeros
  void* dx;              // (Bz, L, H, P), x's dtype, contiguous
  float* ddt;            // (Bz, L, H)
  float* dA_part;        // (H, Bz, L)
  float* dB_part;        // (Bz, H, L, N)
  float* dC_part;        // (Bz, H, L, N)
  float* dh0;            // (Bz, H, N, P)
  float* bnd;            // (Bz H, n_chunks, N P) scratch
  float* hist;           // (Bz H, kLc, N P) scratch
  int Bz, L, H;
  long long x_sb, x_sl, x_sh;
};

__device__ __forceinline__ void from_f(float& d, float v) { d = v; }
__device__ __forceinline__ void from_f(bf16& d, float v) { d = __float2bfloat16(v); }

template <typename TX, int P, int N>
__global__ void __launch_bounds__(scan_bwd::kThreads, (N * P <= 4096) ? 2 : 1)
ssd_bwd_chunks(BwdArgs a) {
  using scan_bwd::col_sums;
  using scan_bwd::load_row;
  using scan_bwd::row_sum;
  using scan_bwd::store_row;
  using scan_bwd::warp_sum;
  constexpr int kC = scan_bwd::kLc, kT = scan_bwd::kThreads, kW = scan_bwd::kWarps;
  constexpr int kTPR = kT / N;              // threads a row
  constexpr int E = P / kTPR;               // columns a thread
  constexpr int kNP = N * P;
  static_assert(kTPR * N == kT && E * kTPR == P && kTPR <= 32, "layout");
  __shared__ float sx[kC][P], sdy[kC][P];
  __shared__ float sB[kC][N], sC[kC][N];
  __shared__ float sdt[kC], sdec[kC];
  __shared__ float part_dx[kW][kC][P];
  __shared__ float part_s[kW][kC][2];

  const int h = blockIdx.x, b = blockIdx.y;
  const int L = a.L, H = a.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = tid / kTPR, q = tid % kTPR, col0 = q * E;
  const int own = n * P + col0;             // this thread's offset in a state
  const float A = a.A[h];
  const long long bh = static_cast<long long>(b) * H + h;
  const TX* xb = static_cast<const TX*>(a.x) + b * a.x_sb + h * a.x_sh;
  const int n_chunks = (L + kC - 1) / kC;
  float* bnd = a.bnd + bh * n_chunks * kNP;
  float* hist = a.hist + bh * kC * kNP;

  // steps t0 .. t0 + n_s - 1 into shared memory: x, B, dt and the decay,
  // and with_dy dy and C
  auto stage = [&](int t0, int n_s, bool with_dy) {
    for (int e = tid; e < n_s * P; e += kT) {
      const int s = e / P, p = e % P;
      const long long t = t0 + s;
      sx[s][p] = to_f(xb[t * a.x_sl + p]);
      if (with_dy) sdy[s][p] = a.dy[((b * static_cast<long long>(L) + t) * H + h) * P + p];
    }
    for (int e = tid; e < n_s * N; e += kT) {
      const int s = e / N, m = e % N;
      const long long row = (static_cast<long long>(b) * L + t0 + s) * N + m;
      sB[s][m] = a.B[row];
      if (with_dy) sC[s][m] = a.C[row];
    }
    if (tid < n_s) {
      const float d = a.dt[(static_cast<long long>(b) * L + t0 + tid) * H + h];
      sdt[tid] = d;
      sdec[tid] = expf(A * d);
    }
  };
  auto step = [&](float (&hs)[E], int s) {
    const float dec = sdec[s], w = sdt[s] * sB[s][n];
#pragma unroll
    for (int j = 0; j < E; ++j) hs[j] = fmaf(dec, hs[j], w * sx[s][col0 + j]);
  };

  // phase 1: the state before each chunk
  {
    float hs[E];
    load_row<E>(hs, a.h0 + bh * kNP + own);
    for (int c = 0; c < n_chunks; ++c) {
      const int t0 = c * kC, n_s = min(kC, L - t0);
      store_row<E>(bnd + static_cast<long long>(c) * kNP + own, hs);
      __syncthreads();                      // the previous chunk's stage is read
      stage(t0, n_s, false);
      __syncthreads();
      for (int s = 0; s < n_s; ++s) step(hs, s);
    }
  }

  // phase 2: the chunks backward
  float g[E];
  if (a.dhT != nullptr) {
    load_row<E>(g, a.dhT + bh * kNP + own);
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j) g[j] = 0.f;
  }
  float* dCp = a.dC_part + bh * L * N;
  float* dBp = a.dB_part + bh * L * N;
  float* dAp = a.dA_part + (static_cast<long long>(h) * a.Bz + b) * L;
  TX* dxb = static_cast<TX*>(a.dx);
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kC, n_s = min(kC, L - t0);
    __syncthreads();                        // the previous chunk's stage and partials are read
    stage(t0, n_s, true);
    __syncthreads();
    // hist[s] = h_{t0 + s - 1}; hn ends as h_{t0 + n_s - 1}
    float hn[E];
    load_row<E>(hn, bnd + static_cast<long long>(c) * kNP + own);
    for (int s = 0; s < n_s; ++s) {
      store_row<E>(hist + s * kNP + own, hn);
      step(hn, s);
    }
    for (int s = n_s - 1; s >= 0; --s) {
      const int t = t0 + s;
      float hp[E], v[E];
      load_row<E>(hp, hist + s * kNP + own);
      const float Cn = sC[s][n], Bn = sB[s][n], dec = sdec[s];
      float s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const float dyj = sdy[s][col0 + j];
        s1 = fmaf(dyj, hn[j], s1);
        g[j] = fmaf(Cn, dyj, g[j]);
        s2 = fmaf(g[j], hp[j], s2);
        s3 = fmaf(g[j], sx[s][col0 + j], s3);
        v[j] = g[j] * Bn;
        g[j] *= dec;
        hn[j] = hp[j];
      }
      float s4 = s3 * Bn;
      s1 = row_sum<kTPR>(s1);
      s3 = row_sum<kTPR>(s3);
      s2 = warp_sum(s2);
      s4 = warp_sum(s4);
      if (q == 0) {
        dCp[static_cast<long long>(t) * N + n] = s1;
        dBp[static_cast<long long>(t) * N + n] = sdt[s] * s3;
      }
      if (lane == 0) {
        part_s[warp][s][0] = s2;
        part_s[warp][s][1] = s4;
      }
      col_sums<E, kTPR>(v, lane, &part_dx[warp][s][0], col0);
    }
    __syncthreads();                        // the chunk's partials are written
    for (int e = tid; e < n_s * P; e += kT) {
      const int s = e / P, p = e % P;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kW; ++w) sum += part_dx[w][s][p];
      from_f(dxb[((static_cast<long long>(b) * L + t0 + s) * H + h) * P + p], sdt[s] * sum);
    }
    if (tid < n_s) {
      float s2 = 0.f, s4 = 0.f;
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        s2 += part_s[w][tid][0];
        s4 += part_s[w][tid][1];
      }
      const float dla = sdec[tid] * s2;
      a.ddt[(static_cast<long long>(b) * L + t0 + tid) * H + h] = fmaf(A, dla, s4);
      dAp[t0 + tid] = sdt[tid] * dla;
    }
  }
  store_row<E>(a.dh0 + bh * kNP + own, g);
}

__global__ void ssd_bwd_sum(const float* in, float* out, long long outer, int K,
                            long long inner) {
  scan_bwd::sum_mid(in, out, outer, K, inner);
}

}  // namespace

extern "C" {

// x_dtype: 0 = float32, 1 = bfloat16.  x strides are in elements (batch,
// step, head; P contiguous); x's rows and B, C must be 16-byte aligned.
// Every other tensor is contiguous float32.  P is 32, 64 or 128 and N 16,
// 32 or 64.
int ssd_scan(const void* x, const void* dt, const void* A, const void* B,
             const void* C, const void* h0, void* y, void* hT, int Bz, int L,
             int H, int P, int N, long long x_sb, long long x_sl,
             long long x_sh, int x_dtype, void* stream) {
  if (Bz <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a{x, static_cast<const float*>(dt), static_cast<const float*>(A),
         static_cast<const float*>(B), static_cast<const float*>(C),
         static_cast<const float*>(h0), static_cast<float*>(y),
         static_cast<float*>(hT), L, H, x_sb, x_sl, x_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L == 1) {
    if (x_dtype == 0) return static_cast<int>(launch_step<float>(a, Bz, P, N, st));
    if (x_dtype == 1) return static_cast<int>(launch_step<bf16>(a, Bz, P, N, st));
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(with_chunks(x_dtype, P, N, [&](auto tx, auto p, auto n) {
    using TX = decltype(tx);
    constexpr int kP = decltype(p)::value, kN = decltype(n)::value;
    cudaError_t err = set_smem<TX, kP, kN>();
    if (err != cudaSuccess) return err;
    ssd_chunks<TX, kP, kN><<<dim3(H, Bz), kThreads, Layout<TX, kP, kN>::kBytes, st>>>(a);
    return cudaGetLastError();
  }));
}


// The backward of ssd_scan: x as ssd_scan takes it; dy (Bz, L, H, P) and
// dhT (Bz, H, N, P, or null for zeros) float32 and contiguous.  Out: dx
// (Bz, L, H, P) in x's dtype, ddt (Bz, L, H), dA (H,), dB and dC (Bz, L,
// N), dh0 (Bz, H, N, P), float32 and contiguous but dx.  dA_part (H, Bz,
// L), dB_part and dC_part (Bz, H, L, N), bnd (Bz H, ceil(L / 8), N P) and
// hist (Bz H, 8, N P) are float32 scratch the caller allocates.
int ssd_scan_bwd(const void* x, const void* dt, const void* A, const void* B,
                 const void* C, const void* h0, const void* dy, const void* dhT,
                 void* dx, void* ddt, void* dA, void* dB, void* dC, void* dh0,
                 void* dA_part, void* dB_part, void* dC_part, void* bnd, void* hist,
                 int Bz, int L, int H, int P, int N, long long x_sb, long long x_sl,
                 long long x_sh, int x_dtype, void* stream) {
  if (Bz <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{x, static_cast<const float*>(dt), static_cast<const float*>(A),
            static_cast<const float*>(B), static_cast<const float*>(C),
            static_cast<const float*>(h0), static_cast<const float*>(dy),
            static_cast<const float*>(dhT), dx, static_cast<float*>(ddt),
            static_cast<float*>(dA_part), static_cast<float*>(dB_part),
            static_cast<float*>(dC_part), static_cast<float*>(dh0),
            static_cast<float*>(bnd), static_cast<float*>(hist), Bz, L, H,
            x_sb, x_sl, x_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = with_chunks(x_dtype, P, N, [&](auto tx, auto p, auto n) {
    using TX = decltype(tx);
    constexpr int kP = decltype(p)::value, kN = decltype(n)::value;
    ssd_bwd_chunks<TX, kP, kN><<<dim3(H, Bz), scan_bwd::kThreads, 0, st>>>(a);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long LN = static_cast<long long>(L) * N;
  err = scan_bwd::launch_sum(ssd_bwd_sum, a.dB_part, static_cast<float*>(dB), Bz, H, LN, st);
  if (err == cudaSuccess)
    err = scan_bwd::launch_sum(ssd_bwd_sum, a.dC_part, static_cast<float*>(dC), Bz, H, LN, st);
  if (err == cudaSuccess)
    err = scan_bwd::launch_sum(ssd_bwd_sum, a.dA_part, static_cast<float*>(dA), H,
                               Bz * L, 1, st);
  return static_cast<int>(err);
}

}  // extern "C"
