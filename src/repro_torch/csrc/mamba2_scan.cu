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
// The gradients of (y, hT), chunk-parallel on the tensor cores; B6's
// forward has no backward in the JAX package, whose model differentiates
// its plain chunked scan (models/mamba2.py: ssd_chunked).  Chunks of kLc =
// 32 steps, as the forward; three stages (ref.ssd_chunked_bwd_ref is the
// same arithmetic in plain torch):
// (a) ssd_bwd_walk<.., false>: one CTA per (b, head) walks the chunks
//     forward from h0 and writes the state before each chunk to hc:
//       h <- exp(cum_last) h + (B o w)^T x,  w_s = exp(cum_last - cum_s) dt_s
// (b) ssd_bwd_walk<.., true>: the same CTA shape walks them backward from
//     dhT and writes dh_out, the gradient into the state after each chunk,
//     to dhc, and dh0 at the end:
//       dh <- exp(cum_last) dh + (C o exp(cum))^T dy
//     Both are the forward's state update (a product of N x 32 by 32 x P
//     into mma accumulators) and nothing else: 32 serial steps of a chunk,
//     not 1024 of a step; the next chunk loads while one is read.
// (c) ssd_bwd_chunk: one CTA per (chunk, head, b) computes every gradient
//     of its chunk from (h_in, dh_out), with Lmat[t,s] = exp(cum_t - cum_s)
//     (s <= t), G = C B^T, M = G o Lmat o dt_s:
//       dx = M^T dy + (B o w) dh_out
//       dM = (dy x^T) o mask,  dG = dM o Lmat o dt_s
//       dC = dG B + diag(exp cum) dy h_in^T,  dB = dG^T C + diag(w) x dh_out^T
//       ddt_tau = A S_tau + sum_t (dM o G o Lmat)[t,tau] + exp(cum_last - cum_tau) <B_tau, dh_out x_tau>
//       dA (this CTA's part) = sum dt_tau S_tau
//     with S_tau = sum_{t >= tau > s} E[t,s] + sum_{t >= tau} F_t
//     + exp(cum_last) <dh_out, h_in> + sum_{s < tau} K_s, E = dM o M,
//     F_t = exp(cum_t) dy_t . (C_t h_in), K_s = w_s <B_s, dh_out x_s>: a sum
//     of the rectangle's terms, not a difference of two suffix sums that
//     cancel.  Eight products of (16 x 8) tiles from shared memory at split
//     TF32 (scan_bwd.cuh tiles_mma, two tiles of a row a warp; x exact in
//     TF32 when bfloat16).  About 75 KB of shared memory at P = N = 64, so
//     three CTAs share an SM.
// dB and dC (this head's parts), and dA (this (b, chunk)'s part), go to
// scratch that ssd_bwd_sum adds in index order: no atomics, so two calls
// give the same bytes.  No exponent is positive: exp(cum_t - cum_s) only
// for s <= t (masked before exp), exp(cum_t) and exp(cum_last - cum_s).
// A ragged last chunk is zero-filled (zero dt, x, dy, B and C take no
// gradient and leave the state as it was).
//
// Bound: the chunked form's products at split TF32 and the bytes of x, dy,
// dx and the rest are about equal (PERF.md); the chunk states (hc, dhc)
// add 2 N P floats a chunk written and read.

__device__ __forceinline__ void from_f(float& d, float v) { d = v; }
__device__ __forceinline__ void from_f(bf16& d, float v) { d = __float2bfloat16(v); }
// d[0], d[1] = a, b in d's dtype, one 4- or 8-byte store (d 2-element aligned)
__device__ __forceinline__ void store2(float* d, float a, float b) {
  *reinterpret_cast<float2*>(d) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* d, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(d) = __floats2bfloat162_rn(a, b);
}

constexpr int kWalkStages = 2;          // the walks' ring: a chunk read, one in flight

struct WalkArgs {
  const void* X;         // x (the states) or dy (the gradient), (Bz, L, H, P)
  const float* S;        // B (the states) or C (the gradient), (Bz, L, N)
  const float* dt;
  const float* A;
  const float* init;     // h0, or dhT (null: zeros)
  float* out;            // hc or dhc, (Bz H, n_chunks, N, P)
  float* last;           // dh0 (the gradient walk)
  int L, H;
  long long X_sb, X_sl, X_sh;
};

// (a) and (b): the state tiles and the update of ssd_chunks, without y.
template <typename TW, int P, int N, bool kGrad>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_walk(WalkArgs a) {
  using K = Layout<TW, P, N>;
  constexpr bool kExactX = K::kBf16;
  constexpr int kStage = K::kX + kLc * K::kLdBC * 4 + kLc * 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int L = a.L, H = a.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float A = a.A[h];
  const long long bh = static_cast<long long>(b) * H + h;
  const TW* Xb = static_cast<const TW*>(a.X) + b * a.X_sb + h * a.X_sh;
  const float* Sb = a.S + static_cast<long long>(b) * L * N;
  const float* dtb = a.dt + static_cast<long long>(b) * L * H + h;
  const int n_chunks = (L + kLc - 1) / kLc;

  auto sX = [&](int st) { return reinterpret_cast<TW*>(smem + st * kStage); };
  auto sS = [&](int st) { return reinterpret_cast<float*>(smem + st * kStage + K::kX); };
  auto sdt = [&](int st) { return sS(st) + kLc * K::kLdBC; };
  auto load_chunk = [&](int c, int st) {
    const int c0 = c * kLc;
    constexpr int kXPieces = P * static_cast<int>(sizeof(TW)) / 16;
    constexpr int kXPer = 16 / static_cast<int>(sizeof(TW));
    for (int e = tid; e < kLc * kXPieces; e += kThreads) {
      const int r = e / kXPieces, col = (e % kXPieces) * kXPer;
      const bool in = c0 + r < L;
      cp_async::copy16(sX(st) + r * K::kLdX + col, Xb + (in ? (c0 + r) * a.X_sl : 0) + col, in);
    }
    constexpr int kSPieces = N / 4;
    for (int e = tid; e < kLc * kSPieces; e += kThreads) {
      const int r = e / kSPieces, col = (e % kSPieces) * 4;
      const bool in = c0 + r < L;
      cp_async::copy16(sS(st) + r * K::kLdBC + col,
                       Sb + static_cast<long long>(in ? c0 + r : 0) * N + col, in);
    }
    if (tid < kLc) {
      const bool in = c0 + tid < L;
      cp_async::copy4(sdt(st) + tid, dtb + static_cast<long long>(in ? c0 + tid : 0) * H, in);
    }
  };

  const int tau0 = warp * K::kSPer;
  const bool has_state = tau0 < K::kSTiles;
  const int sn0 = (tau0 / K::kNT) * 16;
  float hacc[K::kSPer][4];
#pragma unroll
  for (int i = 0; i < K::kSPer; ++i) {
    const int p0 = ((tau0 + i) % K::kNT) * 8;
    float2 v0 = {0.f, 0.f}, v1 = {0.f, 0.f};
    if (has_state && a.init != nullptr) {
      const float* ib = a.init + bh * N * P;
      v0 = *reinterpret_cast<const float2*>(ib + (sn0 + g) * P + p0 + 2 * t);
      v1 = *reinterpret_cast<const float2*>(ib + (sn0 + g + 8) * P + p0 + 2 * t);
    }
    hacc[i][0] = v0.x;
    hacc[i][1] = v0.y;
    hacc[i][2] = v1.x;
    hacc[i][3] = v1.y;
  }
  // the state before (or the gradient after) each chunk goes out through
  // shared memory, by one bulk copy that runs while the walk goes on
  // (scattered 8-byte stores from the accumulators stalled it)
  float* sOut = reinterpret_cast<float*>(smem + kWalkStages * kStage);
  // put(offset in a row-major (N, P) state, two neighbouring values) for
  // this warp's part of the state
  auto each_pair = [&](auto&& put) {
    if (!has_state) return;
#pragma unroll
    for (int i = 0; i < K::kSPer; ++i) {
      const int p0 = ((tau0 + i) % K::kNT) * 8;
      put((sn0 + g) * P + p0 + 2 * t, make_float2(hacc[i][0], hacc[i][1]));
      put((sn0 + g + 8) * P + p0 + 2 * t, make_float2(hacc[i][2], hacc[i][3]));
    }
  };
  auto store_state = [&](float* dst) {
    each_pair([&](int o, float2 v) { *reinterpret_cast<float2*>(sOut + o) = v; });
    cp_async::fence_async();
    __syncthreads();
    if (tid == 0) cp_async::bulk_store(dst, sOut, N * P * 4);
  };

  float* outb = a.out + bh * n_chunks * N * P;
  auto chunk_at = [&](int i) { return kGrad ? n_chunks - 1 - i : i; };
#pragma unroll
  for (int i = 0; i < kWalkStages - 1; ++i) {
    if (i < n_chunks) load_chunk(chunk_at(i), i);
    cp_async::commit();
  }
  for (int i = 0; i < n_chunks; ++i) {
    const int c = chunk_at(i), st = i % kWalkStages;
    const int ahead = i + kWalkStages - 1;
    if (ahead < n_chunks) load_chunk(chunk_at(ahead), ahead % kWalkStages);
    cp_async::commit();
    cp_async::wait<kWalkStages - 1>();      // chunk c has landed
    if (tid == 0) cp_async::bulk_wait_read();  // the last state is out of sOut
    __syncthreads();
    store_state(outb + static_cast<long long>(c) * N * P);
    const float dtl = sdt(st)[lane];        // lane = step of the chunk
    float cum = dtl * A;
#pragma unroll
    for (int o = 1; o < kLc; o <<= 1) {
      const float v = __shfl_up_sync(kFull, cum, o);
      if (lane >= o) cum += v;
    }
    const float cum_last = __shfl_sync(kFull, cum, kLc - 1);
    // the rows' weights: exp(cum_t) (gradient) or w_s (state)
    const float wl = kGrad ? expf(cum) : expf(cum_last - cum) * dtl;
    const float decay = expf(cum_last);
#pragma unroll
    for (int j = 0; j < K::kSPer; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) hacc[j][e] *= decay;
    if (has_state) {
      const float* cS = sS(st);
#pragma unroll
      for (int s0 = 0; s0 < kLc; s0 += 8) {
        const float w0 = __shfl_sync(kFull, wl, s0 + t);
        const float w1 = __shfl_sync(kFull, wl, s0 + t + 4);
        const float* b0 = cS + (s0 + t) * K::kLdBC + sn0 + g;
        const float* b1 = cS + (s0 + t + 4) * K::kLdBC + sn0 + g;
        const FragA fa = tf32::split_a(b0[0] * w0, b0[8] * w0, b1[0] * w1, b1[8] * w1);
#pragma unroll
        for (int j = 0; j < K::kSPer; ++j) {
          const int p0 = ((tau0 + j) % K::kNT) * 8;
          tf32::mma_step<kExactX>(hacc[j], fa, x_frag<TW, K::kLdX>(sX(st), s0, p0, g, t));
        }
      }
    }
    __syncthreads();                        // stage st is read
  }
  cp_async::wait<0>();
  if (kGrad)
    each_pair([&](int o, float2 v) { *reinterpret_cast<float2*>(a.last + bh * N * P + o) = v; });
  if (tid == 0) cp_async::bulk_wait();
}

// Shared-memory layout of ssd_bwd_chunk, in bytes unless named otherwise.
// Rows of float32 are 4 words past a multiple of 32 (a fragment's rows
// g = 0..7 on distinct banks where it reads along a row).
template <typename TX, int P, int N>
struct ChunkLayout {
  static constexpr bool kBf16 = std::is_same<TX, bf16>::value;
  static constexpr int kLdX = kBf16 ? P + 8 : P + 4;     // elements
  static constexpr int kLdY = P + 4;     // dy, h_in, dh_out rows
  static constexpr int kLdS = N + 4;     // B, C rows
  static constexpr int kLdT = kLc + 4;   // M, dG, E, dM o G o Lmat rows
  static constexpr int kX = kLc * kLdX * static_cast<int>(sizeof(TX));
  static constexpr int kNG = 2;          // n-tiles of 8 a warp's work item
  static constexpr int kFloats = kLc * kLdY + 2 * kLc * kLdS + 2 * N * kLdY
                                 + 2 * kLc * kLdT + 5 * kLc + 2 * (N / 8 / kNG) * kLc + kWarps;
  static constexpr int kBytes = kX + 4 * kFloats;
  static_assert(kX % 16 == 0, "16-byte rows");
};

struct ChunkArgs {
  const void* x;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  const float* dy;
  const float* hc;       // (Bz H, n_chunks, N, P): the state before each chunk
  const float* dhc;      // (Bz H, n_chunks, N, P): the gradient after it
  void* dx;
  float* ddt;
  float* dA_part;        // (H, Bz, n_chunks)
  float* dB_part;        // (Bz, H, L, N)
  float* dC_part;        // (Bz, H, L, N)
  int Bz, L, H;
  long long x_sb, x_sl, x_sh;
};

template <typename TX, int P, int N>
__global__ void __launch_bounds__(kThreads, 3)
ssd_bwd_chunk(ChunkArgs a) {
  using K = ChunkLayout<TX, P, N>;
  using scan_bwd::tiles_mma;
  constexpr int kNG = K::kNG;
  constexpr bool kExactX = K::kBf16;
  constexpr int kLdX = K::kLdX, kLdY = K::kLdY, kLdS = K::kLdS, kLdT = K::kLdT;
  extern __shared__ __align__(16) unsigned char smem[];
  TX* sx = reinterpret_cast<TX*>(smem);
  float* sdy = reinterpret_cast<float*>(smem + K::kX);
  float* sB = sdy + kLc * kLdY;
  float* sC = sB + kLc * kLdS;
  float* sH = sC + kLc * kLdS;             // h_in (N, P)
  float* sG = sH + N * kLdY;               // dh_out (N, P)
  float* sM = sG + N * kLdY;               // (kLc, kLdT) each: M, then E
  float* sdG = sM + kLc * kLdT;            // dG, then dM o G o Lmat
  float* sE = sM;
  float* sDG = sdG;
  float* scum = sdG + kLc * kLdT;
  float* se = scum + kLc;                  // exp(cum_t)
  float* sr = se + kLc;                    // exp(cum_last - cum_s)
  float* sw = sr + kLc;                    // w_s
  float* sdt = sw + kLc;
  float* sF = sdt + kLc;                   // (N / 8 / kNG, kLc): F_t by column group
  float* sV = sF + (N / 8 / kNG) * kLc;    // the same of <B_s, dh_out x_s> r_s
  float* sc0 = sV + (N / 8 / kNG) * kLc;   // (kWarps): <dh_out, h_in> by warp

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int L = a.L, H = a.H, n_chunks = gridDim.x;
  const int c0 = c * kLc;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long bh = static_cast<long long>(b) * H + h;
  const TX* xb = static_cast<const TX*>(a.x) + b * a.x_sb + h * a.x_sh;
  const long long HP = static_cast<long long>(H) * P;
  const float* dyb = a.dy + static_cast<long long>(b) * L * HP + static_cast<long long>(h) * P;
  const float* Bb = a.B + static_cast<long long>(b) * L * N;
  const float* Cb = a.C + static_cast<long long>(b) * L * N;
  const float* dtb = a.dt + static_cast<long long>(b) * L * H + h;
  const long long st_off = (bh * n_chunks + c) * N * P;

  {
    constexpr int kXPieces = P * static_cast<int>(sizeof(TX)) / 16;
    constexpr int kXPer = 16 / static_cast<int>(sizeof(TX));
    for (int e = tid; e < kLc * kXPieces; e += kThreads) {
      const int r = e / kXPieces, col = (e % kXPieces) * kXPer;
      const bool in = c0 + r < L;
      cp_async::copy16(sx + r * kLdX + col, xb + (in ? (c0 + r) * a.x_sl : 0) + col, in);
    }
    for (int e = tid; e < kLc * (P / 4); e += kThreads) {
      const int r = e / (P / 4), col = (e % (P / 4)) * 4;
      const bool in = c0 + r < L;
      cp_async::copy16(sdy + r * kLdY + col, dyb + (in ? c0 + r : 0) * HP + col, in);
    }
    for (int e = tid; e < kLc * (N / 4); e += kThreads) {
      const int r = e / (N / 4), col = (e % (N / 4)) * 4;
      const bool in = c0 + r < L;
      const long long off = static_cast<long long>(in ? c0 + r : 0) * N + col;
      cp_async::copy16(sB + r * kLdS + col, Bb + off, in);
      cp_async::copy16(sC + r * kLdS + col, Cb + off, in);
    }
    for (int e = tid; e < N * (P / 4); e += kThreads) {
      const int n = e / (P / 4), col = (e % (P / 4)) * 4;
      cp_async::copy16(sH + n * kLdY + col, a.hc + st_off + n * P + col, true);
      cp_async::copy16(sG + n * kLdY + col, a.dhc + st_off + n * P + col, true);
    }
    if (tid < kLc) {
      const bool in = c0 + tid < L;
      cp_async::copy4(sdt + tid, dtb + static_cast<long long>(in ? c0 + tid : 0) * H, in);
    }
    cp_async::commit();
    cp_async::wait<0>();
  }
  __syncthreads();

  // the chunk's cumsum (lane = step) and its weights
  const float A = a.A[h];
  const float dtl = sdt[lane];
  float cum = dtl * A;
#pragma unroll
  for (int o = 1; o < kLc; o <<= 1) {
    const float v = __shfl_up_sync(kFull, cum, o);
    if (lane >= o) cum += v;
  }
  const float cum_last = __shfl_sync(kFull, cum, kLc - 1);
  if (warp == 0) {
    const float r = expf(cum_last - cum);
    scum[lane] = cum;
    se[lane] = expf(cum);
    sr[lane] = r;
    sw[lane] = r * dtl;
  }
  {
    // <dh_out, h_in>, this thread's elements in a fixed order, then the warp's
    float s = 0.f;
    for (int e = tid; e < N * P; e += kThreads) {
      const int n = e / P, p = e % P;
      s = fmaf(sG[n * kLdY + p], sH[n * kLdY + p], s);
    }
    s = scan_bwd::warp_sum(s);
    if (lane == 0) sc0[warp] = s;
  }
  __syncthreads();

  auto xv = [&](int s, int p) { return to_f(sx[s * kLdX + p]); };

  // Six causal (16 x 8) tiles of G = C B^T and dy x^T (warps 0, 1 rows
  // 0..15 with columns 0..7, 8..15; warps 2..5 rows 16..31): M and dG
  // into shared memory, E and dM o G o Lmat kept in registers until the
  // products have read M and dG.  Warps 6, 7 zero the tiles above the
  // diagonal.
  const int r0 = warp < 2 ? 0 : 16;
  const int s0 = (warp < 2 ? warp : warp - 2) * 8;
  float keepE[4] = {}, keepDG[4] = {};
  if (warp < 6) {
    float cg[1][4] = {}, cd[1][4] = {};
    tiles_mma<false, false, 1>(cg, [&](int m, int k) { return sC[m * kLdS + k]; },
                               [&](int k, int n) { return sB[n * kLdS + k]; }, r0, s0, 0, N, g, t);
    tiles_mma<false, kExactX, 1>(cd, [&](int m, int k) { return sdy[m * kLdY + k]; },
                                 [&](int k, int n) { return xv(n, k); }, r0, s0, 0, P, g, t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int tr = r0 + g + 8 * (e >> 1), sc = s0 + 2 * t + (e & 1);
      float m = 0.f, dg = 0.f, ee = 0.f, dgl = 0.f;
      if (sc <= tr) {                       // masked before exp
        const float lv = expf(scum[tr] - scum[sc]);
        const float gl = cg[0][e] * lv;
        m = gl * sdt[sc];
        dg = cd[0][e] * lv * sdt[sc];
        ee = cd[0][e] * m;
        dgl = cd[0][e] * gl;
      }
      sM[tr * kLdT + sc] = m;
      sdG[tr * kLdT + sc] = dg;
      keepE[e] = ee;
      keepDG[e] = dgl;
    }
  } else {
    for (int e = tid - 6 * 32; e < 16 * 16; e += 2 * 32) {
      const int o = (e / 16) * kLdT + 16 + e % 16;
      sM[o] = sdG[o] = 0.f;
    }
  }
  __syncthreads();

  // dx (T x P), dC and dB (T x N) by work items of kNG (16 x 8) tiles of
  // a row, shared out among the warps; the partial sums of F_t and of
  // <B_s, dh_out x_s> r_s by column group
  constexpr int kPG = P / 8 / kNG, kNGr = N / 8 / kNG;
  constexpr int kXI = 2 * kPG, kSI = 2 * kNGr;
  TX* dxb = static_cast<TX*>(a.dx);
  for (int item = warp; item < kXI + 2 * kSI; item += kWarps) {
    float acc[kNG][4] = {}, side[kNG][4] = {};
    if (item < kXI) {
      const int m0 = (item / kPG) * 16, n0 = (item % kPG) * 8 * kNG;
      // M^T dy over t >= s, then (B o w) dh_out
      tiles_mma<false, false, kNG>(acc, [&](int m, int k) { return sM[k * kLdT + m]; },
                                   [&](int k, int n) { return sdy[k * kLdY + n]; }, m0, n0, m0, kLc, g, t);
      tiles_mma<false, false, kNG>(acc, [&](int m, int k) { return sB[m * kLdS + k] * sw[m]; },
                                   [&](int k, int n) { return sG[k * kLdY + n]; }, m0, n0, 0, N, g, t);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int s = m0 + g + 8 * half;
        if (c0 + s < L) {
          TX* d = dxb + ((static_cast<long long>(b) * L + c0 + s) * H + h) * P + n0 + 2 * t;
#pragma unroll
          for (int j = 0; j < kNG; ++j) {
            store2(d + 8 * j, acc[j][2 * half], acc[j][2 * half + 1]);
          }
        }
      }
    } else {
      const bool is_c = item < kXI + kSI;
      const int q = item - kXI - (is_c ? 0 : kSI);
      const int m0 = (q / kNGr) * 16, grp = q % kNGr, n0 = grp * 8 * kNG;
      if (is_c) {
        // dG B over s <= t; side = dy h_in^T
        tiles_mma<false, false, kNG>(acc, [&](int m, int k) { return sdG[m * kLdT + k]; },
                                     [&](int k, int n) { return sB[k * kLdS + n]; }, m0, n0, 0, m0 + 16, g, t);
        tiles_mma<false, false, kNG>(side, [&](int m, int k) { return sdy[m * kLdY + k]; },
                                     [&](int k, int n) { return sH[n * kLdY + k]; }, m0, n0, 0, P, g, t);
      } else {
        // dG^T C over t >= s; side = x dh_out^T
        tiles_mma<false, false, kNG>(acc, [&](int m, int k) { return sdG[k * kLdT + m]; },
                                     [&](int k, int n) { return sC[k * kLdS + n]; }, m0, n0, m0, kLc, g, t);
        tiles_mma<kExactX, false, kNG>(side, [&](int m, int k) { return xv(m, k); },
                                       [&](int k, int n) { return sG[n * kLdY + k]; }, m0, n0, 0, P, g, t);
      }
      // rows m0 + g (values 0, 1) and m0 + g + 8 (2, 3), columns n0 + 8 j + 2t, +1
      const float* rows = is_c ? sC : sB;   // F_t = e_t <C_t, side_t>; V_s = r_s <B_s, side_s>
      const float* scale = is_c ? se : sr;
      const float* wt = is_c ? se : sw;     // dC = acc + e side; dB = acc + w side
      float* part = (is_c ? a.dC_part : a.dB_part) + bh * L * N;
      float red[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + g + 8 * half;
        float v = 0.f;
#pragma unroll
        for (int j = 0; j < kNG; ++j) {
          const int n = n0 + 8 * j + 2 * t;
          const float2 rv = *reinterpret_cast<const float2*>(rows + row * kLdS + n);
          v = fmaf(rv.x, side[j][2 * half], fmaf(rv.y, side[j][2 * half + 1], v));
          if (c0 + row < L)
            *reinterpret_cast<float2*>(part + static_cast<long long>(c0 + row) * N + n) =
                make_float2(fmaf(wt[row], side[j][2 * half], acc[j][2 * half]),
                            fmaf(wt[row], side[j][2 * half + 1], acc[j][2 * half + 1]));
        }
        v += __shfl_xor_sync(kFull, v, 1);
        v += __shfl_xor_sync(kFull, v, 2);
        red[half] = v * scale[row];
      }
      if (t == 0) {
        float* out = (is_c ? sF : sV) + grp * kLc;
        out[m0 + g] = red[0];
        out[m0 + g + 8] = red[1];
      }
    }
  }
  __syncthreads();
  if (warp < 6) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int o = (r0 + g + 8 * (e >> 1)) * kLdT + s0 + 2 * t + (e & 1);
      sE[o] = keepE[e];
      sDG[o] = keepDG[e];
    }
  }
  __syncthreads();

  // ddt and this CTA's part of dA, a lane a step (warp 0)
  if (warp == 0) {
    const int tau = lane;
    float q = 0.f;                          // row tau of E: exclusive prefix sums
    for (int s = 0; s < kLc; ++s) {
      const float v = sE[tau * kLdT + s];
      sE[tau * kLdT + s] = q;
      q += v;
    }
    __syncwarp();
    float rect = 0.f, dgc = 0.f;            // sum_{t >= tau} sum_{s < tau} E[t,s]
    for (int r = tau; r < kLc; ++r) {
      rect += sE[r * kLdT + tau];
      dgc += sDG[r * kLdT + tau];
    }
    float f = 0.f, v = 0.f, c0s = 0.f;
#pragma unroll
    for (int grp = 0; grp < kNGr; ++grp) {
      f += sF[grp * kLc + tau];
      v += sV[grp * kLc + tau];
    }
#pragma unroll
    for (int w = 0; w < kWarps; ++w) c0s += sc0[w];
    const float k = dtl * v;
    // sum_{t >= tau} F_t (suffix) and sum_{s < tau} K_s (exclusive prefix)
    float fs = f, kp = k;
#pragma unroll
    for (int o = 1; o < kLc; o <<= 1) {
      const float fv = __shfl_down_sync(kFull, fs, o);
      const float kv = __shfl_up_sync(kFull, kp, o);
      if (lane + o < kLc) fs += fv;
      if (lane >= o) kp += kv;
    }
    kp = __shfl_up_sync(kFull, kp, 1);
    if (lane == 0) kp = 0.f;
    const float S = rect + fs + expf(cum_last) * c0s + kp;
    if (c0 + tau < L)
      a.ddt[(static_cast<long long>(b) * L + c0 + tau) * H + h] = fmaf(A, S, dgc + v);
    const float da = scan_bwd::warp_sum(dtl * S);
    if (lane == 0) a.dA_part[(static_cast<long long>(h) * a.Bz + b) * n_chunks + c] = da;
  }
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
// ceil(L / 32)), dB_part and dC_part (Bz, H, L, N), hc and dhc (Bz H,
// ceil(L / 32), N, P) are float32 scratch the caller allocates.
int ssd_scan_bwd(const void* x, const void* dt, const void* A, const void* B,
                 const void* C, const void* h0, const void* dy, const void* dhT,
                 void* dx, void* ddt, void* dA, void* dB, void* dC, void* dh0,
                 void* dA_part, void* dB_part, void* dC_part, void* hc, void* dhc,
                 int Bz, int L, int H, int P, int N, long long x_sb, long long x_sl,
                 long long x_sh, int x_dtype, void* stream) {
  if (Bz <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = (L + kLc - 1) / kLc;
  const float* fdt = static_cast<const float*>(dt);
  const float* fA = static_cast<const float*>(A);
  const long long LHP = static_cast<long long>(L) * H * P;
  WalkArgs states{x, static_cast<const float*>(B), fdt, fA, static_cast<const float*>(h0),
                  static_cast<float*>(hc), nullptr, L, H, x_sb, x_sl, x_sh};
  WalkArgs grads{dy, static_cast<const float*>(C), fdt, fA, static_cast<const float*>(dhT),
                 static_cast<float*>(dhc), static_cast<float*>(dh0), L, H, LHP,
                 static_cast<long long>(H) * P, P};
  ChunkArgs ca{x, fdt, fA, static_cast<const float*>(B), static_cast<const float*>(C),
               static_cast<const float*>(dy), static_cast<const float*>(hc),
               static_cast<const float*>(dhc), dx, static_cast<float*>(ddt),
               static_cast<float*>(dA_part), static_cast<float*>(dB_part),
               static_cast<float*>(dC_part), Bz, L, H, x_sb, x_sl, x_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = with_chunks(x_dtype, P, N, [&](auto tx, auto p, auto n) {
    using TX = decltype(tx);
    constexpr int kP = decltype(p)::value, kN = decltype(n)::value;
    constexpr int kOut = kN * kP * 4;         // the state on its way out
    constexpr int kWalkX = Layout<TX, kP, kN>::kX + kLc * Layout<TX, kP, kN>::kLdBC * 4 + kLc * 4;
    constexpr int kWalkDy = Layout<float, kP, kN>::kX + kLc * Layout<float, kP, kN>::kLdBC * 4 + kLc * 4;
    constexpr int kChunk = ChunkLayout<TX, kP, kN>::kBytes;
    cudaError_t e = cudaFuncSetAttribute(ssd_bwd_walk<TX, kP, kN, false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kWalkStages * kWalkX + kOut);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_bwd_walk<float, kP, kN, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kWalkStages * kWalkDy + kOut);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_bwd_chunk<TX, kP, kN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kChunk);
    if (e != cudaSuccess) return e;
    ssd_bwd_walk<TX, kP, kN, false><<<dim3(H, Bz), kThreads, kWalkStages * kWalkX + kOut, st>>>(states);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    ssd_bwd_walk<float, kP, kN, true><<<dim3(H, Bz), kThreads, kWalkStages * kWalkDy + kOut, st>>>(grads);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    ssd_bwd_chunk<TX, kP, kN><<<dim3(n_chunks, H, Bz), kThreads, kChunk, st>>>(ca);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long LN = static_cast<long long>(L) * N;
  err = scan_bwd::launch_sum(ssd_bwd_sum, static_cast<float*>(dB_part),
                             static_cast<float*>(dB), Bz, H, LN, st);
  if (err == cudaSuccess)
    err = scan_bwd::launch_sum(ssd_bwd_sum, static_cast<float*>(dC_part),
                               static_cast<float*>(dC), Bz, H, LN, st);
  if (err == cudaSuccess)
    err = scan_bwd::launch_sum(ssd_bwd_sum, static_cast<float*>(dA_part),
                               static_cast<float*>(dA), H, Bz * n_chunks, 1, st);
  return static_cast<int>(err);
}

}  // extern "C"
