// WKV6 recurrence (RWKV6 "Finch") on the tensor cores, sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/rwkv6_scan/kernel.py:
// wkv6_scan (public wrapper ops.wkv6).  It evaluates, per (b, head), with
// the key channel i and the value channel j,
//   y_t[j]   = sum_i r_t[i] (S[i,j] + u[i] k_t[i] v_t[j])
//   S[i,j]  <- w_t[i] S[i,j] + k_t[i] v_t[j],    w_t = exp(logw_t)
// from the state s0 to the final state sT.  Layout is the model's: r, k,
// v, logw (B, L, H, D), each read through its own strides (r, k, v float32
// or bfloat16; logw float32), u (H, D) and s0 (B, H, D, D) float32 and
// contiguous.  Out: y (B, L, H, D) and sT (B, H, D, D), float32.
//
// Bound on the H100: bytes.  Per step and head the recurrence does about
// 2 D^2 multiply-adds against 4 D loaded values and D stored: at D = 64
// with bfloat16 r, k, v, rwkv6-7b's prefill (4 x 1024 tokens, 64 heads)
// moves 0.073 ms of bytes and needs 0.026 ms of TF32 tensor-core work at
// three products per multiply-add.  At decode (L = 1) the state's bytes
// bound it: read and written once.
//
// Design.  Walking the steps one by one, with the state in registers,
// takes about seven instructions per state element and step and is bound
// by the instruction rate (11.7% of the bound on the H100, PERF.md).
// wkv6_chunks evaluates chunks of kT = 16 steps as the JAX kernel and the
// plain version do, with d_t = sum of logw up to t in the chunk:
//   inter:  y_t += (r_t o exp(d_{t-1})) S                  (16 x D) (D x D)
//   intra:  y_t += sum_{s<t} A[t,s] v_s, A[t,s] = sum_i r_t[i] k_s[i]
//           exp(d_{t-1}[i] - d_s[i]); bonus A[t,t] = sum_i r_t u k_t
//   state:  S <- diag(exp(d_15)) S + (k o exp(d_15 - d))^T v
// The inter, intra and state products run on the tensor cores (mma.sync
// m16n8k8 TF32); the state never leaves the CTA.
//
// Decay: no exponent is ever positive, for any logw <= 0 (it stays finite
// for every |logw|, -inf included).  The decay is per channel, so A is no
// plain product, and factoring exp(d_{t-1} - d_s) into exp(d_{t-1}) and
// exp(-d_s) across a chunk overflows float32 within a dozen steps of real
// decays.  The decays here are products of w = exp(logw) <= 1, never
// quotients: exp(d_{t-1}) and exp(d_15 - d_s) are prefix and suffix
// products over the chunk.  A factors only at block edges that lie
// between s and t: its off-diagonal block of 8 steps (t in 8..15, s in
// 0..7) is (r_t w_8 .. w_{t-1}) . (k_s w_{s+1} .. w_7), and its two
// off-diagonal blocks of 4 steps inside each half the same at steps 4 and
// 12, so both factors are products of w and <= 1; these are dot products
// over i on the tensor cores.  Its diagonal blocks of 4 steps are computed
// directly by running products along t (r_t k_s w_{s+1} .. w_{t-1}).  A
// decay that underflows is 0, which it also is in float32.
//
// Precision: split TF32 (tf32_mma.cuh).  The decayed r and k, the
// state, A and the factors of A's off-diagonal blocks are split into two
// TF32 parts (22 bits); v is exact in TF32 when it is bfloat16 and split
// when it is float32.
//
// Parallelism: one CTA of 8 warps per (b, head), two CTAs an SM (128
// registers a thread).  Splitting the value columns j across CTAs would
// compute the decays and A once per CTA.  Warps 0..3 hold the state,
// transposed, as mma accumulators (16 rows j each); an accumulator tile is
// also the B fragment of the inter product, so the state never leaves
// the registers.  Per chunk, between two barriers: (1) every warp walks 8
// steps of 32 channels forward or backward for the decays (prefix and
// suffix products, each split value stored as a (hi, lo) pair so that a
// fragment is one 16-byte load); (2) warps 0..3 run the inter product and
// the state update on the tensor cores and leave y's inter part in shared
// memory, while warps 4..7 compute A of the chunk and finish y of the
// chunk before (A v, added and stored).  The chunk's r, k, v and logw
// come by cp.async into a ring, a chunk or two ahead.
//
// Known limit: the two warp groups' work adds up rather than overlapping,
// and at 16 warps an SM each chunk's chain of dependent steps shows
// (PERF.md).
//
// wkv6_steps: a decode step (L = 1) walks its one step with the state in
// registers: a decode step is bound by the state's bytes, and there the
// chunk kernel takes twice its time; from a few steps up the chunk kernel
// is the faster (scripts/scan_decode_routes.py, PERF.md).
// A ragged last chunk is zero-filled by cp.async (zero k, v and logw leave
// the state as it was), so L need not be a multiple of kT.

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

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* logw;
  const float* u;
  const float* s0;
  float* y;
  float* sT;
  int L, H;
  // element strides (batch, step, head) of r, k, v, logw; D is contiguous
  long long s[4][3];
};

// -- wkv6_steps: one step at a time (a decode step) ------------------------

constexpr int kSplit = 4;     // threads sharing one value column j
constexpr int kTile = 32;     // steps staged in shared memory at a time

// The state lives in registers: 4 D threads, thread (j, g) holds S[i, j]
// for the D / 4 key channels i = g mod 4, and the four partial sums of
// y_t[j] meet by two warp shuffles.
template <typename T, int D>
__global__ void __launch_bounds__(D * kSplit)
wkv6_steps(Args a) {
  constexpr int kPer = D / kSplit;           // state elements per thread
  const int h = blockIdx.x, b = blockIdx.y;
  const int L = a.L, H = a.H;
  const int g = threadIdx.x % kSplit;        // key channels i = g + kSplit * ii
  const int j = threadIdx.x / kSplit;        // value channel
  __shared__ float sR[kTile][D], sK[kTile][D], sW[kTile][D], sV[kTile][D];

  const long long bh = static_cast<long long>(b) * H + h;
  float S[kPer], uk[kPer];
#pragma unroll
  for (int ii = 0; ii < kPer; ++ii) {
    const int i = g + kSplit * ii;
    S[ii] = a.s0[(bh * D + i) * D + j];
    uk[ii] = a.u[h * D + i];
  }
  const T* rb = static_cast<const T*>(a.r) + b * a.s[0][0] + h * a.s[0][2];
  const T* kb = static_cast<const T*>(a.k) + b * a.s[1][0] + h * a.s[1][2];
  const T* vb = static_cast<const T*>(a.v) + b * a.s[2][0] + h * a.s[2][2];
  const float* wb = a.logw + b * a.s[3][0] + h * a.s[3][2];
  float* yb = a.y + (static_cast<long long>(b) * L * H + h) * D;

  for (int t0 = 0; t0 < L; t0 += kTile) {
    const int nv = min(kTile, L - t0);       // steps of this tile
    __syncthreads();                         // the last tile's reads are done
    for (int e = threadIdx.x; e < nv * D; e += D * kSplit) {
      const long long t = t0 + e / D;
      const int c = e % D;
      sR[e / D][c] = to_f(rb[t * a.s[0][1] + c]);
      sK[e / D][c] = to_f(kb[t * a.s[1][1] + c]);
      sV[e / D][c] = to_f(vb[t * a.s[2][1] + c]);
      sW[e / D][c] = expf(wb[t * a.s[3][1] + c]);
    }
    __syncthreads();
    for (int t = 0; t < nv; ++t) {
      const float vj = sV[t][j];
      float acc = 0.f, ruk = 0.f;
#pragma unroll
      for (int ii = 0; ii < kPer; ++ii) {
        const int i = g + kSplit * ii;
        const float ri = sR[t][i], ki = sK[t][i];
        acc = fmaf(ri, S[ii], acc);
        ruk = fmaf(ri * uk[ii], ki, ruk);
        S[ii] = fmaf(sW[t][i], S[ii], ki * vj);
      }
      // the kSplit threads of column j are neighbouring lanes of one warp
#pragma unroll
      for (int m = 1; m < kSplit; m <<= 1) {
        acc += __shfl_xor_sync(kFull, acc, m);
        ruk += __shfl_xor_sync(kFull, ruk, m);
      }
      if (g == 0)
        yb[static_cast<long long>(t0 + t) * H * D + j] = fmaf(vj, ruk, acc);
    }
  }
#pragma unroll
  for (int ii = 0; ii < kPer; ++ii) {
    const int i = g + kSplit * ii;
    a.sT[(bh * D + i) * D + j] = S[ii];
  }
}

// -- wkv6_chunks: chunks of kT steps on the tensor cores --------------------

constexpr int kT = 16;                  // steps per chunk
constexpr int kHalf = kT / 2;           // steps per diagonal block of A
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kAWarp0 = 4;              // warps 4..7 compute A

// Row length (elements) of a staged v row: 32-bit words per row = 8 or 24
// mod 32, so the rows t = 0..3 of a fragment of v (v[t][g]) fall on
// distinct banks.
template <typename T, int D>
constexpr int v_row() {
  if (std::is_same<T, bf16>::value) {
    int ld = D + 16;
    while ((ld / 2) % 32 != 8 && (ld / 2) % 32 != 24) ld += 16;
    return ld;
  }
  return D + 8;
}

// Shared-memory layout of wkv6_chunks, in bytes unless named otherwise.
template <typename T, int D>
struct Layout {
  // a staged chunk: r and k rows of D, v rows of kLdV, logw rows of D
  static constexpr int kLdV = v_row<T, D>();
  static constexpr int kRK = kT * D * static_cast<int>(sizeof(T));
  static constexpr int kV = kT * kLdV * static_cast<int>(sizeof(T));
  static constexpr int kStage = 2 * kRK + kV + kT * D * 4;
  // a chunk's decays, each split value a (hi, lo) pair: decayed r
  // (paired-k rows, so an A fragment's two k of a row are one 16-byte
  // word); decayed k, rows t and t + 4 of each 8 steps side by side, so a
  // B fragment (k[s0 + t][i], k[s0 + t + 4][i]) is one 16-byte word; (r,
  // w) pairs; r and k of A's off-diagonal blocks of 8 and of 4 steps;
  // the chunk's decay.  Row
  // lengths in pairs, padded so that each quarter-warp's 16-byte loads
  // fall on distinct banks.
  static constexpr int kLdR = D + 8;
  static constexpr int kLdK = 2 * D + 4;
  static constexpr int kLdRW = D + 8;
  static constexpr int kLdP = D + 8;
  static constexpr int kDecays =   // 32-bit words
      2 * (kT * kLdR + kHalf * kLdK + kT * kLdRW + 4 * kHalf * kLdP) + D;
  static constexpr int kLdA = kT + 4;     // A rows
  static constexpr int kA = 2 * kT * kLdA;  // A hi and lo (words)
  static constexpr int kSWarps = D / 16;  // warps holding the state, 16 j each
  static constexpr int kYI = kSWarps * 32 * 8;   // inter part of y (words)
  // chunks staged: the one being read, the one before it (its v), and
  // kAhead in flight; two in flight where two CTAs still fit an SM
  static constexpr int kStages = sizeof(T) == 2 ? 4 : 3;
  static constexpr int kAhead = kStages - 2;
  static constexpr int kBytes = kStages * kStage + 4 * (kDecays + 2 * kA + 2 * kYI + D);
  static_assert(kRK % 16 == 0 && kV % 16 == 0 && (D * 4) % 16 == 0, "16-byte rows");
  static_assert(kDecays % 4 == 0, "16-byte decay buffers");
  static constexpr int kIT = D / 8;       // their tiles, 8 i each
  static_assert(kSWarps <= kAWarp0, "state warps and A warps apart");
};

// Pointers into one chunk's decays (Layout::kDecays words at p).
template <typename T, int D>
struct Decays {
  uint2 *rd, *kd, *rp, *kp, *r4, *k4;     // (hi, lo) pairs
  float2* rw;
  float* dec;
  __device__ explicit Decays(uint32_t* p) {
    using K = Layout<T, D>;
    rd = reinterpret_cast<uint2*>(p);
    kd = rd + kT * K::kLdR;
    rw = reinterpret_cast<float2*>(kd + kHalf * K::kLdK);
    rp = reinterpret_cast<uint2*>(rw + kT * K::kLdRW);
    kp = rp + kHalf * K::kLdP;
    r4 = kp + kHalf * K::kLdP;
    k4 = r4 + kHalf * K::kLdP;
    dec = reinterpret_cast<float*>(k4 + kHalf * K::kLdP);
  }
};

// B fragment of v (natural k order over the chunk's steps): rows s0 + t
// and s0 + t + 4 of column j0 + g; exact for bfloat16, split for float32.
template <typename T, int kLd>
__device__ __forceinline__ FragB v_frag(const T* sv, int s0, int j0, int g,
                                        int t) {
  if constexpr (std::is_same<T, bf16>::value) {
    return {{tf32::from_bf16(sv[(s0 + t) * kLd + j0 + g]),
             tf32::from_bf16(sv[(s0 + t + 4) * kLd + j0 + g])},
            {0u, 0u}};
  } else {
    return tf32::split_b(sv[(s0 + t) * kLd + j0 + g],
                         sv[(s0 + t + 4) * kLd + j0 + g]);
  }
}

// A fragment of v^T (rows j0 .. j0 + 15, natural k over steps s0 ..
// s0 + 7): a0 = v[s0 + t][j0 + g], a1 = v[s0 + t][j0 + g + 8], a2 and a3
// the same at step s0 + t + 4; exact for bfloat16, split for float32.
template <typename T, int kLd>
__device__ __forceinline__ FragA vt_frag(const T* sv, int s0, int j0, int g,
                                         int t) {
  const T* p = sv + (s0 + t) * kLd + j0 + g;
  if constexpr (std::is_same<T, bf16>::value) {
    return {{tf32::from_bf16(p[0]), tf32::from_bf16(p[8]),
             tf32::from_bf16(p[4 * kLd]), tf32::from_bf16(p[4 * kLd + 8])},
            {0u, 0u, 0u, 0u}};
  } else {
    return tf32::split_a(p[0], p[8], p[4 * kLd], p[4 * kLd + 8]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
wkv6_chunks(Args a) {
  using K = Layout<T, D>;
  constexpr bool kExactV = std::is_same<T, bf16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kStages = K::kStages;
  uint32_t* sDecays = reinterpret_cast<uint32_t*>(smem + kStages * K::kStage);
  uint32_t* sA = sDecays + K::kDecays;       // A of chunk c in buffer c % 2
  // y's inter part of chunk c in buffer c % 2, in the fragment order of
  // the state warps (warp, lane, 8 values), which the A warp kAWarp0 +
  // warp reads with the same lane
  float* sYI = reinterpret_cast<float*>(sA + 2 * K::kA);
  float* sU = sYI + 2 * K::kYI;

  const int h = blockIdx.x, b = blockIdx.y;
  const int L = a.L, H = a.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long bh = static_cast<long long>(b) * H + h;
  const T* rb = static_cast<const T*>(a.r) + b * a.s[0][0] + h * a.s[0][2];
  const T* kb = static_cast<const T*>(a.k) + b * a.s[1][0] + h * a.s[1][2];
  const T* vb = static_cast<const T*>(a.v) + b * a.s[2][0] + h * a.s[2][2];
  const float* wb = a.logw + b * a.s[3][0] + h * a.s[3][2];
  float* yb = a.y + (static_cast<long long>(b) * L * H + h) * D;
  const int n_chunks = (L + kT - 1) / kT;

  auto sr = [&](int sg) { return reinterpret_cast<T*>(smem + sg * K::kStage); };
  auto sk = [&](int sg) { return reinterpret_cast<T*>(smem + sg * K::kStage + K::kRK); };
  auto sv = [&](int sg) { return reinterpret_cast<T*>(smem + sg * K::kStage + 2 * K::kRK); };
  auto slw = [&](int sg) {
    return reinterpret_cast<float*>(smem + sg * K::kStage + 2 * K::kRK + K::kV);
  };
  const Decays<T, D> d(sDecays);
  auto a_hi = [&](int c) { return sA + (c & 1) * K::kA; };

  // This thread's 16-byte pieces of a chunk: at most one of each of r,
  // k, v and one of logw (a chunk of them fits in one pass of the CTA).
  constexpr int kPieces = D * static_cast<int>(sizeof(T)) / 16;
  constexpr int kWPieces = D / 4;
  static_assert(kT * kPieces <= kThreads && kT * kWPieces <= kThreads, "one pass");
  const bool has_rkv = tid < kT * kPieces, has_w = tid < kT * kWPieces;
  const int rkv_row = tid / kPieces, rkv_col = tid % kPieces * (16 / static_cast<int>(sizeof(T)));
  const int w_row = tid / kWPieces, w_col = tid % kWPieces * 4;
  auto load_chunk = [&](int c, int sg) {
    const int c0 = c * kT;
    if (has_rkv) {
      const bool in = c0 + rkv_row < L;
      const long long tt = in ? c0 + rkv_row : 0;
      cp_async::copy16(sr(sg) + rkv_row * D + rkv_col, rb + tt * a.s[0][1] + rkv_col, in);
      cp_async::copy16(sk(sg) + rkv_row * D + rkv_col, kb + tt * a.s[1][1] + rkv_col, in);
      cp_async::copy16(sv(sg) + rkv_row * K::kLdV + rkv_col, vb + tt * a.s[2][1] + rkv_col, in);
    }
    if (has_w) {
      const bool in = c0 + w_row < L;
      cp_async::copy16(slw(sg) + w_row * D + w_col,
                       wb + (in ? c0 + w_row : 0) * a.s[3][1] + w_col, in);
    }
  };

  // (1) The decays of chunk c, from stage sg into its buffer, by the A
  // warps, a chunk ahead of the products.  Four roles a channel i, one
  // warp a role and 32 channels: role 0 forward over steps 0..7 (r o
  // prefix product of w = decayed r), role 1 forward over 8..15 (r o
  // in-block prefix, then times block 0's decay), role 2 backward over
  // 15..8 (k o suffix = decayed k), role 3 backward over 7..0 (k o
  // in-block suffix, then times block 1's decay).  Roles 1 and 3 take the
  // other block's decay themselves, as exp of its summed log decay.
  auto walk = [&](auto role_c, int i, const T* cr, const T* ck, const float* clw) {
    constexpr int role = decltype(role_c)::value;
    constexpr bool fwd = role < 2;
    constexpr int t0 = (role == 0 || role == 3) ? 0 : kHalf;
    // the level-4 product restarts at the second half of the role's block
    // (forward) or ends at its first half (backward): r or k of A's
    // off-diagonal blocks of 4 steps, rows t % 4 + 4 (t / 8)
    constexpr int t4 = fwd ? t0 + 4 : t0 + 3;
    float part[kHalf], prod = 1.f, other_log = 0.f, prod4 = 1.f;
#pragma unroll
    for (int n = 0; n < kHalf; ++n) {
      const int tt = fwd ? t0 + n : t0 + kHalf - 1 - n;
      const float w = __expf(clw[tt * D + i]);
      float x;
      if constexpr (fwd) {
        x = to_f(cr[tt * D + i]);
        d.rw[tt * K::kLdRW + i] = make_float2(x, w);
      } else {
        x = to_f(ck[tt * D + i]);
      }
      part[n] = x * prod;
      prod *= w;
      if (fwd ? tt >= t4 : tt <= t4) {
        const tf32::Split p4 = tf32::split(x * prod4);
        (fwd ? d.r4 : d.k4)[((tt & 3) + 4 * (tt >> 3)) * K::kLdP + i] = make_uint2(p4.hi, p4.lo);
        prod4 *= w;
      }
      if constexpr (role & 1) other_log += clw[(kHalf - t0 + n) * D + i];
    }
    const float other = (role & 1) ? __expf(other_log) : 1.f;
#pragma unroll
    for (int n = 0; n < kHalf; ++n) {
      const int tt = fwd ? t0 + n : t0 + kHalf - 1 - n;
      const tf32::Split sp = tf32::split((role & 1) ? part[n] * other : part[n]);
      if constexpr (fwd) {
        d.rd[tt * K::kLdR + i] = make_uint2(sp.hi, sp.lo);
        if constexpr (role == 1) {
          const tf32::Split pp = tf32::split(part[n]);
          d.rp[n * K::kLdP + i] = make_uint2(pp.hi, pp.lo);
        }
      } else {
        const int row = (tt >> 3) * 4 + (tt & 3), col = 2 * i + ((tt >> 2) & 1);
        d.kd[row * K::kLdK + col] = make_uint2(sp.hi, sp.lo);
        if constexpr (role == 3) {
          const tf32::Split pp = tf32::split(part[n]);
          d.kp[tt * K::kLdP + i] = make_uint2(pp.hi, pp.lo);
        }
      }
    }
    if constexpr (role == 1) d.dec[i] = prod * other;
  };
  auto decays_for = [&](int sg) {
    constexpr int kUnitCh = D < 32 ? D : 32;      // channels a warp walks
    constexpr int kUnits = 4 * D / kUnitCh;       // (role, channels) units
    const T* cr = sr(sg);
    const T* ck = sk(sg);
    const float* clw = slw(sg);
    if (warp >= kUnits || lane >= kUnitCh) return;
    const int i = warp % (kUnits / 4) * kUnitCh + lane;
    switch (warp / (kUnits / 4)) {
      case 0: walk(std::integral_constant<int, 0>{}, i, cr, ck, clw); break;
      case 1: walk(std::integral_constant<int, 1>{}, i, cr, ck, clw); break;
      case 2: walk(std::integral_constant<int, 2>{}, i, cr, ck, clw); break;
      default: walk(std::integral_constant<int, 3>{}, i, cr, ck, clw); break;
    }
  };

  // (2) A of chunk c into its buffer, by the A warps.
  auto a_for = [&](int c, int sg) {
    const T* ck = sk(sg);
    uint32_t* sAHi = a_hi(c);
    uint32_t* sALo = sAHi + kT * K::kLdA;
    const int ta = tid - 32 * kAWarp0;    // 0 .. 127
    // A's diagonal blocks of 4 steps: 8 threads a column s, each over the
    // channels cg + 8 m; A[t][s] for s < t < the block's end by running
    // products along t (one per channel, so D / 8 independent chains),
    // A[s][s] the bonus
    {
      constexpr int kCh = D / 8, kQ = 4;
      const int s = ta >> 3, cg = ta & 7;
      const int end = (s & ~(kQ - 1)) + kQ;
      float acc[kQ - 1], run[kCh], bonus = 0.f;
#pragma unroll
      for (int m = 0; m < kCh; ++m) {
        const int i = cg + 8 * m;
        run[m] = to_f(ck[s * D + i]);
        bonus = fmaf(d.rw[s * K::kLdRW + i].x * sU[i], run[m], bonus);
      }
#pragma unroll
      for (int j = 0; j < kQ - 1; ++j) {
        const int tt = s + 1 + j;
        acc[j] = 0.f;
        if (tt < end) {
#pragma unroll
          for (int m = 0; m < kCh; ++m) {
            const float2 rw = d.rw[tt * K::kLdRW + cg + 8 * m];
            acc[j] = fmaf(rw.x, run[m], acc[j]);
            run[m] *= rw.y;
          }
        }
      }
#pragma unroll
      for (int o = 4; o; o >>= 1) {         // within the column's 8 lanes
        bonus += __shfl_xor_sync(kFull, bonus, o);
#pragma unroll
        for (int j = 0; j < kQ - 1; ++j)
          acc[j] += __shfl_xor_sync(kFull, acc[j], o);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int tt = cg + 8 * half;       // this lane writes A[tt][s]
        float val = tt == s ? bonus : 0.f;
#pragma unroll
        for (int j = 0; j < kQ - 1; ++j)
          if (tt == s + 1 + j) val = acc[j];
        if (tt <= s || tt < end) {          // not an off-diagonal block
          const tf32::Split sp = tf32::split(val);
          sAHi[tt * K::kLdA + s] = sp.hi;
          sALo[tt * K::kLdA + s] = sp.lo;
        }
      }
    }
    // A's off-diagonal blocks, (r o prefix from the block edge) (k o
    // suffix to it)^T, dot products over i on the tensor cores (paired k
    // over i, rows 8..15 of the fragment unused): the block of 8 steps (t
    // = 8 + g, s = 2 t, 2 t + 1) by the last warp, the two of 4 steps (rows
    // g and columns 2 t, 2 t + 1 of the same 8-step half) by the one before
    if (warp >= kWarps - 2) {
      const bool eight = warp == kWarps - 1;
      const uint2* fac_r = eight ? d.rp : d.r4;
      const uint2* fac_k = eight ? d.kp : d.k4;
      float acc[2][4] = {};
#pragma unroll
      for (int i0 = 0; i0 < D; i0 += 8) {
        const int ra = g * K::kLdP + i0 + 2 * t;
        const uint4 r = *reinterpret_cast<const uint4*>(fac_r + ra);
        const uint4 k = *reinterpret_cast<const uint4*>(fac_k + ra);
        tf32::mma_step<false>(acc[(i0 >> 3) & 1],
                              FragA{{r.x, 0u, r.z, 0u}, {r.y, 0u, r.w, 0u}},
                              FragB{{k.x, k.z}, {k.y, k.w}});
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 2 * t + e;
        const int tt = eight ? kHalf + g : (g & 3) + 4 + 8 * (g >> 2);
        const int sc = eight ? n : (n & 3) + 8 * (n >> 2);
        if (eight || (g >> 2) == (n >> 2)) {
          const tf32::Split sp = tf32::split(acc[0][e] + acc[1][e]);
          sAHi[tt * K::kLdA + sc] = sp.hi;
          sALo[tt * K::kLdA + sc] = sp.lo;
        }
      }
    }
  };

  // (3) The state, transposed: warp w < kSWarps holds S^T rows j = jm0 ..
  // jm0 + 15 and every column i, as kIT accumulator tiles of 8 columns.
  // A tile's accumulator is also the B fragment of the inter product
  // (paired k over i): no copy of the state in shared memory.
  const bool state_warp = warp < K::kSWarps;
  const int jm0 = warp * 16;
  float sacc[K::kIT][4];
  const float* s0b = a.s0 + bh * D * D;
#pragma unroll
  for (int it = 0; it < K::kIT; ++it)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sacc[it][e] = state_warp ? s0b[(it * 8 + 2 * t + (e & 1)) * D + jm0 + g + 8 * (e >> 1)]
                               : 0.f;
  float yacc[2][4];
  auto yi_of = [&](int c, int w) {
    return reinterpret_cast<float4*>(sYI + (c & 1) * K::kYI + (w * 32 + lane) * 8);
  };

  // y of chunk c on columns jm0 .. jm0 + 15 by A warp kAWarp0 + jm0 / 16:
  // its inter part, left by the state warp, plus A v; then stored
  auto finish_y = [&](int c, int sg) {
    const int w = warp - kAWarp0, jm0 = w * 16;
    const T* cv = sv(sg);
    const uint32_t* sAHi = a_hi(c);
    const uint32_t* sALo = sAHi + kT * K::kLdA;
    FragA fa[2];
    FragB fb[2][2];
    float part[2][2][4] = {};
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int aa = g * K::kLdA + 8 * kk + t, ab = aa + 8 * K::kLdA;
      fa[kk] = FragA{{sAHi[aa], sAHi[ab], sAHi[aa + 4], sAHi[ab + 4]},
                     {sALo[aa], sALo[ab], sALo[aa + 4], sALo[ab + 4]}};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        fb[kk][nt] = v_frag<T, K::kLdV>(cv, 8 * kk, jm0 + 8 * nt, g, t);
    }
#pragma unroll
    for (int pass = 0; pass < 3; ++pass)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          tf32::mma_pass<kExactV>(part[kk][nt], fa[kk], fb[kk][nt], pass);
    const float4* yi = yi_of(c, w);
    const int ta = c * kT + g, tb = ta + 8;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const float4 inter = yi[nt];
      float y[4] = {inter.x, inter.y, inter.z, inter.w};
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) y[e] += part[kk][nt][e];
      const int j = jm0 + 8 * nt + 2 * t;
      if (ta < L)
        *reinterpret_cast<float2*>(yb + static_cast<long long>(ta) * H * D + j) =
            make_float2(y[0], y[1]);
      if (tb < L)
        *reinterpret_cast<float2*>(yb + static_cast<long long>(tb) * H * D + j) =
            make_float2(y[2], y[3]);
    }
  };

  // The products of chunk c by the state warps: yacc = (r o exp(d_{t-1}))
  // S (paired k over i, the state's tiles as B fragments, two k-steps at a
  // time), then S^T <- S^T diag(exp(d_15)) + v^T (k o exp(d_15 - d))
  // (natural k over the chunk's steps, four tiles at a time, both k-steps
  // summed before the rounded add)
  auto products = [&](int c, int sg) {
    const T* cv = sv(sg);
#pragma unroll
    for (int it = 0; it < K::kIT; it += 2) {
      FragA fa[2];
      FragB fb[2][2];
      float part[2][2][4] = {};
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int ra = g * K::kLdR + (it + kk) * 8 + 2 * t;
        const uint4 q0 = *reinterpret_cast<const uint4*>(d.rd + ra);
        const uint4 q1 = *reinterpret_cast<const uint4*>(d.rd + ra + 8 * K::kLdR);
        fa[kk] = FragA{{q0.x, q1.x, q0.z, q1.z}, {q0.y, q1.y, q0.w, q1.w}};
        fb[kk][0] = tf32::split_b(sacc[it + kk][0], sacc[it + kk][1]);
        fb[kk][1] = tf32::split_b(sacc[it + kk][2], sacc[it + kk][3]);
      }
#pragma unroll
      for (int pass = 0; pass < 3; ++pass)
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            tf32::mma_pass<false>(part[kk][nt], fa[kk], fb[kk][nt], pass);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          yacc[nt][e] = (it == 0 ? 0.f : yacc[nt][e]) + part[0][nt][e] + part[1][nt][e];
    }
    float4* yi = yi_of(c, warp);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
      yi[nt] = make_float4(yacc[nt][0], yacc[nt][1], yacc[nt][2], yacc[nt][3]);
#pragma unroll
    for (int it = 0; it < K::kIT; ++it) {
      const float2 dd = *reinterpret_cast<const float2*>(d.dec + it * 8 + 2 * t);
      sacc[it][0] *= dd.x;
      sacc[it][1] *= dd.y;
      sacc[it][2] *= dd.x;
      sacc[it][3] *= dd.y;
    }
    constexpr int kGroup = K::kIT < 4 ? K::kIT : 4;
#pragma unroll
    for (int i0 = 0; i0 < K::kIT; i0 += kGroup) {
      float part[kGroup][4] = {};
#pragma unroll
      for (int s0 = 0; s0 < kT; s0 += 8) {
        const FragA fv = vt_frag<T, K::kLdV>(cv, s0, jm0, g, t);
        FragB fk[kGroup];
#pragma unroll
        for (int q = 0; q < kGroup; ++q) {
          const uint4 kq = *reinterpret_cast<const uint4*>(
              d.kd + (s0 / 2 + t) * K::kLdK + 2 * ((i0 + q) * 8 + g));
          fk[q] = FragB{{kq.x, kq.z}, {kq.y, kq.w}};
        }
#pragma unroll
        for (int pass = 0; pass < 3; ++pass)
#pragma unroll
          for (int q = 0; q < kGroup; ++q)
            tf32::mma_pass<false, kExactV>(part[q], fv, fk[q], pass);
      }
#pragma unroll
      for (int q = 0; q < kGroup; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[i0 + q][e] += part[q][e];
    }
  };

  // Per chunk c: every warp computes the decays of chunk c; then the
  // state warps run the products of chunk c, while the A warps compute A
  // of chunk c and finish y of chunk c - 1.  Chunk c + kAhead loads while
  // chunk c and v of chunk c - 1 are read.
  if (tid < D) sU[tid] = a.u[h * D + tid];
#pragma unroll
  for (int c = 0; c < K::kAhead; ++c) {
    if (c < n_chunks) load_chunk(c, c);
    cp_async::commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    const int sg = c % kStages;
    cp_async::wait<K::kAhead - 1>();
    __syncthreads();                        // chunk c has landed; chunk c - 1 is done
    if (c + K::kAhead < n_chunks) load_chunk(c + K::kAhead, (c + K::kAhead) % kStages);
    cp_async::commit();
    decays_for(sg);
    __syncthreads();                        // the decays of chunk c are complete
    if (state_warp) {
      products(c, sg);
    } else if (warp >= kAWarp0) {
      a_for(c, sg);
      if (c > 0 && warp < kAWarp0 + K::kSWarps) finish_y(c - 1, (c - 1) % kStages);
    }
  }
  cp_async::wait<0>();
  __syncthreads();                          // A of the last chunk is complete
  if (warp >= kAWarp0 && warp < kAWarp0 + K::kSWarps)
    finish_y(n_chunks - 1, (n_chunks - 1) % kStages);
  if (state_warp) {
    float* sTb = a.sT + bh * D * D;
#pragma unroll
    for (int it = 0; it < K::kIT; ++it)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sTb[(it * 8 + 2 * t + (e & 1)) * D + jm0 + g + 8 * (e >> 1)] = sacc[it][e];
  }
}

template <typename T, int D>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(wkv6_chunks<T, D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Layout<T, D>::kBytes);
}

// f(T{}, D) with D as an integral constant, for the (r/k/v dtype, D) the
// kernels are built for.
template <typename F>
cudaError_t with_kernels(int rkv_dtype, int D, F&& f) {
  auto by_d = [&](auto tx) -> cudaError_t {
    switch (D) {
      case 16: return f(tx, std::integral_constant<int, 16>{});
      case 32: return f(tx, std::integral_constant<int, 32>{});
      case 64: return f(tx, std::integral_constant<int, 64>{});
      default: return cudaErrorInvalidValue;
    }
  };
  if (rkv_dtype == 0) return by_d(float{});
  if (rkv_dtype == 1) return by_d(bf16{});
  return cudaErrorInvalidValue;
}


// -- backward ---------------------------------------------------------------
//
// The gradients of (y, sT), chunk-parallel; B5's forward has no backward
// in the JAX package, whose model differentiates its plain chunked scan
// (models/rwkv6.py: wkv6_chunked).  Chunks of kBT = 32 steps; three stages
// (ref.wkv6_chunked_bwd_ref is the same arithmetic in plain torch), with
// the key channel i, p_t = sum_{m<t} logw_m and q_s = sum_{m>s} logw_m
// (direct sums over the chunk, both <= 0):
// (a) wkv6_bwd_walk<.., false>: one CTA per (b, head) walks the chunks
//     forward from s0 and writes the state before each chunk to sc:
//       S <- diag(exp(d_last)) S + (k o exp(q))^T v
// (b) wkv6_bwd_walk<.., true>: the same backward from dsT, writing dS_out,
//     the gradient into the state after each chunk, to dsc, and ds0:
//       dS <- diag(exp(d_last)) dS + (r o exp(p))^T dy
//     Each is a (D x 32) by (32 x D) product into mma accumulators a chunk
//     (split TF32), the rows' weights walked per channel: 32 serial steps
//     of a chunk, not 1024 of a step; the next chunk loads while one is
//     read.
// (c) wkv6_bwd_chunk: one CTA per (chunk, head, b) computes every gradient
//     of its chunk from (S_in, dS_out).  With Pi[t,s] = prod_{s<m<t} w_m
//     (a running product of decays <= 1), dA[t,s] = dy_t . v_s and
//     A[t,s] = sum_i r_t k_s Pi[t,s]:
//       dr_t = exp(p_t) S_in dy_t + sum_{s<t} dA[t,s] k_s Pi + u k_t dA[t,t]
//       dk_s = exp(q_s) dS_out v_s + sum_{t>s} dA[t,s] r_t Pi + u r_s dA[s,s]
//       dv_s = sum_{t>s} A[t,s] dy_t + <r_s, u o k_s> dy_s + (k_s o exp(q_s)) dS_out
//       du (this CTA's part) = sum_t r_t o k_t dA[t,t]
//       dlogw_tau = sum_{t > tau > s} r_t k_s Pi[t,s] dA[t,s]
//                   + sum_{t > tau} r_t exp(p_t) (S_in dy_t)
//                   + exp(d_last) <S_in, dS_out>_j + sum_{s < tau} k_s exp(q_s) (dS_out v_s)
//     dlogw is a sum of the terms over the strict rectangle, prefixes and
//     suffixes, never a difference of reverse cumulative sums (of r o dr
//     and k o dk) that cancel.  dA, S_in dy, dS_out v and (k o exp(q))
//     dS_out are products of tiles on the tensor cores (split TF32,
//     scan_bwd.cuh tiles_mma; v exact in TF32 when bfloat16).  The pairs
//     (t, s) factor at the chunk's half: for t >= 16 > s, Pi = P_t Q_s with
//     P_t = prod_{16<=m<t} w_m and Q_s = prod_{s<m<16} w_m (both products
//     of decays <= 1), so that block's A, its dr and dk parts are tile
//     products too, and its share of dlogw's rectangle is a prefix sum of
//     k_s (dk's part)_s (tau < 16) or a suffix sum of r_t (dr's part)_t
//     (tau >= 16).  The pairs of the two diagonal blocks (t, s in one half)
//     run on the CUDA cores, per channel: two groups of threads a channel,
//     each owning every other column s, walk the half's rows backward with
//     the running product, the rectangle's column sums and dk's sums in
//     registers; the other warps compute those blocks' A a row a warp,
//     summing over the channels by shuffles (scan_bwd.cuh lane_sums).
// du's parts go to scratch that wkv6_bwd_sum adds in index order: no
// atomics, so two calls give the same bytes.  No exponent is positive:
// only exp(p), exp(q), exp(logw) and products of them.  A ragged last
// chunk is zero-filled (zero r, k, v, dy and log decay take no gradient
// and leave the state as it was).
//
// Bound: bytes (r, k, v and their gradients, logw, dlogw and dy, PERF.md);
// the chunk states (sc, dsc) add 2 D^2 floats a chunk written and read.

constexpr int kBT = 32;                 // steps per chunk of the backward
constexpr int kWalkStages = 2;          // the walks' ring: a chunk read, one in flight

__device__ __forceinline__ void from_f(float& d, float x) { d = x; }
__device__ __forceinline__ void from_f(bf16& d, float x) { d = __float2bfloat16(x); }
// d[0], d[1] = a, b in d's dtype, one 4- or 8-byte store (d 2-element aligned)
__device__ __forceinline__ void store2(float* d, float a, float b) {
  *reinterpret_cast<float2*>(d) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* d, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(d) = __floats2bfloat162_rn(a, b);
}

struct WalkArgs {
  const void* src;       // k (the states) or r (the gradient)
  const float* logw;
  const void* X;         // v (the states) or dy (the gradient), (B, L, H, D)
  const float* init;     // s0, or dsT (null: zeros)
  float* out;            // sc or dsc, (B H, n_chunks, D, D)
  float* last;           // ds0 (the gradient walk)
  int L, H;
  long long s[3][3];     // element strides (batch, step, head) of src, logw, X
};

// Shared-memory layout of wkv6_bwd_walk: a ring of two chunks of the
// rows' source (k or r), logw and the operand X (v or dy); the rows'
// weights and the chunk's decay.
template <typename TS, typename TW, int D>
struct WalkLayout {
  static constexpr int kLdX = v_row<TW, D>();
  static constexpr int kLdW = D + 8;       // weights: rows s, column i
  static constexpr int kSrc = kBT * D * static_cast<int>(sizeof(TS));
  static constexpr int kLw = kBT * D * 4;
  static constexpr int kX = kBT * kLdX * static_cast<int>(sizeof(TW));
  static constexpr int kStage = kSrc + kLw + kX;
  static constexpr int kBytes = kWalkStages * kStage + 4 * (kBT * kLdW + D + D * D);
  static_assert(kSrc % 16 == 0 && kX % 16 == 0 && (kBT * kLdW + D) % 4 == 0, "16-byte rows");
  // the state's (16 x 8) tiles, shared out among the warps as ssd_chunks'
  static constexpr int kNT = D / 8;
  static constexpr int kSTiles = (D / 16) * kNT;
  static constexpr int kSPer = (kSTiles + kWarps - 1) / kWarps;
  static_assert(kNT % kSPer == 0, "a warp's state tiles share their rows");
};

template <typename TS, typename TW, int D, bool kGrad>
__global__ void __launch_bounds__(kThreads, 2)
wkv6_bwd_walk(WalkArgs a) {
  using K = WalkLayout<TS, TW, D>;
  constexpr bool kExactX = std::is_same<TW, bf16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sWa = reinterpret_cast<float*>(smem + kWalkStages * K::kStage);
  float* sDec = sWa + kBT * K::kLdW;
  const int h = blockIdx.x, b = blockIdx.y;
  const int L = a.L, H = a.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long bh = static_cast<long long>(b) * H + h;
  const TS* srcb = static_cast<const TS*>(a.src) + b * a.s[0][0] + h * a.s[0][2];
  const float* lwb = a.logw + b * a.s[1][0] + h * a.s[1][2];
  const TW* Xb = static_cast<const TW*>(a.X) + b * a.s[2][0] + h * a.s[2][2];
  const int n_chunks = (L + kBT - 1) / kBT;

  auto sSrc = [&](int st) { return reinterpret_cast<TS*>(smem + st * K::kStage); };
  auto sLw = [&](int st) { return reinterpret_cast<float*>(smem + st * K::kStage + K::kSrc); };
  auto sX = [&](int st) {
    return reinterpret_cast<TW*>(smem + st * K::kStage + K::kSrc + K::kLw);
  };
  auto load_chunk = [&](int c, int st) {
    const int c0 = c * kBT;
    constexpr int kSP = D * static_cast<int>(sizeof(TS)) / 16, kSE = 16 / static_cast<int>(sizeof(TS));
    constexpr int kXP = D * static_cast<int>(sizeof(TW)) / 16, kXE = 16 / static_cast<int>(sizeof(TW));
    for (int e = tid; e < kBT * kSP; e += kThreads) {
      const int r = e / kSP, col = (e % kSP) * kSE;
      const bool in = c0 + r < L;
      cp_async::copy16(sSrc(st) + r * D + col, srcb + (in ? c0 + r : 0) * a.s[0][1] + col, in);
    }
    for (int e = tid; e < kBT * (D / 4); e += kThreads) {
      const int r = e / (D / 4), col = (e % (D / 4)) * 4;
      const bool in = c0 + r < L;
      cp_async::copy16(sLw(st) + r * D + col, lwb + (in ? c0 + r : 0) * a.s[1][1] + col, in);
    }
    for (int e = tid; e < kBT * kXP; e += kThreads) {
      const int r = e / kXP, col = (e % kXP) * kXE;
      const bool in = c0 + r < L;
      cp_async::copy16(sX(st) + r * K::kLdX + col, Xb + (in ? c0 + r : 0) * a.s[2][1] + col, in);
    }
  };

  const int tau0 = warp * K::kSPer;
  const bool has_state = tau0 < K::kSTiles;
  const int sn0 = (tau0 / K::kNT) * 16, sp0 = (tau0 % K::kNT) * 8;
  float hacc[K::kSPer][4];
#pragma unroll
  for (int j = 0; j < K::kSPer; ++j) {
    const int p0 = sp0 + 8 * j;
    float2 v0 = {0.f, 0.f}, v1 = {0.f, 0.f};
    if (has_state && a.init != nullptr) {
      const float* ib = a.init + bh * D * D;
      v0 = *reinterpret_cast<const float2*>(ib + (sn0 + g) * D + p0 + 2 * t);
      v1 = *reinterpret_cast<const float2*>(ib + (sn0 + g + 8) * D + p0 + 2 * t);
    }
    hacc[j][0] = v0.x;
    hacc[j][1] = v0.y;
    hacc[j][2] = v1.x;
    hacc[j][3] = v1.y;
  }
  // the state before (or the gradient after) each chunk goes out through
  // shared memory, by one bulk copy that runs while the walk goes on
  // (scattered 8-byte stores from the accumulators stalled it)
  float* sOut = sDec + D;                   // (D, D)
  // put(offset in a row-major (D, D) state, two neighbouring values) for
  // this warp's part of the state
  auto each_pair = [&](auto&& put) {
    if (!has_state) return;
#pragma unroll
    for (int j = 0; j < K::kSPer; ++j) {
      const int p0 = sp0 + 8 * j;
      put((sn0 + g) * D + p0 + 2 * t, make_float2(hacc[j][0], hacc[j][1]));
      put((sn0 + g + 8) * D + p0 + 2 * t, make_float2(hacc[j][2], hacc[j][3]));
    }
  };
  auto store_state = [&](float* dst) {
    each_pair([&](int o, float2 v) { *reinterpret_cast<float2*>(sOut + o) = v; });
    cp_async::fence_async();
    __syncthreads();
    if (tid == 0) cp_async::bulk_store(dst, sOut, D * D * 4);
  };

  float* outb = a.out + bh * n_chunks * D * D;
  auto chunk_at = [&](int n) { return kGrad ? n_chunks - 1 - n : n; };
#pragma unroll
  for (int n = 0; n < kWalkStages - 1; ++n) {
    if (n < n_chunks) load_chunk(chunk_at(n), n);
    cp_async::commit();
  }
  for (int n = 0; n < n_chunks; ++n) {
    const int c = chunk_at(n), st = n % kWalkStages;
    const int ahead = n + kWalkStages - 1;
    if (ahead < n_chunks) load_chunk(chunk_at(ahead), ahead % kWalkStages);
    cp_async::commit();
    cp_async::wait<kWalkStages - 1>();      // chunk c has landed
    if (tid == 0) cp_async::bulk_wait_read();  // the last state is out of sOut
    __syncthreads();
    store_state(outb + static_cast<long long>(c) * D * D);
    // the rows' weights, a thread a channel: r_t exp(p_t) (gradient) or
    // k_s exp(q_s) (state), and the chunk's decay exp(d_last)
    if (tid < D) {
      const TS* cs = sSrc(st);
      const float* clw = sLw(st);
      float run = 0.f;
#pragma unroll 4
      for (int n2 = 0; n2 < kBT; ++n2) {
        const int s = kGrad ? n2 : kBT - 1 - n2;
        sWa[s * K::kLdW + tid] = to_f(cs[s * D + tid]) * expf(run);
        run += clw[s * D + tid];
      }
      sDec[tid] = expf(run);
    }
    __syncthreads();
    if (has_state) {
      const float d0 = sDec[sn0 + g], d1 = sDec[sn0 + g + 8];
#pragma unroll
      for (int j = 0; j < K::kSPer; ++j) {
        hacc[j][0] *= d0;
        hacc[j][1] *= d0;
        hacc[j][2] *= d1;
        hacc[j][3] *= d1;
      }
      const TW* cx = sX(st);
      scan_bwd::tiles_mma<false, kExactX, K::kSPer>(
          hacc, [&](int m, int k) { return sWa[k * K::kLdW + m]; },
          [&](int k, int n2) { return to_f(cx[k * K::kLdX + n2]); }, sn0, sp0, 0, kBT, g, t);
    }
    __syncthreads();                        // stage st and the weights are read
  }
  cp_async::wait<0>();
  if (kGrad)
    each_pair([&](int o, float2 v) { *reinterpret_cast<float2*>(a.last + bh * D * D + o) = v; });
  if (tid == 0) cp_async::bulk_wait();
}

struct ChunkArgs {
  const void* r;
  const void* k;
  const void* v;
  const float* logw;
  const float* u;
  const float* dy;       // (B, L, H, D), contiguous
  const float* sc;       // (B H, n_chunks, D, D): the state before each chunk
  const float* dsc;      // (B H, n_chunks, D, D): the gradient after it
  void* dr;              // (B, L, H, D), r's dtype, contiguous; dk and dv alike
  void* dk;
  void* dv;
  float* dlogw;          // (B, L, H, D)
  float* du_part;        // (B, n_chunks, H, D)
  int L, H;
  long long s[4][3];     // element strides (batch, step, head) of r, k, v, logw
};

// Shared-memory layout of wkv6_bwd_chunk, in bytes: rows of D float32
// padded to kLd floats (4 words past a multiple of 32); r, k and v kept in
// their own dtype (rows of kLdX elements, 16-byte aligned).
template <typename T, int D>
struct ChunkLayout {
  static constexpr int kLd = D + 4;
  static constexpr int kLdX = std::is_same<T, bf16>::value ? D + 8 : D + 4;
  static constexpr int kLdT = kBT + 4;
  static constexpr int kTD = kBT * kLd * 4;                  // a (kBT, D) float32 array
  static constexpr int kX = kBT * kLdX * static_cast<int>(sizeof(T));
  static constexpr int kVA = kX > kBT * kLdT * 4 ? kX : kBT * kLdT * 4;      // v, then A
  static constexpr int kRows = (D > kBT ? D : kBT) * kLd * 4;                // S_in, then sums
  static constexpr int kGP = D * kLd > 2 * kBT * D ? D * kLd * 4 : 2 * kBT * D * 4;
  // r, k, v (then A); w (logw, then exp(logw)), dy; exp(p) then dr's sums;
  // exp(q); dk's state part; S_in then dlogw's sums; dS_out then the
  // second pair group's dr and rectangle sums; dA; and the vectors
  static constexpr int oK = kX, oV = 2 * kX, oW = 2 * kX + kVA;
  static constexpr int oDy = oW + kTD, oDrI = oDy + kTD, oQd = oDrI + kTD, oDkS = oQd + kTD;
  static constexpr int oS = oDkS + kTD, oG = oS + kRows, oDA = oG + kGP;
  static constexpr int oVec = oDA + kBT * kLdT * 4;
  static constexpr int kHB = kBT / 2;         // steps a half of the chunk
  // the off-diagonal block's factors: r P, k Q, P then dr's part, Q then
  // dk's part, (kHB, kLd) each
  static constexpr int oPair = oVec + 4 * (2 * D + kBT);
  static constexpr int kBytes = oPair + 4 * 4 * kHB * kLd;
  static_assert(kX % 16 == 0 && kVA % 16 == 0, "16-byte rows");
  static constexpr int kCW = (D + 31) / 32;   // warps a channel a thread
  static constexpr int kNA = kWarps - 2 * kCW;   // warps computing A
  static constexpr int kNG = 2;               // n-tiles of 8 a warp's work item
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
wkv6_bwd_chunk(ChunkArgs a) {
  using K = ChunkLayout<T, D>;
  using scan_bwd::tiles_mma;
  constexpr bool kExactV = std::is_same<T, bf16>::value;
  constexpr int kLd = K::kLd, kLdX = K::kLdX, kLdT = K::kLdT, kNG = K::kNG, kCW = K::kCW;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sr = reinterpret_cast<T*>(smem);
  T* sk = reinterpret_cast<T*>(smem + K::oK);
  T* sv = reinterpret_cast<T*>(smem + K::oV);
  float* sA = reinterpret_cast<float*>(smem + K::oV);     // (kBT, kLdT), once v is read
  float* sw = reinterpret_cast<float*>(smem + K::oW);     // logw, then w = exp(logw)
  float* sdy = reinterpret_cast<float*>(smem + K::oDy);
  float* sdrI = reinterpret_cast<float*>(smem + K::oDrI); // exp(p_t); exp(p_t) (S_in dy_t); + pairs
  float* sQd = reinterpret_cast<float*>(smem + K::oQd);   // exp(q_s)
  float* sdkS = reinterpret_cast<float*>(smem + K::oDkS); // exp(q_s) (dS_out v_s)
  float* sS = reinterpret_cast<float*>(smem + K::oS);     // S_in; then dlogw's sums
  float* sG = reinterpret_cast<float*>(smem + K::oG);     // dS_out; then the second group's sums
  float* sdA = reinterpret_cast<float*>(smem + K::oDA);   // (kBT, kLdT)
  float* sC0 = reinterpret_cast<float*>(smem + K::oVec);  // exp(d_last) <S_in, dS_out>_j
  float* sU = sC0 + D;
  float* sRuk = sU + D;                     // <r_t, u o k_t>
  // the off-diagonal block (t >= kHB > s) of the pairs, Pi[t,s] = P_t Q_s
  // with P_t = prod_{kHB<=m<t} w_m and Q_s = prod_{s<m<kHB} w_m
  float* sRP = reinterpret_cast<float*>(smem + K::oPair);   // r_t P_t, rows t - kHB
  float* sKQ = sRP + K::kHB * kLd;                          // k_s Q_s
  float* sP = sKQ + K::kHB * kLd;                           // P_t, then dr's part
  float* sQ = sP + K::kHB * kLd;                            // Q_s, then dk's part
  auto rv = [&](int s, int i) { return to_f(sr[s * kLdX + i]); };
  auto kv = [&](int s, int i) { return to_f(sk[s * kLdX + i]); };

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int L = a.L, H = a.H, n_chunks = gridDim.x;
  const int c0 = c * kBT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long bh = static_cast<long long>(b) * H + h;
  const long long st_off = (bh * n_chunks + c) * D * D;
  const long long HD = static_cast<long long>(H) * D;
  const long long row0 = (static_cast<long long>(b) * L + c0) * HD + static_cast<long long>(h) * D;

  // the chunk into shared memory by cp.async (zero past L)
  {
    const T* src[3] = {static_cast<const T*>(a.r) + b * a.s[0][0] + h * a.s[0][2],
                       static_cast<const T*>(a.k) + b * a.s[1][0] + h * a.s[1][2],
                       static_cast<const T*>(a.v) + b * a.s[2][0] + h * a.s[2][2]};
    T* dst[3] = {sr, sk, sv};
    constexpr int kXP = D * static_cast<int>(sizeof(T)) / 16, kXE = 16 / static_cast<int>(sizeof(T));
#pragma unroll
    for (int x = 0; x < 3; ++x)
      for (int e = tid; e < kBT * kXP; e += kThreads) {
        const int r = e / kXP, col = (e % kXP) * kXE;
        const bool in = c0 + r < L;
        cp_async::copy16(dst[x] + r * kLdX + col, src[x] + (in ? c0 + r : 0) * a.s[x][1] + col, in);
      }
    const float* wb = a.logw + b * a.s[3][0] + h * a.s[3][2];
    for (int e = tid; e < kBT * (D / 4); e += kThreads) {
      const int r = e / (D / 4), col = (e % (D / 4)) * 4;
      const bool in = c0 + r < L;
      cp_async::copy16(sw + r * kLd + col, wb + (in ? c0 + r : 0) * a.s[3][1] + col, in);
      cp_async::copy16(sdy + r * kLd + col, a.dy + row0 + (in ? r : 0) * HD + col, in);
    }
    for (int e = tid; e < D * (D / 4); e += kThreads) {
      const int i = e / (D / 4), col = (e % (D / 4)) * 4;
      cp_async::copy16(sS + i * kLd + col, a.sc + st_off + i * D + col, true);
      cp_async::copy16(sG + i * kLd + col, a.dsc + st_off + i * D + col, true);
    }
    cp_async::commit();
    if (tid < D) sU[tid] = a.u[h * D + tid];
    cp_async::wait<0>();
  }
  __syncthreads();

  // 1. Two threads a channel: one walks the steps backward for exp(q_s)
  // and the off-diagonal block's Q_s and k_s Q_s (s < kHB); the other
  // forward for exp(p_t), P_t and r_t P_t (t >= kHB), and exp(d_last)
  // <S_in, dS_out>_j.  Meanwhile the other warps take dA = dy v^T on the
  // causal tiles (the diagonal's dy_t . v_t included).
  if (warp < 2 * kCW) {
    const bool fwd = warp >= kCW;
    const int i = (warp % kCW) * 32 + lane;
    if (i < D && !fwd) {
      float q = 0.f, qq = 1.f;
      for (int s = kBT - 1; s >= 0; --s) {
        const float lw = sw[s * kLd + i];
        sQd[s * kLd + i] = expf(q);
        q += lw;
        if (s < K::kHB) {
          sQ[s * kLd + i] = qq;
          sKQ[s * kLd + i] = kv(s, i) * qq;
          qq *= expf(lw);
        }
      }
    } else if (i < D) {
      float p = 0.f, pp = 1.f;
      for (int s = 0; s < kBT; ++s) {
        const float lw = sw[s * kLd + i];
        sdrI[s * kLd + i] = expf(p);
        p += lw;
        if (s >= K::kHB) {
          sP[(s - K::kHB) * kLd + i] = pp;
          sRP[(s - K::kHB) * kLd + i] = rv(s, i) * pp;
          pp *= expf(lw);
        }
      }
      float dot = 0.f;
      for (int j = 0; j < D; ++j) dot = fmaf(sS[i * kLd + j], sG[i * kLd + j], dot);
      sC0[i] = expf(p) * dot;
    }
  } else {
    for (int tile = warp - 2 * kCW; tile < 6; tile += K::kNA) {
      const int r0 = tile < 2 ? 0 : 16, s0 = (tile < 2 ? tile : tile - 2) * 8;
      float acc[1][4] = {};
      tiles_mma<false, kExactV, 1>(acc, [&](int m, int kk) { return sdy[m * kLd + kk]; },
                                   [&](int kk, int n) { return to_f(sv[n * kLdX + kk]); }, r0, s0, 0, D, g, t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tr = r0 + g + 8 * (e >> 1), sc = s0 + 2 * t + (e & 1);
        if (sc <= tr) sdA[tr * kLdT + sc] = acc[0][e];
      }
    }
  }
  __syncthreads();
  // w = exp(logw) in place, for the pairs (read after step 2)
  for (int e = tid; e < kBT * D; e += kThreads) {
    float* x = sw + (e / D) * kLd + e % D;
    *x = expf(*x);
  }

  // 2. Products of tiles, by work items of kNG tiles of a row: dr's inter
  // part exp(p_t) (dy S_in^T)[t, i], dk's state part exp(q_s) (v
  // dS_out^T)[s, i], and dv's state part (k o exp(q)) dS_out, which the
  // warp keeps in registers (at most one such item a warp); and the
  // off-diagonal block: dr's part P_t (dA (k Q))[t, i] for t >= kHB, dk's
  // part Q_s (dA^T (r P))[s, i] for s < kHB, and A[t, s] = (r P)(k Q)^T,
  // kept in dA's free block above the diagonal (rows s, columns kHB + t)
  constexpr int kDG = D / 8 / kNG;          // column groups
  constexpr int kHB = K::kHB;
  float dvacc[kNG][4] = {};
  int dv_item = -1;
  for (int item = warp; item < 6 * kDG + 1; item += kWarps) {
    if (item == 6 * kDG) {
      float acc[kNG][4] = {};
      tiles_mma<false, false, kNG>(acc, [&](int m, int kk) { return sRP[m * kLd + kk]; },
                                   [&](int kk, int n) { return sKQ[n * kLd + kk]; }, 0, 0, 0, D, g, t);
#pragma unroll
      for (int j = 0; j < kNG; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tr = g + 8 * (e >> 1), sc = 8 * j + 2 * t + (e & 1);
          sdA[sc * kLdT + kHB + tr] = acc[j][e];
        }
      continue;
    }
    const int kind = item / (2 * kDG), q = item % (2 * kDG);
    const int m0 = (q / kDG) * 16, n0 = (q % kDG) * 8 * kNG;
    if (kind == 2) {
      dv_item = q;
      tiles_mma<false, false, kNG>(dvacc, [&](int m, int kk) { return kv(m, kk) * sQd[m * kLd + kk]; },
                                   [&](int kk, int n) { return sG[kk * kLd + n]; }, m0, n0, 0, D, g, t);
      continue;
    }
    float acc[kNG][4] = {}, off[kNG][4] = {};
    float* out = kind == 0 ? sdrI : sdkS;
    const float* scale = kind == 0 ? sdrI : sQd;
    // the off-diagonal block's part: rows t >= kHB of dr, rows s < kHB of dk
    const bool has_off = kind == 0 ? m0 == kHB : m0 == 0;
    float* off_out = kind == 0 ? sP : sQ;
    if (kind == 0) {
      tiles_mma<false, false, kNG>(acc, [&](int m, int kk) { return sdy[m * kLd + kk]; },
                                   [&](int kk, int n) { return sS[n * kLd + kk]; }, m0, n0, 0, D, g, t);
      if (has_off)
        tiles_mma<false, false, kNG>(off, [&](int m, int kk) { return sdA[(kHB + m) * kLdT + kk]; },
                                     [&](int kk, int n) { return sKQ[kk * kLd + n]; }, 0, n0, 0, kHB, g, t);
    } else {
      tiles_mma<kExactV, false, kNG>(acc, [&](int m, int kk) { return to_f(sv[m * kLdX + kk]); },
                                     [&](int kk, int n) { return sG[n * kLd + kk]; }, m0, n0, 0, D, g, t);
      if (has_off)
        tiles_mma<false, false, kNG>(off, [&](int m, int kk) { return sdA[(kHB + kk) * kLdT + m]; },
                                     [&](int kk, int n) { return sRP[kk * kLd + n]; }, 0, n0, 0, kHB, g, t);
    }
#pragma unroll
    for (int j = 0; j < kNG; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + g + 8 * (e >> 1), col = n0 + 8 * j + 2 * t + (e & 1);
        out[row * kLd + col] = scale[row * kLd + col] * acc[j][e];
        if (has_off) {
          float* o = off_out + (row - m0) * kLd + col;
          *o *= off[j][e];
        }
      }
  }
  __syncthreads();

  // 3a. A thread a channel: dlogw's sums that need no pair of a
  // diagonal block, sum_{t > tau} r_t exp(p_t) (S_in dy_t) + exp(d_last)
  // <S_in, dS_out>_j + sum_{s < tau} k_s exp(q_s) (dS_out v_s), with the
  // off-diagonal block's rectangle: sum_{s < tau} k_s (dk's part)_s for
  // tau < kHB, sum_{t > tau} r_t (dr's part)_t for tau >= kHB; into
  // S_in's free rows.  Then the off-diagonal parts join dr's and dk's
  // sums; and du's part.
  if (tid < D) {
    const int i = tid;
    float run = 0.f, run_off = 0.f;
    for (int s = 0; s < kBT; ++s) {
      const float ks = kv(s, i);
      sS[s * kLd + i] = s < kHB ? run + run_off : run;
      run = fmaf(ks, sdkS[s * kLd + i], run);
      if (s < kHB) {
        const float dko = sQ[s * kLd + i];
        run_off = fmaf(ks, dko, run_off);
        sdkS[s * kLd + i] += dko;
      }
    }
    float psuf = sC0[i], psuf_off = 0.f, du = 0.f;
    for (int tau = kBT - 1; tau >= 0; --tau) {
      const float rt = rv(tau, i);
      sS[tau * kLd + i] += tau >= kHB ? psuf + psuf_off : psuf;
      psuf = fmaf(rt, sdrI[tau * kLd + i], psuf);
      if (tau >= kHB) {
        const float dro = sP[(tau - kHB) * kLd + i];
        psuf_off = fmaf(rt, dro, psuf_off);
        sdrI[tau * kLd + i] += dro;
      }
      du = fmaf(rt * kv(tau, i), sdA[tau * kLdT + tau], du);
    }
    a.du_part[((static_cast<long long>(b) * n_chunks + c) * H + h) * D + i] = du;
  }
  __syncthreads();

  // 3b. The pairs (t, s), s < t, of the two diagonal blocks (t and s in
  // one half).  Two groups of kCW warps, a channel a thread, group q
  // owning the columns s = q, q + 2, ...: rows tau backward, in each the
  // owned s of its half backward with Pi = prod_{s<m<tau} w_m; the
  // rectangle's column sums suf and dk's sums over t stay in registers.  Each row's rectangle sum and dr's sum over the owned s
  // go to the group's arrays (group 0 adds them to dlogw's and dr's
  // sums).  The other warps: A[t,s] and <r_t, u o k_t>, a row a warp, the
  // lanes holding channels.
  float* p1r = sG;                          // the second group's rectangle sums (kBT, D)
  float* p1d = sG + kBT * D;                // and dr's sums
  if (warp < 2 * kCW) {
    const int q = warp / kCW, i = (warp % kCW) * 32 + lane;
    if (i < D) {
      T* dkb = static_cast<T*>(a.dk);
      const float ui = sU[i];
      // one half of the chunk: rows tau of the half backward, the owned
      // s = lo + q + 2 x < tau of the half (x = 0 .. kHB / 2 - 1) in
      // registers, each row's s backward with Pi = prod_{s<m<tau} w_m
      auto half_walk = [&](auto hc) {
        constexpr int lo = decltype(hc)::value * kHB, kX = kHB / 2;
        float suf[kX], dkp[kX];
#pragma unroll
        for (int x = 0; x < kX; ++x) suf[x] = dkp[x] = 0.f;
        for (int tau = lo + kHB - 1; tau >= lo; --tau) {
          float rect = 0.f;
#pragma unroll
          for (int x = 0; x < kX; ++x)
            if (lo + q + 2 * x < tau) rect += suf[x];
          const float rt = rv(tau, i);
          // Pi for the largest owned s < tau: w_{tau-1} when that s is tau - 2
          float pi = (tau - 1 - lo - q) & 1 ? sw[max(tau - 1, 0) * kLd + i] : 1.f;
          float dr = 0.f;
#pragma unroll
          for (int x = kX - 1; x >= 0; --x) {
            const int s = lo + q + 2 * x;
            const bool on = s < tau;
            const float ks = kv(s, i);
            const float d = on ? sdA[tau * kLdT + s] : 0.f;
            const float wpair = sw[s * kLd + i] * (s >= 1 ? sw[(s - 1) * kLd + i] : 1.f);
            const float y = d * rt * pi;        // dA r_tau Pi
            dr = fmaf(d, ks * pi, dr);
            dkp[x] += y;
            suf[x] = fmaf(y, ks, suf[x]);
            pi = on ? pi * wpair : pi;
          }
          if (q == 0) {
            sS[tau * kLd + i] += rect;
            sdrI[tau * kLd + i] += dr;
          } else {
            p1r[tau * D + i] = rect;
            p1d[tau * D + i] = dr;
          }
        }
#pragma unroll
        for (int x = 0; x < kX; ++x) {
          const int s = lo + q + 2 * x;
          if (c0 + s < L)
            from_f(dkb[row0 + s * HD + i],
                   sdkS[s * kLd + i] + dkp[x] + ui * rv(s, i) * sdA[s * kLdT + s]);
        }
      };
      half_walk(std::integral_constant<int, 1>{});
      half_walk(std::integral_constant<int, 0>{});
    }
  } else {
    // A[tr, s] and <r_tr, u o k_tr>, a row a warp: the kHB s of the row's
    // half in registers (0 where s >= tr), summed over the lanes' channels
    // at once; the off-diagonal block's A from step 2
    constexpr int kPer = (D + 31) / 32;     // channels a lane
    for (int tr = warp - 2 * kCW; tr < kBT; tr += K::kNA) {
      const int lo = tr & kHB;
      float rt[kPer], pi[kPer], v[kHB];
      float ruk = 0.f;
#pragma unroll
      for (int m = 0; m < kPer; ++m) {
        const int i = lane + 32 * m;
        rt[m] = i < D ? rv(tr, i) : 0.f;
        pi[m] = 1.f;
        if (i < D) ruk = fmaf(rt[m] * sU[i], kv(tr, i), ruk);
      }
#pragma unroll
      for (int x = kHB - 1; x >= 0; --x) {
        const int s = lo + x;
        const bool below = s < tr;
        v[x] = 0.f;
#pragma unroll
        for (int m = 0; m < kPer; ++m) {
          const int i = lane + 32 * m;
          if (i < D) {
            v[x] = fmaf(rt[m] * kv(s, i), below ? pi[m] : 0.f, v[x]);
            pi[m] *= below ? sw[s * kLd + i] : 1.f;
          }
        }
      }
      const float sum = scan_bwd::lane_sums(v, lane);
      if (lane < kHB) {
        sA[tr * kLdT + lo + lane] = sum;
        if (lo) sA[tr * kLdT + lane] = sdA[lane * kLdT + tr];
        else sA[tr * kLdT + kHB + lane] = 0.f;
      }
      ruk = scan_bwd::warp_sum(ruk);
      if (lane == 0) sRuk[tr] = ruk;
    }
  }
  __syncthreads();

  // 3c. dlogw and dr, the two groups' sums added in order
  {
    T* drb = static_cast<T*>(a.dr);
    for (int e = tid; e < kBT * D; e += kThreads) {
      const int tau = e / D, i = e % D;
      if (c0 + tau >= L) continue;
      a.dlogw[row0 + tau * HD + i] = sS[tau * kLd + i] + p1r[e];
      from_f(drb[row0 + tau * HD + i], sdrI[tau * kLd + i] + p1d[e]
                                       + sU[i] * kv(tau, i) * sdA[tau * kLdT + tau]);
    }
  }

  // 4. dv = (k o exp(q)) dS_out (kept from 2) + A^T dy + <r, u o k> dy
  if (dv_item >= 0) {
    T* dvb = static_cast<T*>(a.dv);
    const int m0 = (dv_item / kDG) * 16, n0 = (dv_item % kDG) * 8 * kNG;
    tiles_mma<false, false, kNG>(dvacc, [&](int m, int kk) { return sA[kk * kLdT + m]; },
                                 [&](int kk, int n) { return sdy[kk * kLd + n]; }, m0, n0, m0, kBT, g, t);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int s = m0 + g + 8 * half;
      if (c0 + s < L) {
        T* d = dvb + row0 + s * HD + n0 + 2 * t;
        const float ruk = sRuk[s];
#pragma unroll
        for (int j = 0; j < kNG; ++j) {
          const int col = n0 + 8 * j + 2 * t;
          store2(d + 8 * j, fmaf(ruk, sdy[s * kLd + col], dvacc[j][2 * half]),
                 fmaf(ruk, sdy[s * kLd + col + 1], dvacc[j][2 * half + 1]));
        }
      }
    }
  }
}

__global__ void wkv6_bwd_sum(const float* in, float* out, long long outer, int K,
                             long long inner) {
  scan_bwd::sum_mid(in, out, outer, K, inner);
}

}  // namespace

extern "C" {

// rkv_dtype: 0 = float32, 1 = bfloat16 (r, k and v alike).  Strides are in
// elements: (batch, step, head) of r, then of k, v and logw; D contiguous,
// every row 16-byte aligned.  D is 16, 32 or 64.  Every other tensor is
// contiguous float32.
int wkv6_scan(const void* r, const void* k, const void* v, const void* logw,
              const void* u, const void* s0, void* y, void* sT, int B, int L,
              int H, int D, long long r_sb, long long r_sl, long long r_sh,
              long long k_sb, long long k_sl, long long k_sh, long long v_sb,
              long long v_sl, long long v_sh, long long w_sb, long long w_sl,
              long long w_sh, int rkv_dtype, void* stream) {
  if (B <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a{r, k, v, static_cast<const float*>(logw),
         static_cast<const float*>(u), static_cast<const float*>(s0),
         static_cast<float*>(y), static_cast<float*>(sT), L, H,
         {{r_sb, r_sl, r_sh}, {k_sb, k_sl, k_sh}, {v_sb, v_sl, v_sh},
          {w_sb, w_sl, w_sh}}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_kernels(rkv_dtype, D, [&](auto tx, auto d) {
    using T = decltype(tx);
    constexpr int kD = decltype(d)::value;
    if (L == 1) {
      wkv6_steps<T, kD><<<dim3(H, B), kD * kSplit, 0, st>>>(a);
      return cudaGetLastError();
    }
    cudaError_t err = set_smem<T, kD>();
    if (err != cudaSuccess) return err;
    wkv6_chunks<T, kD><<<dim3(H, B), kThreads, Layout<T, kD>::kBytes, st>>>(a);
    return cudaGetLastError();
  }));
}


// The backward of wkv6_scan: r, k, v, logw as wkv6_scan takes them (and
// their strides); dy (B, L, H, D) and dsT (B, H, D, D, or null for zeros)
// float32 and contiguous.  Out, contiguous: dr, dk, dv (B, L, H, D) in
// r's dtype, dlogw (B, L, H, D), du (H, D) and ds0 (B, H, D, D) float32.
// du_part (B, ceil(L / 32), H, D), sc and dsc (B H, ceil(L / 32), D, D)
// are float32 scratch the caller allocates.
int wkv6_scan_bwd(const void* r, const void* k, const void* v, const void* logw,
                  const void* u, const void* s0, const void* dy, const void* dsT,
                  void* dr, void* dk, void* dv, void* dlogw, void* du, void* ds0,
                  void* du_part, void* sc, void* dsc, int B, int L, int H, int D,
                  long long r_sb, long long r_sl, long long r_sh, long long k_sb,
                  long long k_sl, long long k_sh, long long v_sb, long long v_sl,
                  long long v_sh, long long w_sb, long long w_sl, long long w_sh,
                  int rkv_dtype, void* stream) {
  if (B <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = (L + kBT - 1) / kBT;
  const float* flw = static_cast<const float*>(logw);
  const long long HD = static_cast<long long>(H) * D;
  WalkArgs states{k, flw, v, static_cast<const float*>(s0), static_cast<float*>(sc), nullptr,
                  L, H, {{k_sb, k_sl, k_sh}, {w_sb, w_sl, w_sh}, {v_sb, v_sl, v_sh}}};
  WalkArgs grads{r, flw, dy, static_cast<const float*>(dsT), static_cast<float*>(dsc),
                 static_cast<float*>(ds0), L, H,
                 {{r_sb, r_sl, r_sh}, {w_sb, w_sl, w_sh}, {L * HD, HD, D}}};
  ChunkArgs ca{r, k, v, flw, static_cast<const float*>(u), static_cast<const float*>(dy),
               static_cast<const float*>(sc), static_cast<const float*>(dsc), dr, dk, dv,
               static_cast<float*>(dlogw), static_cast<float*>(du_part), L, H,
               {{r_sb, r_sl, r_sh}, {k_sb, k_sl, k_sh}, {v_sb, v_sl, v_sh},
                {w_sb, w_sl, w_sh}}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = with_kernels(rkv_dtype, D, [&](auto tx, auto d) {
    using T = decltype(tx);
    constexpr int kD = decltype(d)::value;
    constexpr int kWS = WalkLayout<T, T, kD>::kBytes, kWG = WalkLayout<T, float, kD>::kBytes;
    constexpr int kC = ChunkLayout<T, kD>::kBytes;
    cudaError_t e = cudaFuncSetAttribute(wkv6_bwd_walk<T, T, kD, false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kWS);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(wkv6_bwd_walk<T, float, kD, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kWG);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(wkv6_bwd_chunk<T, kD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kC);
    if (e != cudaSuccess) return e;
    wkv6_bwd_walk<T, T, kD, false><<<dim3(H, B), kThreads, kWS, st>>>(states);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    wkv6_bwd_walk<T, float, kD, true><<<dim3(H, B), kThreads, kWG, st>>>(grads);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    wkv6_bwd_chunk<T, kD><<<dim3(n_chunks, H, B), kThreads, kC, st>>>(ca);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(scan_bwd::launch_sum(wkv6_bwd_sum, static_cast<float*>(du_part),
                                               static_cast<float*>(du), 1, B * n_chunks, HD,
                                               st));
}

}  // extern "C"
