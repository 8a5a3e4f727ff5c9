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
// wkv6_bwd_chunks: the gradients of (y, sT), by the recurrence walked
// backward in float32 on the CUDA cores -- a first, simple design; B5's
// forward has no backward in the JAX package, whose model differentiates
// its plain chunked scan (models/rwkv6.py: wkv6_chunked).  One CTA of 256
// threads per (b, head); thread (i, q) holds row i of the state and of dS,
// the gradient into it, value channels q E .. q E + E - 1 (E = D^2 / 256),
// in registers (scan_bwd.cuh).  Phase 1 walks the steps forward from s0
// and writes the state before each chunk of kLc steps to a scratch (bnd).
// Phase 2 walks the chunks backward: it recomputes the chunk's states from
// its first into a second scratch (hist; each thread reads back only what
// it wrote), then walks the chunk's steps backward with w_t = exp(logw_t):
//   dlogw_t[i] = w_t[i] sum_j dS[i, j] S_{t-1}[i, j]
//   dk_t[i] = sum_j dS[i, j] v_t[j] + u[i] r_t[i] <dy_t, v_t>
//   dr_t[i] = sum_j S_{t-1}[i, j] dy_t[j] + u[i] k_t[i] <dy_t, v_t>
//   dv_t[j] = sum_i dS[i, j] k_t[i] + <r_t, u o k_t> dy_t[j]
//   du (this (b, head)'s part) += r_t o k_t <dy_t, v_t>
//   dS = w_t o dS + r_t (x) dy_t
// and writes ds0 at the end.  dv sums over rows: shuffles within the warp,
// then the warps' partials in shared memory, added in warp order once a
// chunk; du sums over b: wkv6_bwd_sum adds the CTAs' parts in index
// order.  No atomics: two calls give the same bytes.  No exponent is
// positive: only w_t <= 1 multiplies, for any logw <= 0.
//
// Bound: bytes (r, k, v and their gradients, logw, dlogw and dy, PERF.md);
// this design moves the recomputed states through L2 and spends several
// CUDA-core instructions a state element and step.

struct BwdArgs {
  const void* r;
  const void* k;
  const void* v;
  const float* logw;
  const float* u;
  const float* s0;
  const float* dy;       // (B, L, H, D), contiguous
  const float* dsT;      // (B, H, D, D), or null: zeros
  void* dr;              // (B, L, H, D), r's dtype, contiguous; dk and dv alike
  void* dk;
  void* dv;
  float* dlogw;          // (B, L, H, D)
  float* du_part;        // (B, H, D)
  float* ds0;            // (B, H, D, D)
  float* bnd;            // (B H, n_chunks, D D) scratch
  float* hist;           // (B H, kLc, D D) scratch
  int L, H;
  // element strides (batch, step, head) of r, k, v, logw; D is contiguous
  long long s[4][3];
};

__device__ __forceinline__ void from_f(float& d, float x) { d = x; }
__device__ __forceinline__ void from_f(bf16& d, float x) { d = __float2bfloat16(x); }

template <typename T, int D>
__global__ void __launch_bounds__(scan_bwd::kThreads, 2)
wkv6_bwd_chunks(BwdArgs a) {
  using scan_bwd::col_sums;
  using scan_bwd::load_row;
  using scan_bwd::row_sum;
  using scan_bwd::store_row;
  constexpr int kC = scan_bwd::kLc, kNT = scan_bwd::kThreads, kW = scan_bwd::kWarps;
  constexpr int kTPR = kNT / D;             // threads a row
  constexpr int E = D / kTPR;               // value channels a thread
  constexpr int kDD = D * D;
  static_assert(kTPR * D == kNT && E * kTPR == D && kTPR <= 32, "layout");
  __shared__ float sr[kC][D], sk[kC][D], sv[kC][D], sw[kC][D], sdy[kC][D];
  __shared__ float sdyv[kC], sruk[kC], su[D];
  __shared__ float part_dv[kW][kC][D];

  const int h = blockIdx.x, b = blockIdx.y;
  const int L = a.L, H = a.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int i = tid / kTPR, q = tid % kTPR, col0 = q * E;
  const int own = i * D + col0;             // this thread's offset in a state
  const long long bh = static_cast<long long>(b) * H + h;
  const T* rb = static_cast<const T*>(a.r) + b * a.s[0][0] + h * a.s[0][2];
  const T* kb = static_cast<const T*>(a.k) + b * a.s[1][0] + h * a.s[1][2];
  const T* vb = static_cast<const T*>(a.v) + b * a.s[2][0] + h * a.s[2][2];
  const float* wb = a.logw + b * a.s[3][0] + h * a.s[3][2];
  const int n_chunks = (L + kC - 1) / kC;
  float* bnd = a.bnd + bh * n_chunks * kDD;
  float* hist = a.hist + bh * kC * kDD;
  if (tid < D) su[tid] = a.u[h * D + tid];

  // steps t0 .. t0 + n_s - 1 into shared memory: k, v and the decay, and
  // with_dy r and dy
  auto stage = [&](int t0, int n_s, bool with_dy) {
    for (int e = tid; e < n_s * D; e += kNT) {
      const int s = e / D, c = e % D;
      const long long t = t0 + s;
      sk[s][c] = to_f(kb[t * a.s[1][1] + c]);
      sv[s][c] = to_f(vb[t * a.s[2][1] + c]);
      sw[s][c] = expf(wb[t * a.s[3][1] + c]);
      if (with_dy) {
        sr[s][c] = to_f(rb[t * a.s[0][1] + c]);
        sdy[s][c] = a.dy[((b * static_cast<long long>(L) + t) * H + h) * D + c];
      }
    }
  };
  auto step = [&](float (&st)[E], int s) {
    const float wi = sw[s][i], ki = sk[s][i];
#pragma unroll
    for (int j = 0; j < E; ++j) st[j] = fmaf(wi, st[j], ki * sv[s][col0 + j]);
  };

  // phase 1: the state before each chunk
  {
    float st[E];
    load_row<E>(st, a.s0 + bh * kDD + own);
    for (int c = 0; c < n_chunks; ++c) {
      const int t0 = c * kC, n_s = min(kC, L - t0);
      store_row<E>(bnd + static_cast<long long>(c) * kDD + own, st);
      __syncthreads();                      // the previous chunk's stage is read
      stage(t0, n_s, false);
      __syncthreads();
      for (int s = 0; s < n_s; ++s) step(st, s);
    }
  }

  // phase 2: the chunks backward
  float g[E];
  if (a.dsT != nullptr) {
    load_row<E>(g, a.dsT + bh * kDD + own);
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j) g[j] = 0.f;
  }
  const float ui = su[i];
  float du = 0.f;
  T* drb = static_cast<T*>(a.dr);
  T* dkb = static_cast<T*>(a.dk);
  T* dvb = static_cast<T*>(a.dv);
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kC, n_s = min(kC, L - t0);
    __syncthreads();                        // the previous chunk's stage and partials are read
    stage(t0, n_s, true);
    __syncthreads();
    // the step's scalars <dy_t, v_t> and <r_t, u o k_t>, a warp a step
    for (int s = warp; s < n_s; s += kW) {
      float dyv = 0.f, ruk = 0.f;
      for (int c2 = lane; c2 < D; c2 += 32) {
        dyv = fmaf(sdy[s][c2], sv[s][c2], dyv);
        ruk = fmaf(sr[s][c2] * su[c2], sk[s][c2], ruk);
      }
      dyv = scan_bwd::warp_sum(dyv);
      ruk = scan_bwd::warp_sum(ruk);
      if (lane == 0) {
        sdyv[s] = dyv;
        sruk[s] = ruk;
      }
    }
    // hist[s] = S_{t0 + s - 1}
    {
      float st[E];
      load_row<E>(st, bnd + static_cast<long long>(c) * kDD + own);
      for (int s = 0; s < n_s; ++s) {
        store_row<E>(hist + s * kDD + own, st);
        if (s + 1 < n_s) step(st, s);
      }
    }
    __syncthreads();                        // the scalars are written
    for (int s = n_s - 1; s >= 0; --s) {
      const long long row = ((static_cast<long long>(b) * L + t0 + s) * H + h) * D;
      float sp[E], dvp[E];
      load_row<E>(sp, hist + s * kDD + own);
      const float ri = sr[s][i], ki = sk[s][i], wi = sw[s][i], dyv = sdyv[s];
      float a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const float dyj = sdy[s][col0 + j];
        a1 = fmaf(g[j], sp[j], a1);
        a2 = fmaf(g[j], sv[s][col0 + j], a2);
        a3 = fmaf(sp[j], dyj, a3);
        dvp[j] = g[j] * ki;
        g[j] = fmaf(wi, g[j], ri * dyj);
      }
      a1 = row_sum<kTPR>(a1);
      a2 = row_sum<kTPR>(a2);
      a3 = row_sum<kTPR>(a3);
      if (q == 0) {
        a.dlogw[row + i] = wi * a1;
        from_f(dkb[row + i], fmaf(ui * ri, dyv, a2));
        from_f(drb[row + i], fmaf(ui * ki, dyv, a3));
        du = fmaf(ri * ki, dyv, du);
      }
      col_sums<E, kTPR>(dvp, lane, &part_dv[warp][s][0], col0);
    }
    __syncthreads();                        // the chunk's partials are written
    for (int e = tid; e < n_s * D; e += kNT) {
      const int s = e / D, j = e % D;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kW; ++w) sum += part_dv[w][s][j];
      from_f(dvb[((static_cast<long long>(b) * L + t0 + s) * H + h) * D + j],
             fmaf(sruk[s], sdy[s][j], sum));
    }
  }
  store_row<E>(a.ds0 + bh * kDD + own, g);
  if (q == 0) a.du_part[bh * D + i] = du;
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
// du_part (B, H, D), bnd (B H, ceil(L / 8), D D) and hist (B H, 8, D D)
// are float32 scratch the caller allocates.
int wkv6_scan_bwd(const void* r, const void* k, const void* v, const void* logw,
                  const void* u, const void* s0, const void* dy, const void* dsT,
                  void* dr, void* dk, void* dv, void* dlogw, void* du, void* ds0,
                  void* du_part, void* bnd, void* hist, int B, int L, int H, int D,
                  long long r_sb, long long r_sl, long long r_sh, long long k_sb,
                  long long k_sl, long long k_sh, long long v_sb, long long v_sl,
                  long long v_sh, long long w_sb, long long w_sl, long long w_sh,
                  int rkv_dtype, void* stream) {
  if (B <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{r, k, v, static_cast<const float*>(logw), static_cast<const float*>(u),
            static_cast<const float*>(s0), static_cast<const float*>(dy),
            static_cast<const float*>(dsT), dr, dk, dv, static_cast<float*>(dlogw),
            static_cast<float*>(du_part), static_cast<float*>(ds0),
            static_cast<float*>(bnd), static_cast<float*>(hist), L, H,
            {{r_sb, r_sl, r_sh}, {k_sb, k_sl, k_sh}, {v_sb, v_sl, v_sh},
             {w_sb, w_sl, w_sh}}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = with_kernels(rkv_dtype, D, [&](auto tx, auto d) {
    using T = decltype(tx);
    constexpr int kD = decltype(d)::value;
    wkv6_bwd_chunks<T, kD><<<dim3(H, B), scan_bwd::kThreads, 0, st>>>(a);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(scan_bwd::launch_sum(wkv6_bwd_sum, a.du_part,
                                               static_cast<float*>(du), 1, B,
                                               static_cast<long long>(H) * D, st));
}

}  // extern "C"
