// WKV6 recurrence (RWKV6 "Finch"), sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/rwkv6_scan/kernel.py:
// wkv6_scan (public wrapper ops.wkv6).  It evaluates, per (b, head), with
// the key channel i and the value channel j,
//   y_t[j]   = sum_i r_t[i] (S[i,j] + u[i] k_t[i] v_t[j])
//   S[i,j]  <- exp(logw_t[i]) S[i,j] + k_t[i] v_t[j]
// from the state s0 to the final state sT.  The model's chunked form
// (models/rwkv6.py wkv6_chunked) computes the same sums in another order.
// Layout is the model's: r, k, v, logw (B, L, H, D), each read through its
// own strides (r, k, v float32 or bfloat16; logw float32), u (H, D) and
// s0 (B, H, D, D) float32 and contiguous.  Out: y (B, L, H, D) and sT
// (B, H, D, D), float32.
//
// Bound on the H100: bytes.  Per step and head the recurrence does about
// 2 D^2 multiply-adds against 4 D loaded values and D stored, so at D = 64
// with bfloat16 r, k, v about 18 float32 operations per byte, just under
// the card's 20 (67 TFLOP/s over 3.35 TB/s): at rwkv6-7b's prefill (4 x
// 1024 tokens, 64 heads) 0.073 ms of bytes against 0.064 ms of operations.
// At decode (L = 1) the state's bytes bound it: read and written once.
//
// Design (right and simple first).  The Pallas grid carries the state in
// VMEM across a sequential chunk axis and evaluates each chunk as matrix
// products of cumulative-decay differences; Hopper blocks run in no order,
// so one CTA owns one (b, head) and walks the steps itself, one by one.
// The step form needs no exp of a positive number, so no masking.  The
// (D x D) state lives in registers: 4 D threads, thread (j, g) holds
// S[i, j] for the D / 4 key channels i = g mod 4 (16 floats at D = 64), and
// the four partial sums of y_t[j] meet by two warp shuffles.  A tile of
// kTile steps of r, k, exp(logw) and v is staged in shared memory by
// cooperative, coalesced loads; in the step loop each warp reads four
// consecutive addresses of it (a broadcast, no bank conflict).  Its limit
// is the instruction rate of the step loop (about three shared loads and
// five float32 operations per state element and step), not memory.  L = 1
// and a ragged L need nothing special: a tile's steps past L are not walked.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kSplit = 4;     // threads sharing one value column j
constexpr int kTile = 32;     // steps staged in shared memory at a time

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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
        acc += __shfl_xor_sync(0xffffffffu, acc, m);
        ruk += __shfl_xor_sync(0xffffffffu, ruk, m);
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

template <typename T, int D>
cudaError_t launch(const Args& a, int B, cudaStream_t st) {
  wkv6_steps<T, D><<<dim3(a.H, B), D * kSplit, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Args& a, int B, int D, cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(a, B, st);
    case 32: return launch<T, 32>(a, B, st);
    case 64: return launch<T, 64>(a, B, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// rkv_dtype: 0 = float32, 1 = bfloat16 (r, k and v alike).  Strides are in
// elements: (batch, step, head) of r, then of k, v and logw; D contiguous.
// D is 16, 32 or 64.  Every other tensor is contiguous float32.
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
  cudaError_t err;
  if (rkv_dtype == 0) {
    err = launch_d<float>(a, B, D, st);
  } else if (rkv_dtype == 1) {
    err = launch_d<__nv_bfloat16>(a, B, D, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
