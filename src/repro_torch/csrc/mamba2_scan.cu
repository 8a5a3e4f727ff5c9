// Chunked Mamba2 SSD scan, sm_90a.
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
// Bound on the H100: operations at prefill.  Per chunk of Lc steps and
// head, about Lc^2 N / 2 + Lc^2 P / 2 + 2 Lc N P multiply-adds against
// Lc (P + 2N / H) loaded values, so tens of operations per byte; they run
// in float32 outside the tensor cores (67 TFLOP/s).  At decode (L = 1) it
// is bound by bytes: the state is read and written once.
//
// Design (right and simple first).  The Pallas grid carries the state in
// VMEM across a sequential chunk axis; Hopper blocks run in no order, so
// one CTA of 256 threads owns one (b, head) and loops over the chunks
// itself.  The (N x P) float32 state stays in shared memory for the whole
// scan (16 KB at N = P = 64), beside the chunk's x, B, C and the (Lc x Lc)
// matrix M (177 KB in all at Lc = 128).  Each product is laid out so a
// warp reads one operand as a broadcast and the other from consecutive
// addresses; B's rows are padded by one float for the C B^T pass, whose
// lanes walk B's rows.  The decay above the diagonal is never computed:
// the mask selects 0 there (an exp(cum_t - cum_s) for s > t could be inf,
// and inf * 0 is NaN).  A ragged last chunk is masked as zero dt, x and B,
// which leaves the state as it was, so L need not be a multiple of Lc.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  const float* h0;
  float* y;
  float* hT;
  int L, H, P, N, Lc;
  long long x_sb, x_sl, x_sh;
};

template <typename TX>
__global__ void __launch_bounds__(kThreads)
ssd_chunks(Args a) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int L = a.L, H = a.H, P = a.P, N = a.N, Lc = a.Lc;
  const int NB = N + 1;                      // padded row of sB
  extern __shared__ float smem[];
  float* sH = smem;                          // (N, P) state
  float* sX = sH + N * P;                    // (Lc, P)
  float* sB = sX + Lc * P;                   // (Lc, N + 1)
  float* sC = sB + Lc * NB;                  // (Lc, N)
  float* sM = sC + Lc * N;                   // (Lc, Lc)
  float* sDt = sM + Lc * Lc;                 // (Lc,)
  float* sCum = sDt + Lc;                    // (Lc,)
  float* sW = sCum + Lc;                     // (Lc,)

  const float A = a.A[h];
  const TX* xb = static_cast<const TX*>(a.x) + b * a.x_sb + h * a.x_sh;
  const long long bh = static_cast<long long>(b) * H + h;
  for (int e = threadIdx.x; e < N * P; e += kThreads)
    sH[e] = a.h0[bh * N * P + e];

  for (int c0 = 0; c0 < L; c0 += Lc) {
    const int nv = min(Lc, L - c0);          // valid steps in this chunk
    __syncthreads();                         // last chunk's reads are done
    for (int e = threadIdx.x; e < Lc * P; e += kThreads) {
      const int t = e / P, p = e % P;
      sX[e] = t < nv ? to_f(xb[(c0 + t) * a.x_sl + p]) : 0.f;
    }
    const long long bc = (static_cast<long long>(b) * L + c0) * N;
    for (int e = threadIdx.x; e < Lc * N; e += kThreads) {
      const int t = e / N, n = e % N;
      const bool in = t < nv;
      sB[t * NB + n] = in ? a.B[bc + e] : 0.f;
      sC[e] = in ? a.C[bc + e] : 0.f;
    }
    for (int t = threadIdx.x; t < Lc; t += kThreads)
      sDt[t] = t < nv ? a.dt[(static_cast<long long>(b) * L + c0 + t) * H + h] : 0.f;
    __syncthreads();
    if (threadIdx.x == 0) {                  // inclusive cumsum of dt A
      float run = 0.f;
      for (int t = 0; t < Lc; ++t) {
        run += sDt[t] * A;
        sCum[t] = run;
      }
    }
    __syncthreads();
    const float cum_last = sCum[Lc - 1];
    for (int s = threadIdx.x; s < Lc; s += kThreads)
      sW[s] = expf(cum_last - sCum[s]) * sDt[s];
    // M[t, s] = (C_t . B_s) exp(cum_t - cum_s) dt_s for s <= t < nv, else 0
    for (int e = threadIdx.x; e < Lc * Lc; e += kThreads) {
      const int t = e / Lc, s = e % Lc;
      float mts = 0.f;
      if (s <= t && t < nv) {
        float dot = 0.f;
        for (int n = 0; n < N; ++n) dot += sC[t * N + n] * sB[s * NB + n];
        mts = dot * expf(sCum[t] - sCum[s]) * sDt[s];
      }
      sM[e] = mts;
    }
    __syncthreads();
    // y_t = M_t . x + exp(cum_t) C_t . h  (h before this chunk's update)
    float* yb = a.y + ((static_cast<long long>(b) * L + c0) * H + h) * P;
    for (int e = threadIdx.x; e < nv * P; e += kThreads) {
      const int t = e / P, p = e % P;
      float acc = 0.f;
      for (int s = 0; s <= t; ++s) acc += sM[t * Lc + s] * sX[s * P + p];
      float ch = 0.f;
      for (int n = 0; n < N; ++n) ch += sC[t * N + n] * sH[n * P + p];
      yb[static_cast<long long>(t) * H * P + p] = acc + expf(sCum[t]) * ch;
    }
    __syncthreads();                         // every read of sH is done
    const float decay = expf(cum_last);
    for (int e = threadIdx.x; e < N * P; e += kThreads) {
      const int n = e / P, p = e % P;
      float acc = sH[e] * decay;
      for (int s = 0; s < nv; ++s) acc += sB[s * NB + n] * sW[s] * sX[s * P + p];
      sH[e] = acc;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < N * P; e += kThreads)
    a.hT[bh * N * P + e] = sH[e];
}

// Shared memory one CTA needs, in bytes: the same sum as the wrapper's
// ops.smem_bytes, which refuses what the card cannot give.
long long smem_bytes(int P, int N, int Lc) {
  return 4LL * (static_cast<long long>(N) * P + Lc * P + Lc * (N + 1) +
                Lc * N + static_cast<long long>(Lc) * Lc + 3 * Lc);
}

}  // namespace

extern "C" {

// x_dtype: 0 = float32, 1 = bfloat16.  x strides are in elements (batch,
// step, head; P contiguous); every other tensor is contiguous float32.
int ssd_scan(const void* x, const void* dt, const void* A, const void* B,
             const void* C, const void* h0, void* y, void* hT, int Bz, int L,
             int H, int P, int N, int Lc, long long x_sb, long long x_sl,
             long long x_sh, int x_dtype, void* stream) {
  if (Bz <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (Lc <= 0 || P <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a{x, static_cast<const float*>(dt), static_cast<const float*>(A),
         static_cast<const float*>(B), static_cast<const float*>(C),
         static_cast<const float*>(h0), static_cast<float*>(y),
         static_cast<float*>(hT), L, H, P, N, Lc, x_sb, x_sl, x_sh};
  const long long smem = smem_bytes(P, N, Lc);
  const dim3 grid(H, Bz);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == 0) {
    err = cudaFuncSetAttribute(ssd_chunks<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_chunks<float><<<grid, kThreads, smem, st>>>(a);
  } else if (x_dtype == 1) {
    err = cudaFuncSetAttribute(ssd_chunks<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_chunks<__nv_bfloat16><<<grid, kThreads, smem, st>>>(a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
