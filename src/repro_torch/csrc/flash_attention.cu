// Causal GQA flash attention (prefill), sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention/kernel.py:
// flash_attention (public wrapper ops.mha).  Layout is the wrapper's:
// q (B, S, H, D), k/v (B, S, KV, D), out (B, S, H, D), H % KV == 0, and
// the KV head of query head h is h / (H / KV).
//
// Bound on the H100: 4 * B * H * D * S(S+1)/2 causal operations against
// 2 * B * S * (H + KV) * D * itemsize bytes: at olmo-1b's S = 2048 it is
// bound by operations; at the serving request's S = 64 the bound (bytes,
// 0.3 us) is far below the cost of a launch, which is what it pays.
//
// Design (right and simple first; tensor cores are a later step): one CTA
// of 256 threads per (64-row query tile, head, batch).  Q, then each K/V
// tile, is staged through shared memory in float32; K and Q rows are
// padded by one float so the 4 rows a warp reads at once fall on distinct
// banks.  Four neighbouring lanes own one query row: they split its 64
// scores, reduce the running max and normaliser with two shuffles, and
// own a quarter of its D accumulator columns in registers.  Scores, max,
// normaliser and accumulator are float32; the causal loop stops at the
// diagonal tile, and rows or keys past S are masked, so S need not be a
// multiple of the tile.  The scale is the true 1/sqrt(D): the TPU
// wrapper's padded-D rescale is not carried over.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int S, int H, int KV,
          float scale, int causal) {
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
  const T* qb = q + static_cast<int64_t>(b) * S * q_row + h * D;
  const T* kb = k + static_cast<int64_t>(b) * S * kv_row + kvh * D;
  const T* vb = v + static_cast<int64_t>(b) * S * kv_row + kvh * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int rr = e / D, d = e % D, s = q0 + rr;
    sQ[rr * LQ + d] = s < S ? to_f(qb[s * q_row + d]) * scale : 0.f;
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
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int rr = e / D, d = e % D, s = k0 + rr;
      const bool in = s < S;
      sK[rr * LQ + d] = in ? to_f(kb[s * kv_row + d]) : 0.f;
      sV[rr * D + d] = in ? to_f(vb[s * kv_row + d]) : 0.f;
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
    T* ob = o + static_cast<int64_t>(b) * S * q_row + h * D +
            static_cast<int64_t>(qpos) * q_row;
    const float den = fmaxf(l, 1e-20f);
#pragma unroll
    for (int c = 0; c < NC; ++c) ob[sub + 4 * c] = from_f<T>(acc[c] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int KV, float scale, int causal, void* stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd<T, D><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, KV, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int S, int H, int KV, int D, float scale, int causal,
             void* stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, KV, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, KV, scale, causal, stream);
    case 80: return launch<T, 80>(q, k, v, o, B, S, H, KV, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, KV, scale, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  All tensors contiguous.
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    int B, int S, int H, int KV, int D, int dtype,
                    float scale, int causal, void* stream) {
  if (B <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, S, H, KV, D, scale, causal, stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, S, H, KV, D, scale, causal,
                                   stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
