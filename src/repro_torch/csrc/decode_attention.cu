// GQA decode attention: one query token per sequence over a KV cache, sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/decode_attention/kernel.py:
// decode_attention (public wrapper ops.gqa_decode).  Layout is the model's:
// q (B, 1, H, D), the cache k/v (B, S, KV, D) read through its strides (no
// transposed copy), kv_len (B,) int32, out (B, 1, H, D) contiguous.  Query
// head h belongs to KV head h / G, G = H / KV.  Sequence b attends over
// cache positions [0, kv_len[b]); the rest is left out of the softmax.
//
// Bound on the H100: bytes.  Each valid cache row is read once (K and V),
// against 4 * G * D operations per row and KV head -- about G operations
// per byte, far below the ~295 at which the tensor cores would bound it.
// So the design is about keeping enough loads in flight to stream the
// cache at the memory's rate.
//
// Design (right and simple first).  Flash decoding: the valid prefix of
// each (b, KV head) is cut into n_split equal ranges, one CTA of 8 warps
// per (range, KV head, b), so B * KV * n_split CTAs fill the card even at
// small B * KV.  In a CTA each warp walks every 8th key; a lane owns head
// dims lane, lane + 32, ... of the row, so one warp reads a row with
// coalesced loads.  A warp loads 4 keys' K and V rows before it uses any of
// them (memory-level parallelism), reduces each of the G scores with five
// shuffles, and keeps the online softmax (max, normaliser, accumulator) of
// its G query heads in registers, in float32.  The 8 warps merge through
// shared memory into one partial (m, l, acc) per range; a second kernel
// merges the ranges and normalises.  Nothing is padded: D need not be a
// multiple of 32 (D = 80), the last key group is masked, and the scale is
// the true 1/sqrt(D) (the TPU wrapper's padded-D rescale is not carried
// over).  A sequence with kv_len 0 gets zeros.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;            // keys a warp loads before using them

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// weight of a partial with running max m against the merged max mx
__device__ __forceinline__ float rescale(float m, float mx) {
  return m == -INFINITY ? 0.f : expf(m - mx);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* kv_len;
  void* out;
  float* part_acc;   // (B, KV, n_split, G, D)
  float* part_ml;    // (B, KV, n_split, G, 2): running max, normaliser
  int S, H, KV, D, n_split;
  float scale;
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
};

// One CTA per (key range, KV head, b): a partial softmax over the range.
template <typename TQ, typename TK, int D, int MAXG>
__global__ void __launch_bounds__(kThreads)
decode_split(Args a) {
  constexpr int DPL = (D + 31) / 32;    // head dims per lane
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int len = min(max(a.kv_len[b], 0), a.S);
  const int per = (len + a.n_split - 1) / a.n_split;
  const int lo = split * per;
  const int hi = min(len, lo + per);

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

  for (int s0 = lo + warp; s0 < hi; s0 += kWarps * kUnroll) {
    float kr[kUnroll][DPL], vr[kUnroll][DPL];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u * kWarps;
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
  __shared__ float s_m[kWarps][MAXG], s_l[kWarps][MAXG];
  __shared__ float s_acc[kWarps][MAXG][D];
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
  const long long part = ((static_cast<long long>(b) * a.KV + kvh) * a.n_split + split) * G;
  for (int e = threadIdx.x; e < G * D; e += kThreads) {
    const int g = e / D, d = e % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][g]);
    float lsum = 0.f, asum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = rescale(s_m[w][g], mx);
      lsum += s_l[w][g] * c;
      asum += s_acc[w][g][d] * c;
    }
    a.part_acc[(part + g) * D + d] = asum;
    if (d == 0) {
      a.part_ml[(part + g) * 2] = mx;
      a.part_ml[(part + g) * 2 + 1] = lsum;
    }
  }
}

// One CTA per (KV head, b): merge the ranges' partials and normalise.
template <typename TQ>
__global__ void __launch_bounds__(kThreads)
decode_combine(Args a) {
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = a.H / a.KV, D = a.D;
  const long long base = (static_cast<long long>(b) * a.KV + kvh) * a.n_split;
  TQ* ob = static_cast<TQ*>(a.out) + (static_cast<long long>(b) * a.H + kvh * G) * D;
  for (int e = threadIdx.x; e < G * D; e += kThreads) {
    const int g = e / D, d = e % D;
    float mx = -INFINITY;
    for (int sp = 0; sp < a.n_split; ++sp)
      mx = fmaxf(mx, a.part_ml[((base + sp) * G + g) * 2]);
    float lsum = 0.f, asum = 0.f;
    for (int sp = 0; sp < a.n_split; ++sp) {
      const long long pg = (base + sp) * G + g;
      const float c = rescale(a.part_ml[pg * 2], mx);
      lsum += a.part_ml[pg * 2 + 1] * c;
      asum += a.part_acc[pg * D + d] * c;
    }
    ob[g * D + d] = from_f<TQ>(asum / fmaxf(lsum, 1e-20f));
  }
}

template <typename TQ, typename TK, int D>
int launch_d(const Args& a, int B, cudaStream_t st) {
  const int G = a.H / a.KV;
  const dim3 grid(a.n_split, a.KV, B);
  if (G <= 1) decode_split<TQ, TK, D, 1><<<grid, kThreads, 0, st>>>(a);
  else if (G <= 2) decode_split<TQ, TK, D, 2><<<grid, kThreads, 0, st>>>(a);
  else if (G <= 4) decode_split<TQ, TK, D, 4><<<grid, kThreads, 0, st>>>(a);
  else if (G <= 8) decode_split<TQ, TK, D, 8><<<grid, kThreads, 0, st>>>(a);
  else return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine<TQ><<<dim3(a.KV, B), kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TK>
int launch(const Args& a, int B, cudaStream_t st) {
  switch (a.D) {
    case 32: return launch_d<TQ, TK, 32>(a, B, st);
    case 64: return launch_d<TQ, TK, 64>(a, B, st);
    case 80: return launch_d<TQ, TK, 80>(a, B, st);
    case 128: return launch_d<TQ, TK, 128>(a, B, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = q and cache float32, 1 = both bfloat16, 2 = q float32 over a
// bfloat16 cache.  Strides are in elements; the head dim is contiguous.
// part_acc / part_ml are scratch of (B, KV, n_split, G, D) / (..., G, 2)
// float32, allocated by the caller.
int decode_attention(const void* q, const void* k, const void* v,
                     const void* kv_len, void* out, void* part_acc,
                     void* part_ml, int B, int S, int H, int KV, int D,
                     int n_split, int dtype, float scale, long long q_sb,
                     long long q_sh, long long k_sb, long long k_ss,
                     long long k_sh, long long v_sb, long long v_ss,
                     long long v_sh, void* stream) {
  if (B <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (KV <= 0 || H % KV != 0 || n_split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, static_cast<const int*>(kv_len), out,
         static_cast<float*>(part_acc), static_cast<float*>(part_ml),
         S, H, KV, D, n_split, scale,
         q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, float>(a, B, st);
  if (dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16>(a, B, st);
  if (dtype == 2) return launch<float, __nv_bfloat16>(a, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
