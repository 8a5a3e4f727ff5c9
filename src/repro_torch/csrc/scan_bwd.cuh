// Pieces the scans' backward kernels share (mamba2_scan.cu, rwkv6_scan.cu).
//
// Both walk a recurrence over a (rows x cols) float32 state backward, one
// CTA of kThreads threads per (batch, head), thread (row, q) holding row
// `row` and the kE columns q kE .. q kE + kE - 1 of the state in
// registers (kTPR = kThreads / rows threads a row, in neighbouring lanes).
// A sum along a row is a shuffle among the row's lanes; a sum down the
// columns is col_sums below, then the warps' partials through shared
// memory.  Every sum is taken in a fixed order and none uses atomics, so
// two calls on the same inputs give the same bytes.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace scan_bwd {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// steps a chunk: the states of one chunk are recomputed into a scratch
// of kLc states a CTA (128 KB at a 64 x 64 state), which stays in L2
constexpr int kLc = 8;

// kE floats from src (16-byte aligned where kE % 4 == 0) into v, and back
template <int kE>
__device__ __forceinline__ void load_row(float (&v)[kE], const float* src) {
  if constexpr (kE % 4 == 0) {
#pragma unroll
    for (int j = 0; j < kE; j += 4) {
      const float4 f = *reinterpret_cast<const float4*>(src + j);
      v[j] = f.x;
      v[j + 1] = f.y;
      v[j + 2] = f.z;
      v[j + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kE; ++j) v[j] = src[j];
  }
}

template <int kE>
__device__ __forceinline__ void store_row(float* dst, const float (&v)[kE]) {
  if constexpr (kE % 4 == 0) {
#pragma unroll
    for (int j = 0; j < kE; j += 4)
      *reinterpret_cast<float4*>(dst + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < kE; ++j) dst[j] = v[j];
  }
}

// The sum of a value over the kTPR lanes of a row (every lane gets it).
template <int kTPR>
__device__ __forceinline__ float row_sum(float s) {
#pragma unroll
  for (int m = 1; m < kTPR; m <<= 1) s += __shfl_xor_sync(kFull, s, m);
  return s;
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int m = 1; m < 32; m <<= 1) s += __shfl_xor_sync(kFull, s, m);
  return s;
}

// Values a lane holds after col_sums: each level over a lane bit halves
// them while there are two or more.
__host__ __device__ constexpr int col_count(int e, int tpr) {
  for (int m = tpr; m < 32; m <<= 1)
    if (e > 1) e /= 2;
  return e;
}

// One level of col_sums over lane bit kM: the lane keeps the lower or the
// upper half of its kCnt values (by its bit kM) and adds its partner's
// copy of that half; once a lane holds one value, both partners add.
template <int kCnt, int kM>
__device__ __forceinline__ void col_level(float* v, int lane, int& base, int& dup) {
  if constexpr (kM < 32) {
    if constexpr (kCnt > 1) {
      constexpr int kHalf = kCnt / 2;
      const bool up = (lane & kM) != 0;
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        const float send = up ? v[i] : v[i + kHalf];
        const float keep = up ? v[i + kHalf] : v[i];
        v[i] = keep + __shfl_xor_sync(kFull, send, kM);
      }
      if (up) base += kHalf;
      col_level<kHalf, 2 * kM>(v, lane, base, dup);
    } else {
      v[0] += __shfl_xor_sync(kFull, v[0], kM);
      dup |= kM;
      col_level<1, 2 * kM>(v, lane, base, dup);
    }
  }
}

// v: this lane's kE values of columns c0 .. c0 + kE - 1, in a row of the
// warp.  Sums each column over the warp's rows (the lanes that differ in
// bits kTPR .. 16) and writes each sum once, to out[column].
template <int kE, int kTPR>
__device__ __forceinline__ void col_sums(float (&v)[kE], int lane, float* out, int c0) {
  int base = 0, dup = 0;
  col_level<kE, kTPR>(v, lane, base, dup);
  if ((lane & dup) == 0) {
    constexpr int kOut = col_count(kE, kTPR);
#pragma unroll
    for (int i = 0; i < kOut; ++i) out[c0 + base + i] = v[i];
  }
}

// out[o, i] = sum over k = 0, 1, ... of in[o, k, i], one thread an output.
__device__ __forceinline__ void sum_mid(const float* in, float* out, long long outer,
                                        int K, long long inner) {
  const long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (e >= outer * inner) return;
  const float* src = in + (e / inner) * K * inner + e % inner;
  float s = 0.f;
  for (int k = 0; k < K; ++k) s += src[k * inner];
  out[e] = s;
}

inline cudaError_t launch_sum(void (*kernel)(const float*, float*, long long, int, long long),
                              const float* in, float* out, long long outer, int K,
                              long long inner, cudaStream_t st) {
  const long long n = outer * inner;
  if (n == 0) return cudaSuccess;
  kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(in, out, outer, K, inner);
  return cudaGetLastError();
}

}  // namespace scan_bwd
