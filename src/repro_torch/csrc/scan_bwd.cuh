// Pieces the scans' backward kernels share (mamba2_scan.cu, rwkv6_scan.cu).
//
// tiles_mma: 16 x 8 tiles of a product of two operands read from shared
// memory through accessors, at split TF32 (tf32_mma.cuh).  warp_sum and
// lane_sums: sums over the warp's lanes by shuffles.  sum_mid: an
// ordered sum over the middle index, which adds per-CTA parts (over
// heads, batches or chunks) in index order.  Every sum is taken in a fixed order and none uses
// atomics, so two calls on the same inputs give the same bytes.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace scan_bwd {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int m = 1; m < 32; m <<= 1) s += __shfl_xor_sync(kFull, s, m);
  return s;
}

// One level of lane_sums: the lane keeps the lower or the upper kH of
// its 2 kH values (by its lane bit kH) and adds its partner's copy of them.
template <int kH>
__device__ __forceinline__ void halve(float* v, int lane) {
  const bool up = (lane & kH) != 0;
#pragma unroll
  for (int i = 0; i < kH; ++i) {
    const float send = up ? v[i] : v[i + kH];
    const float keep = up ? v[i + kH] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, kH);
  }
}

// Lane l gets the sum over the warp's lanes of v[l % 16]: 16 shuffles for
// 16 sums, where 16 warp_sums take 80.
__device__ __forceinline__ float lane_sums(float (&v)[16], int lane) {
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
  return v[0] + __shfl_xor_sync(kFull, v[0], 16);
}

// acc[j] (the 16 x 8 tile at rows m0 .., columns n0 + 8 j ..) += the sum
// over k = k0 .. k1 - 1 (a multiple of 8 apart) of a(m, k) b(k, n), at
// split TF32: each k-step of 8 in a fresh accumulator, then a rounded add.
// The A fragment of a k-step is read and split once for the kNG tiles,
// and their products run pass by pass (tf32::mma_pass), several in
// flight.  a and b return float32 values; an operand exact in TF32
// (bfloat16 values: kExactA, kExactB) skips its lo product.
template <bool kExactA, bool kExactB, int kNG, typename FA, typename FB>
__device__ __forceinline__ void tiles_mma(float (&acc)[kNG][4], const FA& a, const FB& b,
                                          int m0, int n0, int k0, int k1, int g, int t) {
#pragma unroll 2
  for (int k = k0; k < k1; k += 8) {
    const tf32::FragA fa = tf32::split_a(a(m0 + g, k + t), a(m0 + g + 8, k + t),
                                         a(m0 + g, k + t + 4), a(m0 + g + 8, k + t + 4));
    tf32::FragB fb[kNG];
#pragma unroll
    for (int j = 0; j < kNG; ++j)
      fb[j] = tf32::split_b(b(k + t, n0 + 8 * j + g), b(k + t + 4, n0 + 8 * j + g));
    float part[kNG][4] = {};
#pragma unroll
    for (int pass = 0; pass < 3; ++pass)
#pragma unroll
      for (int j = 0; j < kNG; ++j)
        tf32::mma_pass<kExactB, kExactA>(part[j], fa, fb[j], pass);
#pragma unroll
    for (int j = 0; j < kNG; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
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
