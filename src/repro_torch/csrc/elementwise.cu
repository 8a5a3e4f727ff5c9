// The forward's elementwise chains, one pass each, sm_90a.
//
// Replaces no Pallas kernel: XLA fuses these chains in the JAX package
// (src/repro/nn/layers.py apply_nonparam_ln, apply_rmsnorm, apply_rope and
// apply_mlp's gate), while PyTorch runs them an op at a time, each op
// reading and writing a float32 copy of the activations.
//   norm_rows  y = (x - mean) * rsqrt(var + eps)              (OLMo's LN)
//              y = x * rsqrt(mean(x^2) + eps) [* scale]       (RMSNorm)
//   rope_qk    q and k rotated in one launch (H and KV heads may differ)
//   swiglu     h = round(silu(g)) * u
//
// Bound on the H100: bytes.  Each kernel reads its bfloat16 (or float32)
// inputs once and writes its output once, at a few operations an element;
// everything float32 stays in registers.  Loads and stores are 16-byte
// vectors (8 bfloat16 or 4 float32 values), consecutive threads on
// consecutive vectors, and every grid has far more CTAs than the 132 SMs at
// the forward's shapes.
//
// Casting points are the plain versions' (kernels/elementwise/ref.py, the
// JAX package's): compute in float32 and round to the input dtype where
// they round.  Each product and sum the plain version rounds on its own is
// written with __fmul_rn / __fadd_rn / __fsub_rn, so nvcc cannot contract
// a pair into an FMA; silu is x / (1 + expf(-x)), PyTorch's own formula
// (no fast math).  So rope_qk and swiglu give the plain versions' bytes,
// and norm_rows differs only in the order of its row sums.
//
// norm_rows: a row of d values is held in registers by tpr threads (a
//   power of two, at most kThreads), NV 16-byte vectors a thread, kept as
//   raw bits (the float32 values are unpacked again for each pass).  The
//   launch picks tpr as the least power of two that keeps NV <= kMaxNV:
//   one warp a row at d = 2048 bfloat16, CTAs of kThreads threads hold
//   kThreads / tpr rows.  The mean, then the centred sum of squares (two
//   passes over the registers, as torch.var(unbiased=False) and not
//   E[x^2] - E[x]^2), reduce by warp shuffles, and through shared memory
//   where a row spans several warps.
// rope_qk: one thread a vector of x1 (element i of a head row, i < D/2)
//   and its partner x2 (element i + D/2), with the vectors of the cos/sin
//   table ((S, D/2) or (B, S, D/2) float32, shared by every head of a token,
//   so read from L2).  q and k are read through their strides and written
//   contiguous.
// swiglu: one thread a vector of g and u, rows read through their stride.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;            // threads a CTA (every kernel)
constexpr int kMaxNV = 8;                // norm_rows: 16-byte vectors a thread

template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  __device__ static float round(float a) { return a; }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack2(uint32_t w, float* f) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ static void unpack(const uint4& r, float* f) {
    unpack2(r.x, f);
    unpack2(r.y, f + 2);
    unpack2(r.z, f + 4);
    unpack2(r.w, f + 6);
  }
  __device__ static uint32_t pack2(float a, float b) {
    __nv_bfloat162 h = __floats2bfloat162_rn(a, b);   // a in the low half
    return *reinterpret_cast<uint32_t*>(&h);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                      pack2(f[6], f[7]));
  }
  // a float32 value rounded to bfloat16 (to nearest even) and back
  __device__ static float round(float a) {
    return __bfloat162float(__float2bfloat16_rn(a));
  }
};

__device__ inline uint4 ld16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ inline void st16(void* p, const uint4& v) {
  *reinterpret_cast<uint4*>(p) = v;
}

// Sum of v over the tpr threads of each row (tpr a power of two; the rows
// of a CTA are consecutive runs of tpr threads).  Every thread of the CTA
// calls it, active or not.  red: kThreads / 32 floats of shared memory.
__device__ inline float row_sum(float v, int tpr, float* red) {
  const int w = tpr < 32 ? tpr : 32;
  for (int o = w >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (tpr <= 32) return v;
  const int warp = threadIdx.x >> 5, per_row = tpr >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  const int first = warp / per_row * per_row;
  float s = 0.f;
  for (int i = 0; i < per_row; ++i) s += red[first + i];
  return s;
}

// kind 0: non-parametric LayerNorm; 1: RMSNorm (scale may be null).
template <typename T, int NV, int KIND>
__global__ void __launch_bounds__(kThreads)
norm_rows_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                 T* __restrict__ y, int64_t rows, int d, int64_t x_rs, int tpr,
                 float eps, float inv_d) {
  using P = Pack<T>;
  constexpr int N = P::N;
  __shared__ float red_a[kThreads / 32], red_b[kThreads / 32];
  const int lane = threadIdx.x % tpr;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / tpr) + threadIdx.x / tpr;
  const bool live = row < rows;
  const int nvec = d / N;
  const T* xr = x + (live ? row : 0) * x_rs;
  uint4 raw[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c = lane + v * tpr;
    raw[v] = live && c < nvec ? ld16(xr + c * N) : make_uint4(0u, 0u, 0u, 0u);
  }
  float mean = 0.f;
  if (KIND == 0) {
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      float f[N];
      P::unpack(raw[v], f);
#pragma unroll
      for (int j = 0; j < N; ++j) s += f[j];
    }
    mean = __fmul_rn(row_sum(s, tpr, red_a), inv_d);
  }
  float q = 0.f;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    if (lane + v * tpr >= nvec) continue;     // past the row (its zeros minus the mean)
    float f[N];
    P::unpack(raw[v], f);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float t = KIND == 0 ? f[j] - mean : f[j];
      q += t * t;
    }
  }
  const float r = rsqrtf(__fadd_rn(__fmul_rn(row_sum(q, tpr, red_b), inv_d), eps));
  if (!live) return;
  T* yr = y + row * static_cast<int64_t>(d);
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c = lane + v * tpr;
    if (c >= nvec) continue;
    float f[N];
    P::unpack(raw[v], f);
#pragma unroll
    for (int j = 0; j < N; ++j)
      f[j] = __fmul_rn(KIND == 0 ? __fsub_rn(f[j], mean) : f[j], r);
    if (KIND == 1 && scale != nullptr) {
      float sc[N];
#pragma unroll
      for (int j = 0; j < N; j += 4) {
        const uint4 s4 = ld16(scale + c * N + j);
        Pack<float>::unpack(s4, sc + j);
      }
#pragma unroll
      for (int j = 0; j < N; ++j) f[j] = __fmul_rn(f[j], sc[j]);
    }
    st16(yr + c * N, P::pack(f));
  }
}

template <typename T, int KIND>
int launch_norm(const void* x, const float* scale, void* y, int64_t rows, int d,
                int64_t x_rs, float eps, cudaStream_t st) {
  constexpr int N = Pack<T>::N;
  const int nvec = d / N;
  int tpr = 1;
  while (tpr * kMaxNV < nvec) tpr <<= 1;
  if (tpr > kThreads) return static_cast<int>(cudaErrorInvalidValue);
  int nv = 1;
  while (nv * tpr < nvec) nv <<= 1;
  const auto blocks = static_cast<unsigned>((rows + kThreads / tpr - 1) / (kThreads / tpr));
  const float inv_d = 1.0f / static_cast<float>(d);
  const auto* xp = static_cast<const T*>(x);
  auto* yp = static_cast<T*>(y);
#define NORM_LAUNCH(NV)                                                          \
  norm_rows_kernel<T, NV, KIND><<<blocks, kThreads, 0, st>>>(xp, scale, yp, rows, d, \
                                                             x_rs, tpr, eps, inv_d)
  switch (nv) {
    case 1: NORM_LAUNCH(1); break;
    case 2: NORM_LAUNCH(2); break;
    case 4: NORM_LAUNCH(4); break;
    case 8: NORM_LAUNCH(8); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef NORM_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rope_qk_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const float* __restrict__ cos_t, const float* __restrict__ sin_t,
               T* __restrict__ qo, T* __restrict__ ko, uint32_t items, uint32_t S,
               uint32_t H, uint32_t heads, uint32_t nvh, int D, int64_t q_sb,
               int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
               int64_t t_sb) {
  using P = Pack<T>;
  constexpr int N = P::N;
  const uint32_t i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= items) return;
  const uint32_t v = i % nvh, rrow = i / nvh;
  const uint32_t h = rrow % heads, tok = rrow / heads;
  const uint32_t s = tok % S, b = tok / S;
  const int half = D / 2;
  const T* src;
  T* dst;
  if (h < H) {
    src = q + b * q_sb + s * q_ss + h * q_sh;
    dst = qo + (static_cast<int64_t>(tok) * H + h) * D;
  } else {
    const uint32_t kh = h - H, KV = heads - H;
    src = k + b * k_sb + s * k_ss + kh * k_sh;
    dst = ko + (static_cast<int64_t>(tok) * KV + kh) * D;
  }
  const int64_t t = b * t_sb + static_cast<int64_t>(s) * half + v * N;
  float x1[N], x2[N], c[N], sn[N];
  P::unpack(ld16(src + v * N), x1);
  P::unpack(ld16(src + half + v * N), x2);
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    Pack<float>::unpack(ld16(cos_t + t + j), c + j);
    Pack<float>::unpack(ld16(sin_t + t + j), sn + j);
  }
  float o1[N], o2[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    o1[j] = __fsub_rn(__fmul_rn(x1[j], c[j]), __fmul_rn(x2[j], sn[j]));
    o2[j] = __fadd_rn(__fmul_rn(x2[j], c[j]), __fmul_rn(x1[j], sn[j]));
  }
  st16(dst + v * N, P::pack(o1));
  st16(dst + half + v * N, P::pack(o2));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
swiglu_kernel(const T* __restrict__ g, const T* __restrict__ u, T* __restrict__ h,
              uint32_t items, uint32_t vpr, int64_t g_rs, int64_t u_rs) {
  using P = Pack<T>;
  constexpr int N = P::N;
  const uint32_t i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= items) return;
  const uint32_t r = i / vpr, c = i % vpr;
  float gf[N], uf[N], hf[N];
  P::unpack(ld16(g + r * g_rs + c * N), gf);
  P::unpack(ld16(u + r * u_rs + c * N), uf);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    // F.silu's formula, rounded to the activations' dtype before the product
    const float sl = P::round(gf[j] / (1.0f + expf(-gf[j])));
    hf[j] = __fmul_rn(sl, uf[j]);
  }
  st16(h + static_cast<int64_t>(i) * N, P::pack(hf));
}

template <typename T>
int launch_rope(const void* q, const void* k, const float* cos_t, const float* sin_t,
                void* qo, void* ko, int B, int S, int H, int KV, int D, int64_t q_sb,
                int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
                int64_t t_sb, cudaStream_t st) {
  constexpr int N = Pack<T>::N;
  const int64_t nvh = D / 2 / N;
  const int64_t items = static_cast<int64_t>(B) * S * (H + KV) * nvh;
  if (items <= 0) return static_cast<int>(cudaSuccess);
  if (items > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const auto blocks = static_cast<unsigned>((items + kThreads - 1) / kThreads);
  rope_qk_kernel<T><<<blocks, kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), cos_t, sin_t,
      static_cast<T*>(qo), static_cast<T*>(ko), static_cast<uint32_t>(items),
      static_cast<uint32_t>(S), static_cast<uint32_t>(H),
      static_cast<uint32_t>(H + KV), static_cast<uint32_t>(nvh), D, q_sb, q_ss, q_sh,
      k_sb, k_ss, k_sh, t_sb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_swiglu(const void* g, const void* u, void* h, int64_t rows, int width,
                  int64_t g_rs, int64_t u_rs, cudaStream_t st) {
  constexpr int N = Pack<T>::N;
  const int64_t vpr = width / N;
  const int64_t items = rows * vpr;
  if (items <= 0) return static_cast<int>(cudaSuccess);
  if (items > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const auto blocks = static_cast<unsigned>((items + kThreads - 1) / kThreads);
  swiglu_kernel<T><<<blocks, kThreads, 0, st>>>(
      static_cast<const T*>(g), static_cast<const T*>(u), static_cast<T*>(h),
      static_cast<uint32_t>(items), static_cast<uint32_t>(vpr), g_rs, u_rs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; every row
// (and for rope_qk each half of a head row) starts on a 16-byte boundary
// and has a whole number of 16-byte vectors: the wrappers check.  Outputs
// are contiguous.

// y[r, :] = norm(x[r * x_rs : r * x_rs + d]) for r < rows.  kind 0: LN
// (scale unused), 1: RMSNorm, times scale (d float32) unless it is null.
int norm_rows(const void* x, const void* scale, void* y, int64_t rows, int d,
              int64_t x_rs, int kind, int dtype, float eps, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* sc = static_cast<const float*>(scale);
  if (dtype == 0)
    return kind == 0 ? launch_norm<float, 0>(x, sc, y, rows, d, x_rs, eps, st)
                     : launch_norm<float, 1>(x, sc, y, rows, d, x_rs, eps, st);
  if (dtype == 1)
    return kind == 0 ? launch_norm<__nv_bfloat16, 0>(x, sc, y, rows, d, x_rs, eps, st)
                     : launch_norm<__nv_bfloat16, 1>(x, sc, y, rows, d, x_rs, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// q (B, S, H, D) and k (B, S, KV, D) through their strides -> qo, ko
// contiguous; cos/sin (S, D/2) float32 (t_sb = 0)
// or (B, S, D/2) (t_sb = S * D/2).
int rope_qk(const void* q, const void* k, const void* cos_t, const void* sin_t,
            void* qo, void* ko, int B, int S, int H, int KV, int D, int dtype,
            int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
            int64_t k_sh, int64_t t_sb, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const float*>(cos_t);
  const auto* s = static_cast<const float*>(sin_t);
  if (dtype == 0)
    return launch_rope<float>(q, k, c, s, qo, ko, B, S, H, KV, D, q_sb, q_ss, q_sh,
                              k_sb, k_ss, k_sh, t_sb, st);
  if (dtype == 1)
    return launch_rope<__nv_bfloat16>(q, k, c, s, qo, ko, B, S, H, KV, D, q_sb, q_ss,
                                      q_sh, k_sb, k_ss, k_sh, t_sb, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// h[r, :] = round(silu(g[r, :])) * u[r, :] for r < rows, width values a row.
int swiglu(const void* g, const void* u, void* h, int64_t rows, int width,
           int64_t g_rs, int64_t u_rs, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_swiglu<float>(g, u, h, rows, width, g_rs, u_rs, st);
  if (dtype == 1)
    return launch_swiglu<__nv_bfloat16>(g, u, h, rows, width, g_rs, u_rs, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
