// Page gather / scatter for the REAP working-set install, sm_90a.
//
// Replaces the Pallas kernels in src/repro/kernels/page_gather/kernel.py:
//   page_gather  -> gather_pages:  out[i, :] = table[idx[i], :]
//   page_scatter -> scatter_pages: dest[idx[i], :] = ws[i, :]   (in place)
//
// Bound on the H100: pure data movement.  Every row is read once and
// written once, so the least time is 2 * n * row_bytes / 3.35 TB/s
// (about 1.3 ms for olmo-1b's 2.16 GB working set).  Nothing is computed.
//
// Design: one CTA walks rows grid-stride, so the grid stays a few blocks
// per SM whatever n is.  Each CTA loads its own row index (there is no
// scalar prefetch on this card).  When the row width and both base
// pointers are 16-byte aligned, each thread moves 16-byte vectors, so 256
// threads move one 4096-byte page per pass with fully coalesced 128-bit
// loads and stores; any other width takes the byte path.  The 128-lane
// padding of the TPU wrapper has no purpose here and is not carried over.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
copy_rows(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
          const int64_t* __restrict__ idx, int64_t n, int64_t row_bytes,
          bool gather) {
  for (int64_t i = blockIdx.x; i < n; i += gridDim.x) {
    const int64_t j = idx[i];
    const uint8_t* s = src + (gather ? j : i) * row_bytes;
    uint8_t* d = dst + (gather ? i : j) * row_bytes;
    if (kVec) {
      const uint4* s4 = reinterpret_cast<const uint4*>(s);
      uint4* d4 = reinterpret_cast<uint4*>(d);
      const int64_t nv = row_bytes / 16;
      for (int64_t k = threadIdx.x; k < nv; k += kThreads) d4[k] = s4[k];
    } else {
      for (int64_t k = threadIdx.x; k < row_bytes; k += kThreads) d[k] = s[k];
    }
  }
}

int launch(const void* src, void* dst, const void* idx, int64_t n,
           int64_t row_bytes, bool gather, void* stream) {
  if (n <= 0 || row_bytes <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = static_cast<int>(n < kMaxBlocks ? n : kMaxBlocks);
  const bool vec = row_bytes % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* src8 = static_cast<const uint8_t*>(src);
  auto* dst8 = static_cast<uint8_t*>(dst);
  const auto* idx64 = static_cast<const int64_t*>(idx);
  if (vec) {
    copy_rows<true><<<blocks, kThreads, 0, s>>>(src8, dst8, idx64, n,
                                                row_bytes, gather);
  } else {
    copy_rows<false><<<blocks, kThreads, 0, s>>>(src8, dst8, idx64, n,
                                                 row_bytes, gather);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out[i, :] = table[idx[i], :] for i < n; rows are row_bytes wide.
int gather_pages(const void* table, const void* idx, void* out, int64_t n,
                 int64_t row_bytes, void* stream) {
  return launch(table, out, idx, n, row_bytes, true, stream);
}

// dest[idx[i], :] = ws[i, :] for i < n, in place; other rows keep their bytes.
int scatter_pages(const void* ws, const void* idx, void* dest, int64_t n,
                  int64_t row_bytes, void* stream) {
  return launch(ws, dest, idx, n, row_bytes, false, stream);
}

}  // extern "C"
