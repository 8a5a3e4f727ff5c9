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
// Design: the card reaches its copy rate only with enough independent
// loads in flight.  One warp copies one row: it loads the row's index
// (one broadcast load), then each lane issues kPerLane independent 16-byte
// loads (a 4096-byte page is 32 lanes x 8 vectors, every load instruction
// 512 contiguous bytes) before any of its stores.  The first port's
// kernel moved one vector a thread behind a dependent index load and
// walked the pages grid-stride; here nothing loops across rows: the grid
// is one warp per row, short-lived, and the block scheduler keeps every SM
// full as warps retire.  On the H100 this beat both a grid of resident
// CTAs walking rows grid-stride with 8 rows in flight and a ring of TMA
// bulk copies driven by one thread per SM.  When the row width or a base
// pointer is not 16-byte aligned, the same loop moves bytes.  A scatter is
// the same copy with the index on the store side.  An index outside the
// indexed side's rows stops the kernel with a device-side assert, as
// torch.index_select does, so the wrapper needs no host synchronisation
// to check the indices.  The 128-lane padding of the TPU wrapper has no
// purpose here and is not carried over.

#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                // rows a CTA
constexpr int kPerLane = 8;              // loads a lane keeps in flight

template <typename V>
__global__ void __launch_bounds__(32 * kWarps)
copy_rows(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
          const int64_t* __restrict__ idx, int64_t n, int64_t n_indexed,
          int64_t row_bytes, bool gather) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (i >= n) return;
  const int lane = threadIdx.x & 31;
  const int64_t j = idx[i];
  assert(j >= 0 && j < n_indexed);
  const V* s = reinterpret_cast<const V*>(src + (gather ? j : i) * row_bytes);
  V* d = reinterpret_cast<V*>(dst + (gather ? i : j) * row_bytes);
  const int64_t elems = row_bytes / static_cast<int64_t>(sizeof(V));
  for (int64_t c0 = lane; c0 < elems; c0 += 32 * kPerLane) {
    V buf[kPerLane];
#pragma unroll
    for (int r = 0; r < kPerLane; ++r)
      if (c0 + 32 * r < elems) buf[r] = s[c0 + 32 * r];
#pragma unroll
    for (int r = 0; r < kPerLane; ++r)
      if (c0 + 32 * r < elems) d[c0 + 32 * r] = buf[r];
  }
}

int launch(const void* src, void* dst, const void* idx, int64_t n,
           int64_t n_indexed, int64_t row_bytes, bool gather, void* stream) {
  if (n <= 0 || row_bytes <= 0) return static_cast<int>(cudaSuccess);
  const bool vec = row_bytes % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  const auto blocks = static_cast<unsigned>((n + kWarps - 1) / kWarps);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* src8 = static_cast<const uint8_t*>(src);
  auto* dst8 = static_cast<uint8_t*>(dst);
  const auto* idx64 = static_cast<const int64_t*>(idx);
  if (vec)
    copy_rows<uint4><<<blocks, 32 * kWarps, 0, s>>>(src8, dst8, idx64, n,
                                                    n_indexed, row_bytes, gather);
  else
    copy_rows<uint8_t><<<blocks, 32 * kWarps, 0, s>>>(
        src8, dst8, idx64, n, n_indexed, row_bytes, gather);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out[i, :] = table[idx[i], :] for i < n; table has n_table rows of
// row_bytes bytes.
int gather_pages(const void* table, const void* idx, void* out, int64_t n,
                 int64_t n_table, int64_t row_bytes, void* stream) {
  return launch(table, out, idx, n, n_table, row_bytes, true, stream);
}

// dest[idx[i], :] = ws[i, :] for i < n, in place; dest has n_dest rows, and
// the rows not written keep their bytes.
int scatter_pages(const void* ws, const void* idx, void* dest, int64_t n,
                  int64_t n_dest, int64_t row_bytes, void* stream) {
  return launch(ws, dest, idx, n, n_dest, row_bytes, false, stream);
}

}  // extern "C"
