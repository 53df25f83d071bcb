// Chunk delta decode for Hopper (sm_90a): compressed int32 lanes back to
// int32 rows.
//
// Replaces the Pallas TPU kernels
//   repro/kernels/delta_decode.py:83   delta_decode_chunked
//   repro/kernels/delta_decode.py:162  delta_decode_chunked_adaptive
//   repro/kernels/delta_decode.py:210  delta_decode_padded
// The TPU kernels run a (row block, column block) grid whose column axis
// is sequential, carrying each row block's running sum in VMEM scratch,
// with (8k, 128k) tiles and the compacted hi plane pre-gathered to an
// aligned (R, 128) plane by the wrapper.  On Hopper blocks run in no
// order, so a row's carry lives in one warp's registers instead.
//
// Design.
//   * Chunked (fixed int8 / int16, and adaptive): one warp per 128-slot
//     chunk row, decoded by chunk_decode.cuh's decode_row (the text the
//     chunked segment sums run), then each lane stores its
//     4 consecutive ids as one 16-byte store, coalesced across the warp.
//     The hi plane is read through the O(R) row index hi_row built by the
//     wrapper; no (R, 128) gathered plane exists.
//   * Padded (any R, any L >= 1): one warp per row walks the row in
//     128-column tiles.  A tile is 4 coalesced loads of 32 columns (lane
//     j takes columns 32 * i + j), then 4 warp inclusive scans in turn,
//     each adding the running carry and passing its total on by shuffle.
//     Columns past L load 0 and store nothing.
//   * Arithmetic is unsigned and cast at the store: the reference's int32
//     cumsum wraps, and signed overflow is undefined in C++.
//
// Bound: bytes.  Padded reads 4 B per delta and 4 B per anchor and writes
// 4 B per id; chunked reads the stream's bytes (1 or 2 B per slot, the
// escape table, hi rows of wide chunks, tags) and writes 4 B per slot.
// The scans cost a few shuffles per 32 ids, far under the memory time.
#include <cuda_runtime.h>

#include "chunk_decode.cuh"

namespace {

using namespace repro_chunk;  // NOLINT: the shared chunk-row decode

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;  // padded: columns per warp step

template <int kWidth, bool kAdaptive>
__global__ void __launch_bounds__(kThreads)
    chunked_decode_kernel(ChunkedLane c, int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long r = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (r >= c.R) return;  // warp-uniform
  int v[kSlotsPerLane];
  decode_row<kWidth, kAdaptive>(c, r, lane, v);
  reinterpret_cast<int4*>(out + r * kChunk)[lane] = make_int4(v[0], v[1], v[2], v[3]);
}

__global__ void __launch_bounds__(kThreads)
    padded_decode_kernel(const int* __restrict__ anchors, const int* __restrict__ deltas,
                         int* __restrict__ out, long long R, int L) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long r = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (r >= R) return;  // warp-uniform
  const int* row = deltas + r * L;
  int* orow = out + r * L;
  unsigned carry = static_cast<unsigned>(__ldg(anchors + r));
  for (int t = 0; t < L; t += kTile) {
    unsigned d[kTile / 32];
#pragma unroll
    for (int i = 0; i < kTile / 32; ++i) {
      const int col = t + 32 * i + lane;
      d[i] = col < L ? static_cast<unsigned>(__ldg(row + col)) : 0u;
    }
#pragma unroll
    for (int i = 0; i < kTile / 32; ++i) {
      unsigned incl = d[i];
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned s = __shfl_up_sync(full, incl, off);
        if (lane >= off) incl += s;
      }
      const int col = t + 32 * i + lane;
      if (col < L) orow[col] = static_cast<int>(carry + incl);
      carry += __shfl_sync(full, incl, 31);
    }
  }
}

unsigned row_blocks(long long R) { return static_cast<unsigned>((R + kWarps - 1) / kWarps); }

int launch_chunked(const ChunkedLane& c, int width, bool adaptive, int* out, void* stream) {
  if (c.R <= 0) return static_cast<int>(cudaSuccess);
  if (c.K < 0 || c.K > 32) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (adaptive) {
    chunked_decode_kernel<1, true><<<row_blocks(c.R), kThreads, 0, s>>>(c, out);
  } else if (width == 1) {
    chunked_decode_kernel<1, false><<<row_blocks(c.R), kThreads, 0, s>>>(c, out);
  } else if (width == 2) {
    chunked_decode_kernel<2, false><<<row_blocks(c.R), kThreads, 0, s>>>(c, out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on `stream`
// and returns cudaGetLastError().
//
// Padded: anchors int32[R]; deltas int32[R, L] row-major (column 0 is
// summed like any other: the wrapper zeroes it); out int32[R, L] with
// out[i, j] = anchors[i] + deltas[i, 0] + ... + deltas[i, j].
extern "C" int repro_delta_decode_padded(const int* anchors, const int* deltas, int* out,
                                         long long R, int L, void* stream) {
  if (R <= 0 || L <= 0) return static_cast<int>(cudaSuccess);
  padded_decode_kernel<<<row_blocks(R), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      anchors, deltas, out, R, L);
  return static_cast<int>(cudaGetLastError());
}

// Chunked: anchors int32[R]; deltas int8 or int16 [R, 128] (`width`
// bytes); ovf_pos, ovf_add int32[R, K], K <= 32; out int32[R, 128],
// 16-byte aligned.  The adaptive one takes the int8 lane, hi int8[H, 128],
// wide bool[R] and hi_row int32[R] (cumsum(wide) - 1 clamped to [0, H));
// H == 0 reads every chunk narrow.
extern "C" int repro_delta_decode_chunked(const int* anchors, const void* deltas, int width,
                                          const int* ovf_pos, const int* ovf_add, int* out,
                                          long long R, int K, void* stream) {
  const ChunkedLane c{anchors, deltas, nullptr, nullptr, nullptr, ovf_pos, ovf_add, R, K, 0};
  return launch_chunked(c, width, false, out, stream);
}

extern "C" int repro_delta_decode_chunked_adaptive(const int* anchors, const void* deltas,
                                                   const void* hi, const void* wide,
                                                   const int* hi_row, int H, const int* ovf_pos,
                                                   const int* ovf_add, int* out, long long R,
                                                   int K, void* stream) {
  const ChunkedLane c{anchors, deltas, static_cast<const signed char*>(hi),
                      static_cast<const unsigned char*>(wide), hi_row, ovf_pos, ovf_add, R, K, H};
  return launch_chunked(c, 1, true, out, stream);
}
