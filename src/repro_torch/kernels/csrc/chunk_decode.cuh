// Warp-per-row decode of one 128-slot chunk row of a chunk-compressed
// int32 lane (repro_torch/core/compressed.py's ChunkedStream), shared by
// the chunked segment sums' key source (segment_reduce.cu) and the
// standalone decode kernels (delta_decode.cu), so both decode by one text.
//
// Layout: anchor int32, int8 or int16 deltas (column 0 holds 0), up to
// K <= 32 escapes (ovf_pos, ovf_add: the escaped delta's column and full
// value; a column < 0 acts at column 0, a column >= 128 never acts); the
// adaptive layout has one int8 lane, a per-chunk wide tag and a compacted
// hi-byte plane read through hi_row[r] = cumsum(wide) - 1 (an O(R) index
// built by the wrapper, so no (R, 128) gathered plane exists).
//
// One warp per chunk row, 4 consecutive slots per lane: each lane loads
// its 4 deltas (adaptive wide: hi * 256 + (lane & 0xFF)), adds the escapes
// that fall in its slots (table entries broadcast by shuffle), and a warp
// inclusive scan plus the anchor gives the decoded ids.  All arithmetic is
// unsigned, so the decode wraps in 32 bits as the reference's int32 cumsum
// does, with no signed overflow.
#pragma once

#include <cuda_runtime.h>

namespace repro_chunk {

constexpr int kChunk = 128;
constexpr int kSlotsPerLane = kChunk / 32;

struct ChunkedLane {
  const int* anchors;         // int32[R]
  const void* deltas;         // int8 or int16 [R, 128]
  const signed char* hi;      // adaptive: int8[H, 128]
  const unsigned char* wide;  // adaptive: bool[R]
  const int* hi_row;          // adaptive: int32[R], row of each chunk in hi
  const int* ovf_pos;         // int32[R, K]
  const int* ovf_add;         // int32[R, K]
  long long R;
  int K;
  int H;
};

template <bool kAdaptive>
__device__ __forceinline__ bool is_wide(const ChunkedLane& c, long long r) {
  return kAdaptive && c.H > 0 && c.wide[r] != 0;
}

template <int kWidth, bool kAdaptive>
__device__ __forceinline__ unsigned slot_delta(const ChunkedLane& c, long long r, int col,
                                               bool wide, int hrow) {
  int v;
  if (kWidth == 1) {
    v = static_cast<const signed char*>(c.deltas)[r * kChunk + col];
  } else {
    v = static_cast<const short*>(c.deltas)[r * kChunk + col];
  }
  if (kAdaptive && wide) {
    v = static_cast<int>(c.hi[static_cast<long long>(hrow) * kChunk + col]) * 256 + (v & 0xFF);
  }
  return static_cast<unsigned>(v);
}

// Decoded ids of row r, columns 4 * lane .. 4 * lane + 3, into v.  Every
// lane of the warp must call it for the same row (it shuffles).
template <int kWidth, bool kAdaptive>
__device__ __forceinline__ void decode_row(const ChunkedLane& c, long long r, int lane,
                                           int (&v)[kSlotsPerLane]) {
  const unsigned full = 0xffffffffu;
  const bool wide = is_wide<kAdaptive>(c, r);
  const int hrow = wide ? c.hi_row[r] : 0;
  const int c0 = lane * kSlotsPerLane;
  unsigned d[kSlotsPerLane];
#pragma unroll
  for (int j = 0; j < kSlotsPerLane; ++j) {
    d[j] = slot_delta<kWidth, kAdaptive>(c, r, c0 + j, wide, hrow);
  }
  // escapes: lane j < K holds entry j of the row's table; each is added at
  // its column (a negative column acts at column 0, as in decode_rows)
  int p = kChunk, a = 0;
  if (lane < c.K) {
    p = c.ovf_pos[r * c.K + lane];
    a = c.ovf_add[r * c.K + lane];
  }
  for (int j = 0; j < c.K; ++j) {
    const int pj = max(__shfl_sync(full, p, j), 0);
    const int aj = __shfl_sync(full, a, j);
    if (pj >= c0 && pj < c0 + kSlotsPerLane) d[pj - c0] += static_cast<unsigned>(aj);
  }
#pragma unroll
  for (int j = 1; j < kSlotsPerLane; ++j) d[j] += d[j - 1];
  unsigned incl = d[kSlotsPerLane - 1];
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned t = __shfl_up_sync(full, incl, off);
    if (lane >= off) incl += t;
  }
  const unsigned base = static_cast<unsigned>(c.anchors[r]) + (incl - d[kSlotsPerLane - 1]);
#pragma unroll
  for (int j = 0; j < kSlotsPerLane; ++j) v[j] = static_cast<int>(base + d[j]);
}

}  // namespace repro_chunk
