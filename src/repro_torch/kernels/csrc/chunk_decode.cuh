// Warp-per-row decode of one 128-slot chunk row of a chunk-compressed
// int32 lane (repro_torch/core/compressed.py's ChunkedStream), shared by
// the chunked segment sums' key source (segment_reduce.cu) and the
// standalone decode kernels (delta_decode.cu), so both decode by one text.
//
// Layout: anchor int32, int8 or int16 deltas (column 0 holds 0), up to
// K <= 32 escapes (ovf_pos, ovf_add: the escaped delta's column and full
// value; a column < 0 acts at column 0, a column >= 128 never acts); the
// adaptive layout has one int8 lane, a per-chunk wide tag and a compacted
// hi-byte plane.  A wide chunk's row in that plane is the number of wide
// chunks before it, clamped to [0, H): the caller finds it and passes it
// in (the decode kernel by a look-back over the tags, the segment sums
// from their wrapper's index), so no (R, 128) gathered plane exists.
//
// A warp decodes a row, 4 consecutive slots a lane, in two steps, so that
// a caller can put several rows' loads in flight before it uses any:
//   * load_row issues the row's loads: the lane's 4 deltas as one 32-bit
//     (int8) or 64-bit (int16) load (the wrapper checks the lane's base is
//     aligned), the anchor, and entry `lane` of the escape table;
//   * finish_row adds only the escapes that act in the row (a ballot of
//     the live entries, then one pass per set bit), takes the width select
//     wide ? hi * 256 + (lane & 0xFF) : lane with the 4 hi bytes the caller
//     loaded (load_hi), and a warp inclusive scan plus the anchor gives the
//     decoded ids.
// decode_row is the two in one for a single row.  All arithmetic is
// unsigned, so the decode wraps in 32 bits as the reference's int32 cumsum
// does, with no signed overflow.
#pragma once

#include <cuda_runtime.h>

namespace repro_chunk {

constexpr int kChunk = 128;
constexpr int kSlotsPerLane = kChunk / 32;

struct ChunkedLane {
  const int* anchors;         // int32[R]
  const void* deltas;         // int8 or int16 [R, 128], base aligned to 4 slots
  const signed char* hi;      // adaptive: int8[H, 128], base 4-byte aligned
  const unsigned char* wide;  // adaptive: bool[R]
  const int* ovf_pos;         // int32[R, K]
  const int* ovf_add;         // int32[R, K]
  long long R;
  int K;
  int H;
};

// One lane's share of a row, as loaded.
struct RowLoads {
  unsigned lo;   // int8: the lane's 4 deltas; int16: its deltas 0 and 1
  unsigned hi2;  // int16: its deltas 2 and 3
  int anchor;
  int pos;  // escape entry `lane` (kChunk, which never acts, past K)
  int add;
};

template <int kWidth>
__device__ __forceinline__ RowLoads load_row(const ChunkedLane& c, long long r, int lane) {
  RowLoads x;
  const long long s = r * kChunk + lane * kSlotsPerLane;
  if (kWidth == 1) {
    x.lo = __ldg(reinterpret_cast<const unsigned*>(static_cast<const signed char*>(c.deltas) + s));
    x.hi2 = 0u;
  } else {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(static_cast<const short*>(c.deltas) + s));
    x.lo = w.x;
    x.hi2 = w.y;
  }
  x.anchor = __ldg(c.anchors + r);
  x.pos = kChunk;
  x.add = 0;
  if (lane < c.K) {
    x.pos = __ldg(c.ovf_pos + r * c.K + lane);
    x.add = __ldg(c.ovf_add + r * c.K + lane);
  }
  return x;
}

// The lane's 4 bytes of hi-plane row `hrow`.
__device__ __forceinline__ unsigned load_hi(const ChunkedLane& c, int hrow, int lane) {
  return __ldg(reinterpret_cast<const unsigned*>(c.hi + static_cast<long long>(hrow) * kChunk) +
               lane);
}

// Decoded ids of the row whose loads are `x`, columns 4 * lane .. 4 * lane
// + 3, into v; `wide` rows take their hi bytes from hi4.  Every lane of the
// warp must call it for the same row (it shuffles).
template <int kWidth, bool kAdaptive>
__device__ __forceinline__ void finish_row(const RowLoads& x, bool wide, unsigned hi4, int lane,
                                           int (&v)[kSlotsPerLane]) {
  const unsigned full = 0xffffffffu;
  unsigned d[kSlotsPerLane];
#pragma unroll
  for (int j = 0; j < kSlotsPerLane; ++j) {
    int dj;
    if (kWidth == 1) {
      const unsigned b = (x.lo >> (8 * j)) & 0xFFu;
      dj = static_cast<signed char>(b);
      if (kAdaptive && wide) {
        dj = static_cast<int>(static_cast<signed char>((hi4 >> (8 * j)) & 0xFFu)) * 256 +
             static_cast<int>(b);
      }
    } else {
      const unsigned w = j < 2 ? x.lo : x.hi2;
      dj = static_cast<short>((w >> (16 * (j & 1))) & 0xFFFFu);
    }
    d[j] = static_cast<unsigned>(dj);
  }
  // escapes: entry k sits on lane k; only the live ones (column < 128)
  // are visited, each added at its column (a negative column acts at
  // column 0, as in decode_rows)
  const int c0 = lane * kSlotsPerLane;
  unsigned live = __ballot_sync(full, x.pos < kChunk);
  while (live != 0u) {
    const int k = __ffs(live) - 1;
    live &= live - 1u;
    const int pk = max(__shfl_sync(full, x.pos, k), 0);
    const unsigned ak = static_cast<unsigned>(__shfl_sync(full, x.add, k));
#pragma unroll
    for (int j = 0; j < kSlotsPerLane; ++j) d[j] += pk == c0 + j ? ak : 0u;
  }
#pragma unroll
  for (int j = 1; j < kSlotsPerLane; ++j) d[j] += d[j - 1];
  unsigned incl = d[kSlotsPerLane - 1];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned t = __shfl_up_sync(full, incl, off);
    if (lane >= off) incl += t;
  }
  const unsigned base = static_cast<unsigned>(x.anchor) + (incl - d[kSlotsPerLane - 1]);
#pragma unroll
  for (int j = 0; j < kSlotsPerLane; ++j) v[j] = static_cast<int>(base + d[j]);
}

// Decoded ids of row r, columns 4 * lane .. 4 * lane + 3, into v; `hrow`
// is the row's hi-plane row, or < 0 for a narrow row (always for a fixed
// layout).  Every lane of the warp must call it for the same row.
template <int kWidth, bool kAdaptive>
__device__ __forceinline__ void decode_row(const ChunkedLane& c, long long r, int lane, int hrow,
                                           int (&v)[kSlotsPerLane]) {
  const RowLoads x = load_row<kWidth>(c, r, lane);
  const bool wide = kAdaptive && hrow >= 0;
  finish_row<kWidth, kAdaptive>(x, wide, wide ? load_hi(c, hrow, lane) : 0u, lane, v);
}

}  // namespace repro_chunk
