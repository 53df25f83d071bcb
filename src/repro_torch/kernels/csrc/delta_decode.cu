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
//   * Chunked (fixed int8 / int16, and adaptive): a block decodes a tile
//     of kTileRows chunk rows, kRowsPerWarp a warp.  A warp issues every
//     load of its rows (chunk_decode.cuh's load_row: the anchor, the
//     lane's 4 deltas as one word, its escape entry) before it uses any,
//     then finishes each row (finish_row: the live escapes, the width
//     select, a warp scan) and stores each lane's 4 ids as one 16-byte
//     store, coalesced across the warp.  (A streaming store, st.global.cs,
//     for an output that outgrows the 50 MB L2, measured no faster.)
//   * Adaptive: a wide chunk's hi row is the number of wide chunks before
//     it, clamped to [0, H).  The kernels find it on the card, with no
//     per-call index: a pre-pass launch counts each tile's wide tags, a
//     tile a thread (its tags as 16-byte words), and finds the prefix of
//     every tile with a single-pass decoupled look-back (Merrill & Garland
//     2016, the scheme of CUB's single-pass scan): its blocks take 256
//     tiles each in ticket order (an atomicAdd on a counter that the last
//     ticket sets back to 0), so a block waits only on blocks that already
//     run; a block scans its tiles' counts, publishes its total at once,
//     and warp 0 walks back over the earlier blocks' status words, 128 at a
//     step, to the nearest inclusive prefix, then publishes its own and
//     writes each tile's prefix.  The decode then loads its tile's prefix
//     with its first loads and ranks the tile's wide rows with a ballot of
//     their tags, so only the hi rows' loads wait, on that one word.  A
//     status word packs the call's epoch, a flag and the count in one
//     64-bit store: words of an earlier call carry another epoch and read
//     as not yet published, so the buffer (kept per stream by the wrapper)
//     needs no clearing between calls.  The look-back inside the decode
//     itself, in one launch, was slower: a look-back per 32-row tile put
//     its chain and its ticket into every block's short life, and blocks
//     that each decode a run of tiles after one look-back need 64
//     registers, so fewer rows stay in flight (PERF.md §6).
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
constexpr int kRowsPerWarp = 4;  // chunked: rows a warp holds in flight
constexpr int kTileRows = kWarps * kRowsPerWarp;  // chunked: rows a block decodes at a time
constexpr int kTagWords = kTileRows / 32;
constexpr int kPrefixThreads = 256;  // adaptive pre-pass: tiles a block, a tile a thread
static_assert(kTileRows % 32 == 0 && kTileRows <= kThreads, "a tag a thread, whole warps");
constexpr unsigned kFull = 0xffffffffu;

// Look-back state: a ticket counter, zero between calls, and a status word
// per pre-pass block: epoch << 32 | flag << 30 | count (wide chunks in the
// block's tiles, or in them and every earlier block's).
constexpr unsigned kAggregate = 1u;
constexpr unsigned kInclusive = 2u;
constexpr unsigned kCountMask = (1u << 30) - 1u;
constexpr int kLookPerLane = 4;  // status words a lane reads in a look-back step

struct LookBack {
  unsigned* ticket;
  unsigned long long* status;
  unsigned epoch;  // nonzero, new for each call on the buffer
  unsigned n_blocks;
};

__device__ __forceinline__ unsigned long long status_word(unsigned epoch, unsigned flag,
                                                          unsigned count) {
  return (static_cast<unsigned long long>(epoch) << 32) | (flag << 30) | count;
}

// This block's place in ticket order; the last ticket zeroes the counter
// for the next call (every other block has taken its ticket by then).
__device__ __forceinline__ unsigned take_ticket(const LookBack& lb) {
  const unsigned t = atomicAdd(lb.ticket, 1u);
  if (t == lb.n_blocks - 1) *lb.ticket = 0u;
  return t;
}

// Wide chunks in the blocks before block `b`, whose own count is `agg`;
// warp 0 calls it, every lane gets the prefix.  Publishes the block's
// count at once and its inclusive prefix at the end.  A step reads 32 *
// kLookPerLane status words (lane l the words end - l * kLookPerLane - k,
// k < kLookPerLane, nearest first) and sums back to the nearest inclusive
// one; a step that finds an unpublished word before it reads again.
__device__ unsigned look_back(const LookBack& lb, unsigned b, unsigned agg, int lane) {
  volatile unsigned long long* st = lb.status;
  if (b == 0) {
    if (lane == 0) st[0] = status_word(lb.epoch, kInclusive, agg);
    return 0u;
  }
  if (lane == 0) st[b] = status_word(lb.epoch, kAggregate, agg);
  unsigned prefix = 0u;
  long long end = static_cast<long long>(b) - 1;  // the nearest block not yet summed
  for (;;) {
    unsigned flag[kLookPerLane], count[kLookPerLane];
    int first;       // this lane's nearest inclusive word, kLookPerLane if none
    int stop;        // the lane holding the step's nearest inclusive word, 31 if none
    unsigned found;  // lanes that hold an inclusive word
    for (;;) {
#pragma unroll
      for (int k = 0; k < kLookPerLane; ++k) {
        const long long j = end - (lane * kLookPerLane + k);
        const unsigned long long w = j >= 0 ? st[j] : status_word(lb.epoch, kInclusive, 0u);
        flag[k] = static_cast<unsigned>(w >> 32) == lb.epoch ? static_cast<unsigned>(w) >> 30
                                                               : 0u;
        count[k] = static_cast<unsigned>(w) & kCountMask;
      }
      first = kLookPerLane;
#pragma unroll
      for (int k = kLookPerLane - 1; k >= 0; --k) {
        if (flag[k] == kInclusive) first = k;
      }
      bool ready = true;  // every word up to this lane's nearest inclusive one published
#pragma unroll
      for (int k = 0; k < kLookPerLane; ++k) ready = ready && (k > first || flag[k] != 0u);
      found = __ballot_sync(kFull, first < kLookPerLane);
      stop = found != 0u ? __ffs(found) - 1 : 31;
      if (__all_sync(kFull, lane > stop || ready)) break;
    }
    unsigned v = 0u;
#pragma unroll
    for (int k = 0; k < kLookPerLane; ++k) v += lane <= stop && k <= first ? count[k] : 0u;
    prefix += __reduce_add_sync(kFull, v);
    if (found != 0u) break;
    end -= 32 * kLookPerLane;
  }
  if (lane == 0) st[b] = status_word(lb.epoch, kInclusive, prefix + agg);
  return prefix;
}

__device__ __forceinline__ void store_ids(int* p, const int (&v)[kSlotsPerLane]) {
  *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
}

// The warp's rows of the tile at row0 (those < R): every load issued.
template <int kWidth>
__device__ __forceinline__ void load_tile(const ChunkedLane& c, long long row0, int warp,
                                          int lane, RowLoads (&x)[kRowsPerWarp]) {
  const long long r = row0 + warp * kRowsPerWarp;
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) {
    if (r + q < c.R) x[q] = load_row<kWidth>(c, r + q, lane);
  }
}

// Decodes and stores the warp's rows of the tile at row0.  With `tags`
// (the tile's wide tags, bit i for row i; adaptive) a wide row reads hi
// row min(run + the wide rows before it in the tile, H - 1), `run` being
// the wide chunks before the tile.
template <int kWidth, bool kAdaptive>
__device__ __forceinline__ void finish_tile(const ChunkedLane& c, int* __restrict__ out,
                                            long long row0, const RowLoads (&x)[kRowsPerWarp],
                                            const unsigned* tags, unsigned run, int warp,
                                            int lane) {
  int hrow[kRowsPerWarp];  // hi-plane row, or -1 for a narrow row
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) {
    hrow[q] = -1;
    const int i = warp * kRowsPerWarp + q;
    if (kAdaptive && ((tags[i >> 5] >> (i & 31)) & 1u)) {
      unsigned before = run + __popc(tags[i >> 5] & ((1u << (i & 31)) - 1u));
      for (int k = 0; k < (i >> 5); ++k) before += __popc(tags[k]);
      hrow[q] = static_cast<int>(min(before, static_cast<unsigned>(c.H - 1)));
    }
  }
  unsigned h4[kRowsPerWarp];
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) h4[q] = hrow[q] >= 0 ? load_hi(c, hrow[q], lane) : 0u;
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) {
    const long long r = row0 + warp * kRowsPerWarp + q;
    if (r >= c.R) break;  // warp-uniform
    int v[kSlotsPerLane];
    finish_row<kWidth, kAdaptive>(x[q], hrow[q] >= 0, h4[q], lane, v);
    store_ids(out + r * kChunk + lane * kSlotsPerLane, v);
  }
}

// Adaptive pre-pass: prefix[t] = wide chunks in tiles 0 .. t - 1.
__global__ void __launch_bounds__(kPrefixThreads)
    tile_prefix_kernel(ChunkedLane c, LookBack lb, unsigned* __restrict__ prefix,
                       long long n_tiles) {
  constexpr int kPrefixWarps = kPrefixThreads / 32;
  __shared__ unsigned s_block, s_prefix;
  __shared__ unsigned s_warp[kPrefixWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_block = take_ticket(lb);
  __syncthreads();
  const unsigned b = s_block;
  const long long t = static_cast<long long>(b) * kPrefixThreads + threadIdx.x;
  const long long r0 = t * kTileRows;
  unsigned n = 0u;  // the tile's wide tags: bool bytes are 0 or 1, so a word's popcount
#pragma unroll
  for (int i = 0; i < kTileRows; i += 16) {
    if (r0 + i + 16 <= c.R) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(c.wide + r0 + i));
      n += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
    } else {
      for (long long r = r0 + i; r < c.R && r < r0 + i + 16; ++r) n += c.wide[r] != 0;
    }
  }
  unsigned incl = n;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const unsigned w = lane < kPrefixWarps ? s_warp[lane] : 0u;
    unsigned wi = w;
#pragma unroll
    for (int off = 1; off < kPrefixWarps; off <<= 1) {
      const unsigned v = __shfl_up_sync(kFull, wi, off);
      if (lane >= off) wi += v;
    }
    const unsigned total = __shfl_sync(kFull, wi, kPrefixWarps - 1);
    if (lane < kPrefixWarps) s_warp[lane] = wi - w;
    const unsigned p = look_back(lb, b, total, lane);
    if (lane == 0) s_prefix = p;
  }
  __syncthreads();
  if (t < n_tiles) prefix[t] = s_prefix + s_warp[warp] + incl - n;
}

// A tile a block.  Adaptive (with a hi plane): `prefix` from
// tile_prefix_kernel, loaded with the tile's first loads; the tile's tags,
// a ballot a warp of 32, rank its wide rows.  A fixed width, or an adaptive
// lane with no hi plane (its chunks all read narrow), passes no prefix.
template <int kWidth, bool kAdaptive>
__global__ void __launch_bounds__(kThreads)
    chunked_decode_kernel(ChunkedLane c, int* __restrict__ out,
                          const unsigned* __restrict__ prefix) {
  __shared__ unsigned s_tags[kTagWords];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row0 = static_cast<long long>(blockIdx.x) * kTileRows;
  RowLoads x[kRowsPerWarp];
  load_tile<kWidth>(c, row0, warp, lane, x);
  unsigned run = 0u;
  if (kAdaptive) {
    run = __ldg(prefix + blockIdx.x);
    if (threadIdx.x < kTileRows) {  // whole warps
      const long long r = row0 + threadIdx.x;
      const unsigned m = __ballot_sync(kFull, r < c.R && c.wide[r] != 0);
      if (lane == 0) s_tags[warp] = m;
    }
    __syncthreads();
  }
  finish_tile<kWidth, kAdaptive>(c, out, row0, x, s_tags, run, warp, lane);
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

int launch_chunked(const ChunkedLane& c, int width, bool adaptive, int* out, void* lookback,
                   unsigned epoch, void* stream) {
  if (c.R <= 0) return static_cast<int>(cudaSuccess);
  if (c.K < 0 || c.K > 32 || c.R > kCountMask) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_tiles = (c.R + kTileRows - 1) / kTileRows;
  const unsigned grid = static_cast<unsigned>(n_tiles);
  if (adaptive && c.H > 0) {
    if (lookback == nullptr || epoch == 0u) return static_cast<int>(cudaErrorInvalidValue);
    const unsigned blocks = static_cast<unsigned>((n_tiles + kPrefixThreads - 1) / kPrefixThreads);
    auto* status = reinterpret_cast<unsigned long long*>(static_cast<char*>(lookback) + 16);
    auto* prefix = reinterpret_cast<unsigned*>(status + blocks);
    const LookBack lb{static_cast<unsigned*>(lookback), status, epoch, blocks};
    tile_prefix_kernel<<<blocks, kPrefixThreads, 0, s>>>(c, lb, prefix, n_tiles);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    chunked_decode_kernel<1, true><<<grid, kThreads, 0, s>>>(c, out, prefix);
  } else if (width == 1 || adaptive) {  // H == 0: every chunk reads narrow
    chunked_decode_kernel<1, false><<<grid, kThreads, 0, s>>>(c, out, nullptr);
  } else if (width == 2) {
    chunked_decode_kernel<2, false><<<grid, kThreads, 0, s>>>(c, out, nullptr);
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
// bytes, base aligned to 4 deltas: a lane loads its 4 as one word);
// ovf_pos, ovf_add int32[R, K], K <= 32; out int32[R, 128], 16-byte
// aligned; R < 2^30.  One launch.
extern "C" int repro_delta_decode_chunked(const int* anchors, const void* deltas, int width,
                                          const int* ovf_pos, const int* ovf_add, int* out,
                                          long long R, int K, void* stream) {
  const ChunkedLane c{anchors, deltas, nullptr, nullptr, ovf_pos, ovf_add, R, K, 0};
  return launch_chunked(c, width, false, out, nullptr, 0u, stream);
}

// Adaptive: the int8 lane, hi int8[H, 128] (4-byte aligned), wide bool[R]
// (16-byte aligned); H == 0 reads every chunk narrow (one launch).
// lookback: 16 + 12 * tiles bytes or more (tiles = ceil(R / rows_per_block)
// of repro_delta_decode_chunked_plan: the ticket counter in the first 16,
// then a uint64 status word per 256 tiles and a uint32 prefix per tile),
// zero when made, 16-byte aligned, used by one stream (the counter is left
// zero by every call); epoch: nonzero and new for each call on that
// buffer.  Two launches: the tile prefixes, then the decode.
extern "C" int repro_delta_decode_chunked_adaptive(const int* anchors, const void* deltas,
                                                   const void* hi, const void* wide, int H,
                                                   const int* ovf_pos, const int* ovf_add,
                                                   int* out, long long R, int K, void* lookback,
                                                   unsigned epoch, void* stream) {
  const ChunkedLane c{anchors, deltas, static_cast<const signed char*>(hi),
                      static_cast<const unsigned char*>(wide), ovf_pos, ovf_add, R, K, H};
  return launch_chunked(c, 1, true, out, lookback, epoch, stream);
}

// The chunked kernels' tile: rows a warp holds, rows a block decodes, rows
// whose tags a block of the adaptive pre-pass counts.
extern "C" int repro_delta_decode_chunked_plan(int* rows_per_warp, int* rows_per_block,
                                               int* rows_per_prefix_block) {
  *rows_per_warp = kRowsPerWarp;
  *rows_per_block = kTileRows;
  *rows_per_prefix_block = kTileRows * kPrefixThreads;
  return 0;
}
