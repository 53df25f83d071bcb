// Sorted segment sums for Hopper (sm_90a): the edgeMap (+, x) reduce, over
// a raw int32 dst lane or a chunk-compressed one (the section "Chunk-
// compressed dst lane" below), as one edge-parallel pass and a short
// carry fix-up.
//
// Replaces the Pallas TPU kernels
//   repro/kernels/segment_reduce.py:53   segment_sum_sorted
//   repro/kernels/segment_reduce.py:109  segment_sum_weighted_sorted
// which compute out[d, :] = sum_{e: dst[e] == d} [w[e] *] msg[e, :] over
// destination-sorted edges as a one-hot (R, E) @ (E, D) matmul on the MXU.
// That trick exists because random scatter is hostile to the TPU.  On
// Hopper the sorted dst lane already is a segmentation, so this is a
// segmented reduction by key: no one-hot, no float atomics, no tensor
// cores.
//
// Bound: bytes.  The function must read E * (4 + 4 * D) bytes (dst and
// messages; plus 4 * E for the weights) and write n_out * 4 * D bytes,
// against E * D adds, so HBM bandwidth (3.35 TB/s on an H100 SXM) is the
// limit by two orders of magnitude.
//
// Design, against what held the earlier one (a bounds pass, then a group
// of lanes per row) back:
//   * One pass over the edges and no bounds array.  The earlier first pass
//     read dst to write 8 bytes a row that the second read back before its
//     first message load: a chain of dependent loads per row and 16 extra
//     bytes a row.  Here a block of 256 threads takes a tile of kTile
//     consecutive slots (each warp kTile / 8) and issues its loads at once.
//     kTile is a template parameter, 2048, 4096 or 8192 slots, chosen per
//     shape by the wrapper's autotuner (kernels/autotune.py); 4096 is the
//     default.
//   * Edges, not rows, are the unit of work.  At D = 1 a thread owns
//     kTile / 256 consecutive slots (8, 16 or 32) and loads their keys,
//     messages and weights as 16-byte vectors, so a warp's loads are whole
//     lines.  At D > 1 a group of T lanes owns (kTile / 256) T
//     consecutive slots, 4 at a step, each lane 4
//     columns of a message row (1 where D % 4 != 0), so a row is read as
//     whole 16-byte vectors, streamed past L1.  A hub row is cut across
//     groups and tiles like any other: skewed in-degrees leave no lane idle.
//   * A group reduces its slots in order, breaking at key changes; a run
//     that starts and ends inside it is written at once.  Its first and
//     last runs join the neighbours' in a block-wide segmented scan
//     (shuffles, then across the 8 warps through shared memory) whose
//     element is (first key, last key, sum of the last key's run).  Each
//     row that starts and ends inside the tile is written once by it; the
//     tile's first and last runs go to its two carry slots.  The group
//     that owns slot e zeroes the empty rows between key(e - 1) and key(e)
//     when both lie in its tile.
//   * Fix-up, a second launch: a thread per carry (2 a tile, in tile
//     order).  The carry that starts a run of equal keys sums the run in
//     order and writes the row (a hub: its head partial, its whole-tile
//     partials, its tail partial), and carry 2b zeroes the rows between
//     tile b - 1's last key and tile b's first.  (Run instead by the last
//     block to finish, elected by a tile counter, it was slower: PERF.md.)
//   * Bytes: each input is read once and each output written once, plus
//     the carries (16 + 8 D bytes a tile).  Keys clamp to [-1, n_out]:
//     pad and invalid slots (dst < 0 or >= n_out; the engine keys pads n)
//     form runs that are never written.  A tile whose first key is n_out
//     stops after reading it; past that every slot's message is read, so
//     only the tile that holds the last valid key reads pad messages.
//   * Sums are float32 in a fixed order (a group's slots in turn, the
//     scan's fixed tree, the fix-up's run in order): a call gives the same
//     bits every time.  The carries live in a buffer the wrapper keeps
//     per stream.
//
// Known limits, left for later work: the _reduce_msgs gather that builds
// msg (repro/core/traversal/jax_backend.py:379-386) is a separate pass and
// is not fused in here; the empty rows of one gap are zeroed by one thread.
#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "chunk_decode.cuh"

namespace {

using namespace repro_chunk;  // NOLINT: the shared chunk-row decode

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNone = INT_MIN;  // the next group's first key, past the last group

__device__ __forceinline__ int clamp_key(int v, int n_out) { return min(max(v, -1), n_out); }

// A tile of kTile slots (segment_reduce.py's TILES): each warp's own
// slots, and the slots a thread owns at D = 1.
template <int kTile>
struct Tiling {
  static_assert(kTile % (kWarps * 32 * 4) == 0, "a thread's run is whole 16-byte vectors");
  static constexpr int kWarpSlots = kTile / kWarps;
  static constexpr int kRun = kWarpSlots / 32;
};

// Shared index of tile slot i: a spare word every 32 keeps the 8-, 16- or
// 32-slot rows that the threads of a warp read at once on distinct banks.
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

template <int V>
__device__ __forceinline__ void store(float* p, const float (&s)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(s[0], s[1], s[2], s[3]);
  } else {
    p[0] = s[0];
  }
}

// ---------------------------------------------------------------------------
// The segmented scan
// ---------------------------------------------------------------------------

// A stretch of slots: its first and last key and the sum of its last key's
// run inside it (a lane's V columns).  Keys ascend, so first == last means
// the stretch holds one key.
template <int V>
struct Part {
  int first, last;
  float s[V];
};

// b = a then b: b's last run reaches into a when b holds one key, a's last.
template <int V>
__device__ __forceinline__ void join(const Part<V>& a, Part<V>& b) {
  if (b.first == b.last && b.first == a.last) {
#pragma unroll
    for (int i = 0; i < V; ++i) b.s[i] = a.s[i] + b.s[i];
  }
  b.first = a.first;
}

template <int V>
__device__ __forceinline__ Part<V> shfl_up(const Part<V>& p, int off) {
  Part<V> q;
  q.first = __shfl_up_sync(kFull, p.first, off);
  q.last = __shfl_up_sync(kFull, p.last, off);
#pragma unroll
  for (int i = 0; i < V; ++i) q.s[i] = __shfl_up_sync(kFull, p.s[i], off);
  return q;
}

template <int V>
struct ScanSmem {
  int first[kWarps], last[kWarps];
  float s[kWarps][32][V];  // [warp][column lane][column]
};

// Exclusive scan of the groups' parts in slot order over the block, T
// lanes a group (lane % T is the column lane).  Returns whether
// the group has a predecessor (p is then all of them joined); `next` gets
// the next group's first key (kNone for the last group).  sm.first[0] is
// the block's first key on return.
template <int V>
__device__ bool block_scan(const Part<V>& x, int T, ScanSmem<V>& sm, Part<V>& p, int& next) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = lane & (T - 1);
  Part<V> inc = x;
  for (int off = T; off < 32; off <<= 1) {
    const Part<V> y = shfl_up(inc, off);
    if (lane >= off) join(y, inc);
  }
  Part<V> ex = shfl_up(inc, T);
  next = __shfl_down_sync(kFull, x.first, T);
  if (lane >= 32 - T) {  // the warp's last group: the warp's total
    if (c == 0) {
      sm.first[warp] = inc.first;
      sm.last[warp] = inc.last;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) sm.s[warp][c][i] = inc.s[i];
  }
  __syncthreads();
  if (lane >= 32 - T) next = warp + 1 < kWarps ? sm.first[warp + 1] : kNone;
  const bool has = warp > 0;
  if (has) {
    p.first = sm.first[0];
    p.last = sm.last[0];
#pragma unroll
    for (int i = 0; i < V; ++i) p.s[i] = sm.s[0][c][i];
    for (int w = 1; w < warp; ++w) {
      Part<V> q;
      q.first = sm.first[w];
      q.last = sm.last[w];
#pragma unroll
      for (int i = 0; i < V; ++i) q.s[i] = sm.s[w][c][i];
      join(p, q);
      p = q;
    }
  }
  if (lane >= T) {
    if (has) join(p, ex);
    p = ex;
    return true;
  }
  return has;
}

// ---------------------------------------------------------------------------
// A group's runs and where they go
// ---------------------------------------------------------------------------

// Where finished runs go: rows of out (a lane's V columns from col), or the
// tile's two carry slots.  `lead` writes the carry keys.
template <int V>
struct Sink {
  float* out;
  int D, n_out, col;
  bool active, lead;
  int* ckey;
  float* cval;
  long long slot;  // the tile's first carry slot, 2 * tile

  __device__ void row(int key, const float (&s)[V]) const {
    if (active && key >= 0 && key < n_out) store(out + static_cast<long long>(key) * D + col, s);
  }
  // rows lo + 1 .. hi - 1 (keys clamped, so all in [0, n_out))
  __device__ void zeros(int lo, int hi) const {
    if (!active) return;
    const float z[V] = {};
    for (int r = lo + 1; r < hi; ++r) store(out + static_cast<long long>(r) * D + col, z);
  }
  __device__ void carry(int k, int key, const float (&s)[V]) const {
    if (lead) ckey[slot + k] = key;
    if (active) store(cval + (slot + k) * D + col, s);
  }
};

// A group's slots in order: writes each run that starts and ends inside
// it, keeps its first run (head) and its last (acc), and zeroes the rows
// between consecutive keys.
template <int V>
struct Runs {
  int first, cur;
  bool split;  // a key change was seen
  float head[V], acc[V];

  __device__ void start(int k, const float (&x)[V]) {
    first = cur = k;
    split = false;
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = x[i];
  }
  __device__ void step(int k, const float (&x)[V], const Sink<V>& o) {
    if (k != cur) {
      if (split) {
        o.row(cur, acc);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) head[i] = acc[i];
        split = true;
      }
      o.zeros(cur, k);
      cur = k;
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = x[i];
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] += x[i];
    }
  }
  __device__ Part<V> part() const {
    Part<V> p;
    p.first = first;
    p.last = cur;
#pragma unroll
    for (int i = 0; i < V; ++i) p.s[i] = acc[i];
    return p;
  }
};

// Once the scan is in: the group's first run gets its predecessors' share
// and, like its last run, is written where it ends in the group, except
// the tile's first and last runs, which go to the carry slots.  The rows
// between the previous group's last key and the group's first are zeroed.
template <int V>
__device__ void finish(const Runs<V>& r, bool has_p, const Part<V>& p, int next, bool last_group,
                       int tile_first, const Sink<V>& o) {
  const Part<V> x = r.part();
  const bool cont = has_p && p.last == x.first;
  float h[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    h[i] = r.split ? r.head[i] : r.acc[i];
    if (cont) h[i] = p.s[i] + h[i];
  }
  if (has_p) o.zeros(p.last, x.first);
  const bool tile_head = x.first == tile_first;
  if (x.first != x.last) {
    if (tile_head) {
      o.carry(0, x.first, h);
    } else {
      o.row(x.first, h);
    }
    if (last_group) {
      o.carry(1, x.last, x.s);
    } else if (next != x.last) {
      o.row(x.last, x.s);
    }
  } else if (last_group) {
    if (tile_head) {
      const float z[V] = {};
      o.carry(0, x.first, h);
      o.carry(1, x.first, z);
    } else {
      o.carry(1, x.first, h);
    }
  } else if (next != x.first) {
    if (tile_head) {
      o.carry(0, x.first, h);
    } else {
      o.row(x.first, h);
    }
  }
}

// ---------------------------------------------------------------------------
// Key sources: the raw lane, a chunk-compressed one
// ---------------------------------------------------------------------------

struct RawKeys {
  const int* dst;
  long long E;
  struct Shared {
    int unused;
  };

  __device__ void prepare(int, Shared&) const {}
  __device__ int first_key(long long tile0, int n_out, const Shared&) const {
    return clamp_key(__ldg(dst + tile0), n_out);
  }
  __device__ int key(long long e, int n_out) const {
    return e < E ? clamp_key(__ldg(dst + e), n_out) : n_out;
  }
  // The keys of slots e .. e + N - 1 (tile slot i); `vec`: dst is aligned.
  template <int N>
  __device__ void keys(long long e, int, int n_out, bool vec, int (&k)[N], const Shared&) const {
    if (vec && e + N <= E) {
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const int4 t = __ldg(reinterpret_cast<const int4*>(dst + e) + q);
        k[4 * q] = clamp_key(t.x, n_out);
        k[4 * q + 1] = clamp_key(t.y, n_out);
        k[4 * q + 2] = clamp_key(t.z, n_out);
        k[4 * q + 3] = clamp_key(t.w, n_out);
      }
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) k[j] = key(e + j, n_out);
    }
  }
  bool aligned() const { return reinterpret_cast<uintptr_t>(dst) % 16 == 0; }
};

// ---------------------------------------------------------------------------
// Chunk-compressed dst lane
// ---------------------------------------------------------------------------
//
// Replaces the Pallas TPU kernels
//   repro/kernels/segment_reduce.py:229  segment_sum_sorted_chunked
//   repro/kernels/segment_reduce.py:271  segment_sum_weighted_chunked
//   repro/kernels/segment_reduce.py:410  segment_sum_sorted_chunked_adaptive
//   repro/kernels/segment_reduce.py:454  segment_sum_weighted_chunked_adaptive
// the same sums with dst stored as 128-slot chunks (repro_torch/core/
// compressed.py): anchor int32, int8 or int16 deltas, up to K escapes
// (ovf_pos, ovf_add; pos == 128 marks an unused slot); the adaptive layout
// has one int8 lane, a per-chunk wide tag and a compacted hi-byte plane.
// The TPU kernels decode each tile in the prologue and feed the one-hot
// MXU product.  Here only the key source changes: each warp decodes its
// kTile / 1024 chunk rows (2, 4 or 8) with chunk_decode.cuh's decode_row
// (4 slots a lane, the same text as the standalone decode in
// delta_decode.cu) into shared memory (33.8 KB of keys at 8192 slots,
// still static), and the pass reads its keys there.  Decoded ids never
// reach HBM; a row that crosses a chunk or a tile edge is one more run for
// the scan or the fix-up, so no warp reads another row's first id.
// Contract: the decoded ids are ascending (the engine's dst_sorted lane
// is); pad slots decode to n_out or more and are dropped.  Integer decode
// arithmetic wraps in 32 bits, as the reference's int32 cumsum does.
//
// Bound: bytes.  Against the raw kernel the dst read shrinks from 4 bytes
// a slot to the stream's bytes (about 1.5 a slot for int8 chunks with their
// escape table, 2.5 for int16); messages and output are unchanged.

template <int kWidth, bool kAdaptive, int kTile>
struct ChunkKeys {
  ChunkedLane c;
  const int* hi_row;  // adaptive: int32[R], the wrapper's hi-plane row of each chunk
  static constexpr int kWarpSlots = Tiling<kTile>::kWarpSlots;
  struct Shared {
    int keys[kTile + kTile / 32];
  };

  // The tile's kTile / 128 chunk rows, kTile / 1024 a warp, decoded into
  // shared memory.
  __device__ void prepare(int n_out, Shared& sh) const {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int q = 0; q < kWarpSlots / kChunk; ++q) {
      const int i = warp * kWarpSlots + q * kChunk;  // tile slot of the row's column 0
      const long long r = static_cast<long long>(blockIdx.x) * (kTile / kChunk) + i / kChunk;
      int v[kSlotsPerLane];
      if (r < c.R) {  // warp-uniform: decode_row shuffles
        int hrow = -1;  // narrow
        if (kAdaptive && c.H > 0) {
          const int h = __ldg(hi_row + r);  // issued beside the tag, not after it
          if (c.wide[r] != 0) hrow = h;
        }
        decode_row<kWidth, kAdaptive>(c, r, lane, hrow, v);
#pragma unroll
        for (int j = 0; j < kSlotsPerLane; ++j) v[j] = clamp_key(v[j], n_out);
      } else {
#pragma unroll
        for (int j = 0; j < kSlotsPerLane; ++j) v[j] = n_out;
      }
#pragma unroll
      for (int j = 0; j < kSlotsPerLane; ++j) sh.keys[pad(i + lane * kSlotsPerLane + j)] = v[j];
    }
    __syncthreads();
  }
  __device__ int first_key(long long, int, const Shared& sh) const { return sh.keys[0]; }
  template <int N>
  __device__ void keys(long long, int i, int, bool, int (&k)[N], const Shared& sh) const {
#pragma unroll
    for (int j = 0; j < N; ++j) k[j] = sh.keys[pad(i + j)];
  }
  bool aligned() const { return true; }
};

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------

// 4 floats from p + e (16-byte aligned when vec), zero past E.
__device__ __forceinline__ float4 load4(const float* p, long long e, long long E, bool vec) {
  if (vec && e + 4 <= E) return __ldg(reinterpret_cast<const float4*>(p + e));
  return make_float4(e < E ? __ldg(p + e) : 0.f, e + 1 < E ? __ldg(p + e + 1) : 0.f,
                     e + 2 < E ? __ldg(p + e + 2) : 0.f, e + 3 < E ? __ldg(p + e + 3) : 0.f);
}

// The tile is all pads: its carries say so, their values are never read.
__device__ __forceinline__ void pad_tile(int* ckey, int n_out) {
  if (threadIdx.x == 0) ckey[2 * blockIdx.x] = ckey[2 * blockIdx.x + 1] = n_out;
}

// D = 1: a thread's kRun slots as vectors, a group per thread.  `vec`:
// dst, msg and w are 16-byte aligned.  Past the pad-tile exit every slot's
// message is read (only the tile that holds the last valid key reads pad
// messages), so the loads wait on no key.
template <bool kWeighted, int kTile, class Keys>
__global__ void __launch_bounds__(kThreads)
    tile_d1_kernel(Keys keys, const float* __restrict__ w, const float* __restrict__ msg,
                   float* __restrict__ out, int* __restrict__ ckey, float* __restrict__ cval,
                   long long E, int n_out, bool vec) {
  constexpr int kWarpSlots = Tiling<kTile>::kWarpSlots;
  constexpr int kRun = Tiling<kTile>::kRun;
  __shared__ typename Keys::Shared ksm;
  __shared__ ScanSmem<1> sm;
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTile;
  const int i0 = (threadIdx.x >> 5) * kWarpSlots + (threadIdx.x & 31) * kRun;
  const long long e0 = tile0 + i0;
  keys.prepare(n_out, ksm);
  if (keys.first_key(tile0, n_out, ksm) >= n_out) return pad_tile(ckey, n_out);
  int k[kRun];
  keys.keys(e0, i0, n_out, vec, k, ksm);
  float4 m[kRun / 4], ww[kRun / 4];
#pragma unroll
  for (int q = 0; q < kRun / 4; ++q) {
    m[q] = load4(msg, e0 + 4 * q, E, vec);
    if (kWeighted) ww[q] = load4(w, e0 + 4 * q, E, vec);
  }
  float v[kRun][1];
#pragma unroll
  for (int q = 0; q < kRun / 4; ++q) {
    v[4 * q][0] = kWeighted ? m[q].x * ww[q].x : m[q].x;
    v[4 * q + 1][0] = kWeighted ? m[q].y * ww[q].y : m[q].y;
    v[4 * q + 2][0] = kWeighted ? m[q].z * ww[q].z : m[q].z;
    v[4 * q + 3][0] = kWeighted ? m[q].w * ww[q].w : m[q].w;
  }
  const Sink<1> o{out, 1, n_out, 0, true, true, ckey, cval, 2LL * blockIdx.x};
  Runs<1> r;
  r.start(k[0], v[0]);
#pragma unroll
  for (int j = 1; j < kRun; ++j) r.step(k[j], v[j], o);
  Part<1> p;
  int next;
  const bool has_p = block_scan<1>(r.part(), 1, sm, p, next);
  finish<1>(r, has_p, p, next, threadIdx.x == kThreads - 1, sm.first[0], o);
}

// D > 1: groups of T lanes over columns (V = 4: float4 columns), 4 slots a
// step: their keys, weights and message rows (streamed past L1: each is
// read once) in flight together.
template <bool kWeighted, int V, int kTile, class Keys>
__global__ void __launch_bounds__(kThreads)
    tile_cols_kernel(Keys keys, const float* __restrict__ w, const float* __restrict__ msg,
                     float* __restrict__ out, int* __restrict__ ckey, float* __restrict__ cval,
                     long long E, int D, int n_out, int T, bool vec) {
  __shared__ typename Keys::Shared ksm;
  __shared__ ScanSmem<V> sm;
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTile;
  keys.prepare(n_out, ksm);
  if (keys.first_key(tile0, n_out, ksm) >= n_out) return pad_tile(ckey, n_out);
  const int g = threadIdx.x / T;
  const int L = kTile * T / kThreads;  // slots a group
  const int i0 = g * L;
  Sink<V> o{out, D, n_out, 0, false, false, ckey, cval, 2LL * blockIdx.x};
  for (int cb = 0; cb < D; cb += T * V) {
    o.col = cb + (threadIdx.x & (T - 1)) * V;
    o.active = o.col < D;
    o.lead = o.col == 0;
    Runs<V> r;
    for (int j0 = 0; j0 < L; j0 += 4) {
      const long long e = tile0 + i0 + j0;
      int k[4];
      keys.keys(e, i0 + j0, n_out, vec, k, ksm);
      const float4 s = kWeighted ? load4(w, e, E, vec) : make_float4(1.f, 1.f, 1.f, 1.f);
      const float sc[4] = {s.x, s.y, s.z, s.w};
      float x[4][V];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* mp = msg + (e + u) * D + o.col;
        if (o.active && e + u < E) {
          if constexpr (V == 4) {
            const float4 t = __ldcs(reinterpret_cast<const float4*>(mp));
            x[u][0] = t.x;
            x[u][1] = t.y;
            x[u][2] = t.z;
            x[u][3] = t.w;
          } else {
            x[u][0] = __ldcs(mp);
          }
        } else {
#pragma unroll
          for (int c = 0; c < V; ++c) x[u][c] = 0.f;
        }
        if (kWeighted) {
#pragma unroll
          for (int c = 0; c < V; ++c) x[u][c] *= sc[u];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (j0 + u == 0) {
          r.start(k[u], x[u]);
        } else {
          r.step(k[u], x[u], o);
        }
      }
    }
    Part<V> p;
    int next;
    const bool has_p = block_scan<V>(r.part(), T, sm, p, next);
    finish<V>(r, has_p, p, next, g == kThreads / T - 1, sm.first[0], o);
    __syncthreads();  // sm is reused by the next column block
  }
}

// The fix-up: a thread per carry i (2 a tile, in tile order; N of them)
// and column lane (T lanes of V columns).  The carry that starts a run of
// equal keys sums the run in order and writes its row: a hub row gets its
// head partial, its whole-tile partials and its tail partial.  Carry 2b
// zeroes the rows between tile b - 1's last key and tile b's first (carry
// 0 those before the first key; the virtual carry N, keyed n_out, those
// after the last).
template <int V>
__global__ void __launch_bounds__(kThreads)
    fixup_kernel(const int* __restrict__ ckey, const float* __restrict__ cval,
                 float* __restrict__ out, int N, int D, int n_out, int T) {
  const long long i = static_cast<long long>(blockIdx.x) * (kThreads / T) + threadIdx.x / T;
  if (i > N) return;
  const int k = i < N ? __ldg(ckey + i) : n_out;
  const int kp = i > 0 ? __ldg(ckey + i - 1) : -1;
  const bool starts = i < N && k >= 0 && k < n_out && (i == 0 || kp != k);
  Sink<V> o{out, D, n_out, 0, true, false, nullptr, nullptr, 0};
  for (o.col = (threadIdx.x & (T - 1)) * V; o.col < D; o.col += T * V) {
    if (i % 2 == 0) o.zeros(kp, k);
    if (!starts) continue;
    float acc[V];
    const float* vp = cval + i * D + o.col;
    if constexpr (V == 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(vp));
      acc[0] = t.x;
      acc[1] = t.y;
      acc[2] = t.z;
      acc[3] = t.w;
    } else {
      acc[0] = __ldg(vp);
    }
    for (long long j = i + 1; j < N && __ldg(ckey + j) == k; ++j) {
      vp += D;
      if constexpr (V == 4) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(vp));
        acc[0] += t.x;
        acc[1] += t.y;
        acc[2] += t.z;
        acc[3] += t.w;
      } else {
        acc[0] += __ldg(vp);
      }
    }
    o.row(k, acc);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Column lanes a group: enough for D columns V at a time, a power of two,
// at most a warp.
int group_lanes(int D, int V) {
  int t = 1;
  while (t * V < D && t < 32) t <<= 1;
  return t;
}

// Carry keys at the scratch's start, values from the next 16-byte bound;
// segment_reduce.py's _scratch sizes the buffer the same way (2 carries a
// tile of kTile slots).
template <bool kWeighted, int kTile, class Keys>
int launch(const Keys& keys, const float* w, const float* msg, float* out, void* scratch,
           long long E, int D, int n_out, void* stream) {
  if (n_out <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = (E + kTile - 1) / kTile;
  int* ckey = static_cast<int*>(scratch);
  float* cval = reinterpret_cast<float*>(static_cast<char*>(scratch) + (8 * tiles + 15) / 16 * 16);
  const bool vec = keys.aligned() && (!kWeighted || aligned16(w)) && (D > 1 || aligned16(msg));
  const int V = D > 1 && D % 4 == 0 && aligned16(msg) && aligned16(out) && aligned16(scratch)
                    ? 4 : 1;
  const int T = group_lanes(D, V);
  if (tiles > 0) {
    const unsigned grid = static_cast<unsigned>(tiles);
    if (D == 1) {
      tile_d1_kernel<kWeighted, kTile, Keys>
          <<<grid, kThreads, 0, s>>>(keys, w, msg, out, ckey, cval, E, n_out, vec);
    } else if (V == 4) {
      tile_cols_kernel<kWeighted, 4, kTile, Keys>
          <<<grid, kThreads, 0, s>>>(keys, w, msg, out, ckey, cval, E, D, n_out, T, vec);
    } else {
      tile_cols_kernel<kWeighted, 1, kTile, Keys>
          <<<grid, kThreads, 0, s>>>(keys, w, msg, out, ckey, cval, E, D, n_out, T, vec);
    }
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  const int N = static_cast<int>(2 * tiles);
  const unsigned fix_grid = static_cast<unsigned>((N + 1 + kThreads / T - 1) / (kThreads / T));
  if (V == 4) {
    fixup_kernel<4><<<fix_grid, kThreads, 0, s>>>(ckey, cval, out, N, D, n_out, T);
  } else {
    fixup_kernel<1><<<fix_grid, kThreads, 0, s>>>(ckey, cval, out, N, D, n_out, T);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kWeighted, int kTile>
int launch_chunked(const ChunkedLane& c, const int* hi_row, int width, bool adaptive,
                   const float* w, const float* msg, float* out, void* scratch, int D, int n_out,
                   void* stream) {
  if (c.R <= 0 || c.K < 0 || c.K > 32) return static_cast<int>(cudaErrorInvalidValue);
  const long long E = c.R * kChunk;
  if (adaptive) {
    return launch<kWeighted, kTile>(ChunkKeys<1, true, kTile>{c, hi_row}, w, msg, out, scratch,
                                    E, D, n_out, stream);
  }
  if (width == 1) {
    return launch<kWeighted, kTile>(ChunkKeys<1, false, kTile>{c, nullptr}, w, msg, out,
                                    scratch, E, D, n_out, stream);
  }
  if (width == 2) {
    return launch<kWeighted, kTile>(ChunkKeys<2, false, kTile>{c, nullptr}, w, msg, out,
                                    scratch, E, D, n_out, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// f(std::integral_constant<int, tile>) for the three tiles the kernels are
// built for; any other tile is cudaErrorInvalidValue.
template <class F>
int with_tile(int tile, F&& f) {
  switch (tile) {
    case 2048:
      return f(std::integral_constant<int, 2048>{});
    case 4096:
      return f(std::integral_constant<int, 4096>{});
    case 8192:
      return f(std::integral_constant<int, 8192>{});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points (bound with ctypes).  dst: int32[E] ascending;
// w: float32[E]; msg: float32[E, D] row-major; out: float32[n_out, D],
// every row written; tile: slots a block, 2048, 4096 or 8192 (any other
// is cudaErrorInvalidValue); scratch: the carries, at least
// round16(8 * tiles) + 8 * tiles * D bytes with tiles = ceil(E / tile),
// 16-byte aligned.  Two launches (the pass, the fix-up) on `stream`;
// returns cudaGetLastError().
extern "C" int repro_segment_sum_sorted(const int* dst, const float* msg, float* out,
                                        void* scratch, long long E, int D, int n_out, int tile,
                                        void* stream) {
  return with_tile(tile, [&](auto t) {
    return launch<false, decltype(t)::value>(RawKeys{dst, E}, nullptr, msg, out, scratch, E, D,
                                             n_out, stream);
  });
}

extern "C" int repro_segment_sum_weighted_sorted(const int* dst, const float* w,
                                                 const float* msg, float* out, void* scratch,
                                                 long long E, int D, int n_out, int tile,
                                                 void* stream) {
  return with_tile(tile, [&](auto t) {
    return launch<true, decltype(t)::value>(RawKeys{dst, E}, w, msg, out, scratch, E, D, n_out,
                                            stream);
  });
}

// Chunked entry points.  anchors: int32[R]; deltas: int8 or int16 [R, 128]
// (`width` bytes, base aligned to 4 deltas: decode_row loads a lane's 4 as
// one word; hi 4-byte aligned); ovf_pos, ovf_add: int32[R, K], K <= 32; w: float32[R *
// 128]; msg: float32[R * 128, D]; out, scratch as above with E = R * 128.
// The adaptive ones take the int8 lane, hi: int8[H, 128], wide: bool[R]
// and hi_row: int32[R] (cumsum(wide) - 1 clamped to [0, H)); H == 0 reads
// every chunk narrow.
extern "C" int repro_segment_sum_sorted_chunked(const int* anchors, const void* deltas, int width,
                                                const int* ovf_pos, const int* ovf_add,
                                                const float* msg, float* out, void* scratch,
                                                long long R, int K, int D, int n_out, int tile,
                                                void* stream) {
  const ChunkedLane c{anchors, deltas, nullptr, nullptr, ovf_pos, ovf_add, R, K, 0};
  return with_tile(tile, [&](auto t) {
    return launch_chunked<false, decltype(t)::value>(c, nullptr, width, false, nullptr, msg, out,
                                                     scratch, D, n_out, stream);
  });
}

extern "C" int repro_segment_sum_weighted_chunked(const int* anchors, const void* deltas,
                                                  int width, const int* ovf_pos,
                                                  const int* ovf_add, const float* w,
                                                  const float* msg, float* out, void* scratch,
                                                  long long R, int K, int D, int n_out, int tile,
                                                  void* stream) {
  const ChunkedLane c{anchors, deltas, nullptr, nullptr, ovf_pos, ovf_add, R, K, 0};
  return with_tile(tile, [&](auto t) {
    return launch_chunked<true, decltype(t)::value>(c, nullptr, width, false, w, msg, out,
                                                    scratch, D, n_out, stream);
  });
}

extern "C" int repro_segment_sum_sorted_chunked_adaptive(
    const int* anchors, const void* deltas, const void* hi, const void* wide, const int* hi_row,
    int H, const int* ovf_pos, const int* ovf_add, const float* msg, float* out, void* scratch,
    long long R, int K, int D, int n_out, int tile, void* stream) {
  const ChunkedLane c{anchors, deltas, static_cast<const signed char*>(hi),
                      static_cast<const unsigned char*>(wide), ovf_pos, ovf_add, R, K, H};
  return with_tile(tile, [&](auto t) {
    return launch_chunked<false, decltype(t)::value>(c, hi_row, 1, true, nullptr, msg, out,
                                                     scratch, D, n_out, stream);
  });
}

extern "C" int repro_segment_sum_weighted_chunked_adaptive(
    const int* anchors, const void* deltas, const void* hi, const void* wide, const int* hi_row,
    int H, const int* ovf_pos, const int* ovf_add, const float* w, const float* msg, float* out,
    void* scratch, long long R, int K, int D, int n_out, int tile, void* stream) {
  const ChunkedLane c{anchors, deltas, static_cast<const signed char*>(hi),
                      static_cast<const unsigned char*>(wide), ovf_pos, ovf_add, R, K, H};
  return with_tile(tile, [&](auto t) {
    return launch_chunked<true, decltype(t)::value>(c, hi_row, 1, true, w, msg, out, scratch, D,
                                                    n_out, stream);
  });
}
