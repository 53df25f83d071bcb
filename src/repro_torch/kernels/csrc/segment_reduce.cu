// Sorted segment sums for Hopper (sm_90a): the edgeMap (+, x) reduce.
//
// Replaces the Pallas TPU kernels
//   repro/kernels/segment_reduce.py:53   segment_sum_sorted
//   repro/kernels/segment_reduce.py:109  segment_sum_weighted_sorted
// which compute out[d, :] = sum_{e: dst[e] == d} [w[e] *] msg[e, :] over
// destination-sorted edges as a one-hot (R, E) @ (E, D) matmul on the MXU.
// That trick exists because random scatter is hostile to the TPU.  On
// Hopper the sorted dst lane already is a CSR segmentation, so this is a
// row-segmented reduction instead: no one-hot, no atomics, no tensor cores.
//
// Design.
//   * Pass 1 (segment_bounds_kernel), edge-parallel: the thread of edge e
//     writes bounds[r] = e for every row r in (key(e-1), key(e)], where
//     key clamps dst to [-1, n_out].  For sorted dst the ranges tile
//     [0, n_out], so bounds[r] = #edges with dst < r with no search and no
//     dependent loads.  Rows at or past n_out are never visited, so pad
//     and invalid edges (keyed n by the engine) are dropped.  (The first
//     design searched per row instead; PERF.md has the two measured.)
//   * Pass 2 (segment_sum_kernel): a group of S lanes (S a power of two,
//     at most 32) reduces one row, so a warp holds 32 / S rows at once.
//     The group is split into G = S / T edge slots times T column lanes,
//     T = min(S, pow2(D)): D = 1 (pagerank) strides the group over the
//     row's edges, D = 8 or 64 (pagerank_multi lanes) puts lanes over
//     columns so every load of a message row is coalesced.  A butterfly of
//     shuffles over the G edge slots finishes the row, which is written
//     once.  S comes from the average work per row (E * D / n_out): with
//     rows of ~16 edges, a full warp per row left each warp one short chain
//     of dependent loads (bounds -> messages -> shuffles -> store), and the
//     card latency-bound; small groups put many rows in flight per warp.
//   * Accumulation is float32 in registers, with a fixed order per row:
//     the result is deterministic run to run.
//
// Bound: memory traffic.  The function must read E * (4 + 4 * D) bytes
// (dst and messages; plus 4 * E for the weights) and write n_out * 4 * D
// bytes, against E * D adds, so HBM bandwidth (3.35 TB/s on an H100 SXM)
// is the limit by two orders of magnitude.  The bounds pass adds a write
// and a read of 8 * (n_out + 1) bytes.
//
// Known limits, left for later work: a group never splits a hub row
// across warps (rMAT in-degree is skewed; its rows run long while the
// rest of the warp idles); the _reduce_msgs gather that builds msg
// (repro/core/traversal/jax_backend.py:379-386) is a separate pass and is
// not fused in here; the group size is a fixed rule, not autotuned.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
    segment_bounds_kernel(const int* __restrict__ dst, long long E, int n_out,
                          long long* __restrict__ bounds) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e > E) return;
  const int lo = e == 0 ? -1 : min(max(__ldg(dst + e - 1), -1), n_out);
  const int hi = e == E ? n_out : min(max(__ldg(dst + e), -1), n_out);
  for (int r = lo + 1; r <= hi; ++r) bounds[r] = e;
}

template <bool kWeighted>
__global__ void __launch_bounds__(kThreads)
    segment_sum_kernel(const long long* __restrict__ bounds, const float* __restrict__ w,
                       const float* __restrict__ msg, float* __restrict__ out,
                       int D, int n_out, int S, int T) {
  const int lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * (32 / S);
  if (row0 >= n_out) return;  // warp-uniform
  const int row = row0 + lane / S;
  const bool live = row < n_out;  // lanes past n_out still join the shuffles
  const int sub = lane % S;
  const int G = S / T;  // edge slots per row
  const int c0 = sub % T;
  const int g = sub / T;
  const long long lo = live ? __ldg(bounds + row) : 0;
  const long long hi = live ? __ldg(bounds + row + 1) : 0;
  for (int cb = 0; cb < D; cb += T) {
    const int c = cb + c0;
    float acc = 0.f;
    if (c < D) {
#pragma unroll 4
      for (long long e = lo + g; e < hi; e += G) {
        float v = __ldg(msg + e * D + c);
        if (kWeighted) v *= __ldg(w + e);
        acc += v;
      }
    }
    for (int off = T; off < S; off <<= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (live && g == 0 && c < D) out[static_cast<long long>(row) * D + c] = acc;
  }
}

int pow2_at_least(long long x) {
  int t = 1;
  while (t < x && t < 32) t <<= 1;
  return t;
}

// Lanes per row: about four edges per lane at the average row length,
// never fewer lanes than the row's columns need (T), never more than 32.
int group_lanes(long long E, int D, int n_out) {
  const int T = pow2_at_least(D);
  const long long per_row = (E + n_out - 1) / n_out;
  const int G = pow2_at_least((per_row + 3) / 4);
  return T * G < 32 ? T * G : 32;
}

template <bool kWeighted>
int launch(const int* dst, const float* w, const float* msg, float* out, long long* bounds,
           long long E, int D, int n_out, void* stream) {
  if (n_out <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  const int S = group_lanes(E, D, n_out);
  const int T = pow2_at_least(D) < S ? pow2_at_least(D) : S;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned edge_blocks = static_cast<unsigned>((E + 1 + kThreads - 1) / kThreads);
  segment_bounds_kernel<<<edge_blocks, kThreads, 0, s>>>(dst, E, n_out, bounds);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const long long rows_per_block = static_cast<long long>(kWarps) * (32 / S);
  const unsigned row_blocks = static_cast<unsigned>((n_out + rows_per_block - 1) / rows_per_block);
  segment_sum_kernel<kWeighted><<<row_blocks, kThreads, 0, s>>>(bounds, w, msg, out, D, n_out, S, T);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes).  dst: int32[E] ascending;
// w: float32[E]; msg: float32[E, D] row-major; out: float32[n_out, D],
// every row written; bounds: int64[n_out + 1] scratch.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int repro_segment_sum_sorted(const int* dst, const float* msg, float* out,
                                        long long* bounds, long long E, int D, int n_out,
                                        void* stream) {
  return launch<false>(dst, nullptr, msg, out, bounds, E, D, n_out, stream);
}

extern "C" int repro_segment_sum_weighted_sorted(const int* dst, const float* w,
                                                 const float* msg, float* out,
                                                 long long* bounds, long long E, int D,
                                                 int n_out, void* stream) {
  return launch<true>(dst, w, msg, out, bounds, E, D, n_out, stream);
}
