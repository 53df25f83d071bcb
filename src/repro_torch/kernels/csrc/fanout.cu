// Fixed-fanout masked aggregation for Hopper (sm_90a): the GraphSAGE
// sampled-minibatch reduce.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/segment_reduce.py:522  fanout_aggregate
// which maps gathered neighbour features (B, K, D) and a validity mask
// (B, K) to (B, D), with m the mask as float32:
//   sum:  sum_k f[b, k] * m[b, k]
//   mean: sum_k f[b, k] * m[b, k] / max(sum_k m[b, k], 1)   (the mask's SUM)
//   max:  max_k (m[b, k] > 0 ? f[b, k] : -FLT_MAX), so a bag with no
//         valid entry gives -FLT_MAX (finfo(float32).min), not -inf.
// On the TPU the grid walks blocks of 8 rows and reduces over K in VMEM;
// the reference pads B to a multiple of 8 for it.
//
// Design.  A pure streaming reduction: every feature is read once and
// used once.  A group of `tpr` threads owns one row b; its threads lie
// across D in vectors of V floats (V = 4, one 16-byte load, when D and
// the base pointers allow; else 2 or 1), so a row's K feature rows are
// read as K coalesced sweeps.  Each thread keeps its V accumulators in
// registers through a sequential float32 loop over k (a fixed order: the
// result is deterministic) and stores once.  Rows with few columns pack
// several rows into one 256-thread block; wide rows (D = 602 is 301
// float2 vectors) take one block of up to 256 threads that loops over
// the columns.  Any B: no padding, no copy.
//
// Bound: memory.  The function reads B*K*D*4 feature bytes plus B*K*4
// mask bytes and writes B*D*4, against about 2 flops per feature, so at
// the GraphSAGE shapes (K = 10 or 15) HBM bandwidth (3.35 TB/s on an H100
// SXM) bounds it by two orders of magnitude.
#include <cuda_runtime.h>

#include <cfloat>

namespace {

constexpr int kBlock = 256;

enum Op { kSum = 0, kMean = 1, kMax = 2 };

template <int V>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
};
template <>
struct Vec<2> {
  using T = float2;
};
template <>
struct Vec<1> {
  using T = float;
};

template <int V>
__device__ __forceinline__ void load(const float* p, float (&v)[V]) {
  const typename Vec<V>::T t = __ldg(reinterpret_cast<const typename Vec<V>::T*>(p));
  const float* f = reinterpret_cast<const float*>(&t);
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = f[i];
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  typename Vec<V>::T t;
  float* f = reinterpret_cast<float*>(&t);
#pragma unroll
  for (int i = 0; i < V; ++i) f[i] = v[i];
  *reinterpret_cast<typename Vec<V>::T*>(p) = t;
}

template <int V, int kOp>
__global__ void __launch_bounds__(kBlock)
    fanout_kernel(const float* __restrict__ feats, const float* __restrict__ mask,
                  float* __restrict__ out, long long B, int K, int D, int tpr) {
  const int rows_per_block = blockDim.x / tpr;
  const long long b = static_cast<long long>(blockIdx.x) * rows_per_block + threadIdx.x / tpr;
  if (b >= B) return;
  const int t = threadIdx.x % tpr;
  const int nv = D / V;
  const float* m = mask + b * K;
  const float* f = feats + b * K * D;
  for (int c = t; c < nv; c += tpr) {
    const float init = kOp == kMax ? __int_as_float(static_cast<int>(0xff800000u)) : 0.f;  // -inf
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = init;
    float msum = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float mk = __ldg(m + k);
      float v[V];
      load<V>(f + static_cast<long long>(k) * D + c * V, v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if (kOp == kMax) {
          acc[i] = fmaxf(acc[i], mk > 0.f ? v[i] : -FLT_MAX);
        } else {
          acc[i] += v[i] * mk;
        }
      }
      if (kOp == kMean) msum += mk;
    }
    if (kOp == kMean) {
      const float cnt = fmaxf(msum, 1.f);
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] /= cnt;
    }
    store<V>(out + b * D + c * V, acc);
  }
}

// Threads per row: the row's vectors split into the fewest passes of at
// most kBlock threads, each pass a whole number of warps (or, for rows
// of fewer than 32 vectors, the next power of two).
int threads_per_row(int nv) {
  if (nv < 32) {
    int t = 1;
    while (t < nv) t <<= 1;
    return t;
  }
  const int passes = (nv + kBlock - 1) / kBlock;
  const int per_pass = (nv + passes - 1) / passes;
  return (per_pass + 31) / 32 * 32;
}

template <int V, int kOp>
int launch(const float* feats, const float* mask, float* out, long long B, int K, int D,
           cudaStream_t s) {
  const int tpr = threads_per_row(D / V);
  const int rows_per_block = tpr >= kBlock ? 1 : kBlock / tpr;
  const long long blocks = (B + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  fanout_kernel<V, kOp><<<static_cast<unsigned>(blocks), tpr * rows_per_block, 0, s>>>(
      feats, mask, out, B, K, D, tpr);
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int launch_op(int op, const float* feats, const float* mask, float* out, long long B, int K,
              int D, cudaStream_t s) {
  switch (op) {
    case kSum: return launch<V, kSum>(feats, mask, out, B, K, D, s);
    case kMean: return launch<V, kMean>(feats, mask, out, B, K, D, s);
    case kMax: return launch<V, kMax>(feats, mask, out, B, K, D, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<unsigned long long>(p) % bytes == 0;
}

}  // namespace

// Plain C entry point (bound with ctypes); launches on `stream` and
// returns cudaGetLastError().  feats float32[B, K, D], mask float32[B, K],
// out float32[B, D], all contiguous; op 0 = sum, 1 = mean, 2 = max; K >= 1.
extern "C" int repro_fanout_aggregate(const float* feats, const float* mask, float* out,
                                      long long B, int K, int D, int op, void* stream) {
  if (B <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  if (K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 4 == 0 && aligned(feats, 16) && aligned(out, 16)) {
    return launch_op<4>(op, feats, mask, out, B, K, D, s);
  }
  if (D % 2 == 0 && aligned(feats, 8) && aligned(out, 8)) {
    return launch_op<2>(op, feats, mask, out, B, K, D, s);
  }
  return launch_op<1>(op, feats, mask, out, B, K, D, s);
}
