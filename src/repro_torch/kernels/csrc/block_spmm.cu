// Block-dense SpMM for Hopper (sm_90a): the full-graph GCN propagation
// A @ X over dense (R, C) tiles of A, skipping the tiles whose mask is 0.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/csr_spmm.py:47  block_spmm
// which computes, for tile_mask int32 (nr, nc), a_tiles float32
// (nr, nc, R, C) and x float32 (nc*C, D),
//   out[i*R:(i+1)*R] = sum_j [mask[i, j] > 0] * a_tiles[i, j] @ x[j*C:(j+1)*C]
// at Precision.HIGHEST, accumulating over the sequential column-tile axis
// of its grid in VMEM with one (R, C) @ (C, D) MXU product per tile.
//
// The port fixes R = C = 128 (the wrapper rejects other tiles) until it
// has an autotuner to choose them.
//
// Design.  Hopper's blocks run in no order, so the sequential column
// axis becomes a loop inside the block: a block owns the 128 output rows
// of row tile i and a slice of DS output columns (DS = 64, or 16 for
// narrow D), and walks j = 0 .. nc-1 in order.  A tile whose
// mask is 0 is skipped (a block-uniform branch), whatever values it
// holds: the kernel reads the given mask and recomputes nothing.  For
// each live tile it stages 16-column chunks of the A tile (transposed,
// padded against bank conflicts) and the matching 16 rows of the X slice
// in shared memory, and each of the 256 threads accumulates a TM x 4
// micro-tile of the output with float32 FMAs in registers: no tensor
// cores and no TF32, since the reference is exact f32.  The output strip
// is written once; a row of all-masked tiles writes zeros.  Rows of x at
// or past n_x read as zero (the reference pads x to whole tiles), so the
// kernel never reads past the end of x.
//
// Bound: the larger of the float32 FMAs (2 * R * C * D flops per live
// tile, 67 TFLOP/s on an H100 SXM) and the bytes (each live tile, x and
// the output once, 3.35 TB/s).  At GCN's feature width (D = 1433) the
// FMAs bound it; at its hidden width (D = 16) the tile bytes do.  Known
// limit, left for later work: a block walks its whole row of tiles, so
// at D = 16 only nr blocks run (22 at Cora's size).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;    // R = C: output rows per block, columns per tile
constexpr int kKt = 16;       // columns of A (rows of x) staged per step
constexpr int kApad = kTile + 4;  // As row stride: 2-way conflicts at most, float4-aligned

template <int DS>
__global__ void __launch_bounds__(kThreads)
    block_spmm_kernel(const int* __restrict__ mask, const float* __restrict__ tiles,
                      const float* __restrict__ x, float* __restrict__ out, int nc,
                      long long n_x, int D) {
  constexpr int kCg = DS / 4;              // column groups of 4
  constexpr int kRg = kThreads / kCg;      // row groups
  constexpr int kTm = kTile / kRg;         // rows per thread
  __shared__ __align__(16) float As[kKt][kApad];
  __shared__ __align__(16) float Xs[kKt][DS];

  const int tid = threadIdx.x;
  const int tx = tid % kCg;
  const int ty = tid / kCg;
  const int i = blockIdx.x;
  const int d0 = blockIdx.y * DS;

  float acc[kTm][4];
#pragma unroll
  for (int m = 0; m < kTm; ++m) {
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[m][n] = 0.f;
  }

  for (int j = 0; j < nc; ++j) {
    if (__ldg(mask + static_cast<long long>(i) * nc + j) <= 0) continue;  // block-uniform
    const float* tile = tiles + (static_cast<long long>(i) * nc + j) * kTile * kTile;
    for (int kc = 0; kc < kTile; kc += kKt) {
#pragma unroll
      for (int p = 0; p < kTile * kKt / kThreads; ++p) {
        const int e = tid + p * kThreads;
        const int r = e / kKt;
        const int kk = e % kKt;
        As[kk][r] = __ldg(tile + r * kTile + kc + kk);
      }
#pragma unroll
      for (int p = 0; p < (kKt * DS + kThreads - 1) / kThreads; ++p) {
        const int e = tid + p * kThreads;
        if (e < kKt * DS) {
          const int kk = e / DS;
          const int dd = e % DS;
          const long long xr = static_cast<long long>(j) * kTile + kc + kk;
          const int xc = d0 + dd;
          Xs[kk][dd] = (xr < n_x && xc < D) ? __ldg(x + xr * D + xc) : 0.f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kKt; ++kk) {
        float a[kTm];
#pragma unroll
        for (int m = 0; m < kTm; ++m) a[m] = As[kk][ty * kTm + m];
        const float4 b = *reinterpret_cast<const float4*>(&Xs[kk][tx * 4]);
#pragma unroll
        for (int m = 0; m < kTm; ++m) {
          acc[m][0] = fmaf(a[m], b.x, acc[m][0]);
          acc[m][1] = fmaf(a[m], b.y, acc[m][1]);
          acc[m][2] = fmaf(a[m], b.z, acc[m][2]);
          acc[m][3] = fmaf(a[m], b.w, acc[m][3]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int m = 0; m < kTm; ++m) {
    const int row = ty * kTm + m;
    float* o = out + (static_cast<long long>(i) * kTile + row) * D;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int c = d0 + tx * 4 + n;
      if (c < D) o[c] = acc[m][n];
    }
  }
}

template <int DS>
int launch(const int* mask, const float* tiles, const float* x, float* out, int nr, int nc,
           long long n_x, int D, cudaStream_t s) {
  const long long gy = (D + DS - 1) / DS;
  if (gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(nr), static_cast<unsigned>(gy));
  block_spmm_kernel<DS><<<grid, kThreads, 0, s>>>(mask, tiles, x, out, nc, n_x, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes); launches on `stream` and
// returns cudaGetLastError().  mask int32[nr, nc]; tiles float32
// [nr, nc, 128, 128]; x float32[n_x, D] with n_x <= nc * 128 (rows past
// n_x read as zero); out float32[nr * 128, D]; all contiguous.
extern "C" int repro_block_spmm(const int* mask, const float* tiles, const float* x, float* out,
                                int nr, int nc, long long n_x, int D, void* stream) {
  if (nr <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  if (nc < 0 || n_x < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 16) return launch<16>(mask, tiles, x, out, nr, nc, n_x, D, s);
  return launch<64>(mask, tiles, x, out, nr, nc, n_x, D, s);
}
