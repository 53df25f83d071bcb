// Block SpMM for Hopper (sm_90a): the full-graph GCN propagation A @ X
// over dense (R, C) tiles of A, computed on the live tiles' nonzeros.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/csr_spmm.py:47  block_spmm
// which computes, for tile_mask int32 (nr, nc), a_tiles float32
// (nr, nc, R, C) and x float32 (nc*C, D),
//   out[i*R:(i+1)*R] = sum_j [mask[i, j] > 0] * a_tiles[i, j] @ x[j*C:(j+1)*C]
// at Precision.HIGHEST, accumulating over the sequential column-tile axis
// of its grid in VMEM with one (R, C) @ (C, D) MXU product per tile.
//
// The tile R = C is a template parameter, 128 or 256 (the reference's
// autotuner grid), chosen per shape by the wrapper's autotuner
// (kernels/autotune.py); 128 is the default.
//
// Bound: bytes.  A graph's tiles are almost all zeros (gcn-cora: 10,562
// nonzeros in 428 live tiles of 16,384 entries, 0.15%), so the work the
// function needs is 2 * nnz * D flops, and the least time is the bytes:
// the live tiles, the mask, x and the output once over HBM (59.7 MB at
// D = 1433, 0.018 ms at 3.35 TB/s).  A dense product of every live tile
// (20.1 GFLOP of float32 FMAs at D = 1433) multiplies zeros.
//
// Design: two passes, one launch each, no atomics, no host sync.
//   * Pass 1 (compact_kernel): one block of 512 threads per tile; a
//     masked-off tile exits at once, whatever it holds.  The block reads
//     its tile (64 KB at R = 128, 256 KB at 256) once with 16-byte loads,
//     in passes of 128 units: a unit is 128 columns of a row, four a lane
//     of one warp (warp w of 16, step k: unit 16k + w of the pass).  It
//     keeps the nonzeros in row-major order: per unit, four ballots give
//     each value its rank, one warp scans the pass's 128 unit counts into
//     offsets (after the earlier passes' total), and each value goes to its
//     rank.  R = 128 is one pass of 128 rows, R = 256 four of 64.  The
//     tile's slot in the workspace holds kHeader ints (row offsets 0..R,
//     padded to 16 bytes) and then up to R * C (column, value) pairs.  The
//     workspace is sized from the shapes alone (nr * nc slots; the wrapper
//     keeps it).
//   * Pass 2 (gather_kernel): LPR lanes own one output row and CPL
//     columns each of a slice of LPR * CPL columns (LPR = 8, 16 or 32 at
//     narrow D, so a D = 16 call still runs 352 blocks of 4 warps; up to
//     48 columns a lane, so at Cora's D = 1433 a warp takes its whole row
//     and reads the row's tile offsets and entries once).  For its row the
//     lanes read the mask, row offsets and first entry of up to LPR tiles
//     at once, ballot the tiles with entries, and walk them in ascending j
//     (the first entry comes by shuffle, later ones from L2); each
//     entry (c, v) adds v * x[j*C + c, col] to the lane's register sum.
//     So every output element is sum_j sum_c in ascending (j, c), a fixed
//     order: the result is the same bits run to run, and the row is
//     written once.  x (15.5 MB at Cora's D = 1433) is gathered from L2.
//   (A single pass, a warp per output row reading its row of every live
//   tile and gathering x for each nonzero as it found it, reads the same
//   bytes with no workspace, but each row's tile reads and gathers form
//   one chain of memory latencies; it ran slower at every width.)
//
// Exactness.  Zero entries of A are left out of the sum.  For finite x
// this changes at most the sign of a zero, so the result matches the
// dense product to float32 rounding.  For non-finite x it differs: the
// dense product gives 0 * inf = NaN where A holds a zero, this kernel
// leaves the term out (csr_spmm.py's contract).  Rows of x at or past n_x
// read as zero (the reference pads x to whole tiles): their entries are
// skipped.
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kCompactThreads = 512;
constexpr int kCompactWarps = kCompactThreads / 32;
constexpr int kSteps = 8;                           // units a warp compacts a pass
constexpr int kUnits = kCompactWarps * kSteps;      // 128 units of 128 columns a pass
constexpr int kGatherThreads = 128;
constexpr int kGatherWarps = kGatherThreads / 32;

// The geometry of an R = C = kTile tile (csr_spmm.py's TILES).
template <int kTile>
struct Tile {
  static_assert(kTile % 128 == 0 && kUnits % (kTile / 128) == 0, "whole units a pass");
  static constexpr int kElems = kTile * kTile;
  static constexpr int kHeader = (kTile + 1 + 3) / 4 * 4;   // row offsets 0..R, 16-byte padded
  static constexpr int kUnitsPerRow = kTile / 128;
  static constexpr int kPasses = kElems / (kUnits * 128);   // 1 at 128, 4 at 256
  static constexpr int kRowsPerPass = kTile / kPasses;
  // Bytes of one tile's workspace slot: the row offsets, then the entries.
  static constexpr long long kSlotBytes = 4LL * kHeader + 8LL * kElems;
};

// Compacts one tile into its workspace slot, a pass of 128 units at a
// time; an entry's rank is the nonzeros before it in row-major order.
template <int kTile>
__device__ __forceinline__ void compact_tile(const float4* src, unsigned char* slot,
                                             int* unit_cnt, int* unit_off, int* total) {
  using T = Tile<kTile>;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const unsigned lt = (1u << lane) - 1u;  // lanes below this one
  int* header = reinterpret_cast<int*>(slot);
  int2* entries = reinterpret_cast<int2*>(header + T::kHeader);
  int base = 0;  // nonzeros of the earlier passes
  for (int p = 0; p < T::kPasses; ++p) {
    float4 val[kSteps];
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      val[k] = __ldg(src + static_cast<long long>(p) * kUnits * 32 + k * kCompactThreads + tid);
    }
    unsigned below[kSteps];  // nonzeros of this unit before this lane's four
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const unsigned b0 = __ballot_sync(0xffffffffu, val[k].x != 0.f);
      const unsigned b1 = __ballot_sync(0xffffffffu, val[k].y != 0.f);
      const unsigned b2 = __ballot_sync(0xffffffffu, val[k].z != 0.f);
      const unsigned b3 = __ballot_sync(0xffffffffu, val[k].w != 0.f);
      below[k] = __popc(b0 & lt) + __popc(b1 & lt) + __popc(b2 & lt) + __popc(b3 & lt);
      if (lane == 0) {
        unit_cnt[k * kCompactWarps + warp] = __popc(b0) + __popc(b1) + __popc(b2) + __popc(b3);
      }
    }
    __syncthreads();
    if (warp == 0) {  // exclusive scan of the 128 unit counts, four units a lane
      int c[4], s = 0;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        c[r] = unit_cnt[lane * 4 + r];
        s += c[r];
      }
      int incl = s;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      int run = base + incl - s;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        unit_off[lane * 4 + r] = run;
        run += c[r];
      }
      if (lane == 31) *total = run;
    }
    __syncthreads();
    if (tid < T::kRowsPerPass) header[p * T::kRowsPerPass + tid] = unit_off[tid * T::kUnitsPerRow];
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const int u = k * kCompactWarps + warp;
      const int col0 = (u % T::kUnitsPerRow) * 128 + lane * 4;
      int at = unit_off[u] + below[k];
      const float v[4] = {val[k].x, val[k].y, val[k].z, val[k].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (v[e] != 0.f) entries[at++] = make_int2(col0 + e, __float_as_int(v[e]));
      }
    }
    base = *total;
    __syncthreads();  // unit_cnt and unit_off are reused by the next pass
  }
  if (tid == 0) header[kTile] = base;
}

// One block per tile; a masked-off tile's block exits at once.
template <int kTile>
__global__ void __launch_bounds__(kCompactThreads)
    compact_kernel(const int* __restrict__ mask, const float* __restrict__ tiles,
                   unsigned char* __restrict__ work) {
  __shared__ int unit_cnt[kUnits];
  __shared__ int unit_off[kUnits];
  __shared__ int total;
  const long long tile = blockIdx.x;
  if (__ldg(mask + tile) <= 0) return;  // block-uniform
  compact_tile<kTile>(reinterpret_cast<const float4*>(tiles + tile * Tile<kTile>::kElems),
                      work + tile * Tile<kTile>::kSlotBytes, unit_cnt, unit_off, &total);
}

template <int LPR, int CPL, int kTile>
__global__ void __launch_bounds__(kGatherThreads)
    gather_kernel(const int* __restrict__ mask, const unsigned char* __restrict__ work,
                  const float* __restrict__ x, float* __restrict__ out, int nr, int nc,
                  long long n_x, int D) {
  constexpr int kHeader = Tile<kTile>::kHeader;
  constexpr long long kSlotBytes = Tile<kTile>::kSlotBytes;
  constexpr int kRowsPerWarp = 32 / LPR;
  constexpr int kU = CPL >= 16 ? 1 : 4;  // entries whose x loads go out together
  constexpr unsigned kSegBits = LPR == 32 ? 0xffffffffu : (1u << (LPR % 32)) - 1u;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int seg = lane / LPR, sl = lane % LPR;
  const unsigned segmask = kSegBits << (seg * LPR);
  const long long row =
      (static_cast<long long>(blockIdx.x) * kGatherWarps + warp) * kRowsPerWarp + seg;
  if (row >= static_cast<long long>(nr) * kTile) return;  // whole segments leave together
  const int i = static_cast<int>(row / kTile), r = static_cast<int>(row % kTile);
  const int d0 = blockIdx.y * (LPR * CPL);

  float acc[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) acc[k] = 0.f;

  for (int j0 = 0; j0 < nc; j0 += LPR) {
    // lane sl looks at tile j0 + sl of this row tile
    const int j = j0 + sl;
    int start = 0, cnt = 0;
    int2 first = make_int2(0, 0);  // the tile's first entry, loaded with the others'
    if (j < nc && __ldg(mask + static_cast<long long>(i) * nc + j) > 0) {
      const unsigned char* slot = work + (static_cast<long long>(i) * nc + j) * kSlotBytes;
      const int* header = reinterpret_cast<const int*>(slot);
      start = __ldg(header + r);
      cnt = __ldg(header + r + 1) - start;
      if (cnt > 0) first = __ldg(reinterpret_cast<const int2*>(slot + 4LL * kHeader) + start);
    }
    unsigned todo = (__ballot_sync(segmask, cnt > 0) >> (seg * LPR)) & kSegBits;
    while (todo) {  // segment-uniform: ascending j
      const int src = __ffs(todo) - 1;
      todo &= todo - 1u;
      const int jj = j0 + src;
      const int s0 = __shfl_sync(segmask, start, src, LPR);
      const int n = __shfl_sync(segmask, cnt, src, LPR);
      const int2* ent = reinterpret_cast<const int2*>(
          work + (static_cast<long long>(i) * nc + jj) * kSlotBytes + 4LL * kHeader) + s0;
      const long long xr0 = static_cast<long long>(jj) * kTile;
      {
        const long long xr = xr0 + __shfl_sync(segmask, first.x, src, LPR);
        const float v = __int_as_float(__shfl_sync(segmask, first.y, src, LPR));
        if (xr < n_x) {
          float xv[CPL];
#pragma unroll
          for (int k = 0; k < CPL; ++k) {
            const int col = d0 + sl + k * LPR;
            xv[k] = col < D ? __ldg(x + xr * D + col) : 0.f;
          }
#pragma unroll
          for (int k = 0; k < CPL; ++k) acc[k] = fmaf(v, xv[k], acc[k]);
        }
      }
      int e = 1;
      for (; e + kU <= n; e += kU) {  // kU entries' loads in flight, then their sums in order
        int2 en[kU];
        float xv[kU][CPL];
#pragma unroll
        for (int u = 0; u < kU; ++u) en[u] = __ldg(ent + e + u);
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const long long xr = xr0 + en[u].x;
#pragma unroll
          for (int k = 0; k < CPL; ++k) {
            const int col = d0 + sl + k * LPR;
            xv[u][k] = (xr < n_x && col < D) ? __ldg(x + xr * D + col) : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          if (xr0 + en[u].x < n_x) {
            const float v = __int_as_float(en[u].y);
#pragma unroll
            for (int k = 0; k < CPL; ++k) acc[k] = fmaf(v, xv[u][k], acc[k]);
          }
        }
      }
      for (; e < n; ++e) {
        const int2 en = __ldg(ent + e);
        const long long xr = xr0 + en.x;
        if (xr < n_x) {
          const float v = __int_as_float(en.y);
#pragma unroll
          for (int k = 0; k < CPL; ++k) {
            const int col = d0 + sl + k * LPR;
            if (col < D) acc[k] = fmaf(v, __ldg(x + xr * D + col), acc[k]);
          }
        }
      }
    }
  }
  float* o = out + row * D;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int col = d0 + sl + k * LPR;
    if (col < D) o[col] = acc[k];
  }
}

template <int LPR, int CPL, int kTile>
int gather(const int* mask, const unsigned char* work, const float* x, float* out, int nr,
           int nc, long long n_x, int D, cudaStream_t s) {
  constexpr int kRowsPerBlock = kGatherWarps * (32 / LPR);
  const long long gx = (static_cast<long long>(nr) * kTile + kRowsPerBlock - 1) / kRowsPerBlock;
  const long long gy = (D + LPR * CPL - 1) / (LPR * CPL);
  if (gx > 0x7fffffffLL || gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  gather_kernel<LPR, CPL, kTile><<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy)),
                            kGatherThreads, 0, s>>>(mask, work, x, out, nr, nc, n_x, D);
  return static_cast<int>(cudaGetLastError());
}

template <int kTile>
int gather_for(const int* mask, const unsigned char* w, const float* x, float* out, int nr,
               int nc, long long n_x, int D, cudaStream_t s) {
  if (D <= 8) return gather<8, 1, kTile>(mask, w, x, out, nr, nc, n_x, D, s);
  if (D <= 16) return gather<16, 1, kTile>(mask, w, x, out, nr, nc, n_x, D, s);
  if (D <= 32) return gather<32, 1, kTile>(mask, w, x, out, nr, nc, n_x, D, s);
  if (D <= 64) return gather<32, 2, kTile>(mask, w, x, out, nr, nc, n_x, D, s);
  if (D <= 128) return gather<32, 4, kTile>(mask, w, x, out, nr, nc, n_x, D, s);
  if (D <= 512) return gather<32, 16, kTile>(mask, w, x, out, nr, nc, n_x, D, s);
  return gather<32, 48, kTile>(mask, w, x, out, nr, nc, n_x, D, s);  // Cora's 1433 in one slice
}

// f(std::integral_constant<int, tile>) for the two tiles the kernels are
// built for; any other tile is cudaErrorInvalidValue.
template <class F>
long long with_tile(int tile, F&& f) {
  switch (tile) {
    case 128:
      return f(std::integral_constant<int, 128>{});
    case 256:
      return f(std::integral_constant<int, 256>{});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Bytes of workspace the two passes need for nr x nc tiles of tile x tile
// (-1 for a tile the kernels are not built for).
extern "C" long long repro_block_spmm_workspace_bytes(int nr, int nc, int tile) {
  if (tile != 128 && tile != 256) return -1;
  return with_tile(tile, [&](auto t) {
    return static_cast<long long>(nr) * nc * Tile<decltype(t)::value>::kSlotBytes;
  });
}

// Plain C entry points (bound with ctypes), one per pass, each one launch
// on `stream`, returning cudaGetLastError(); the wrapper launches the
// compaction before it allocates the output.  tile: R = C, 128 or 256 (any
// other is cudaErrorInvalidValue); mask int32[nr, nc]; tiles float32
// [nr, nc, tile, tile], 16-byte aligned; work of
// repro_block_spmm_workspace_bytes(nr, nc, tile) bytes, 16-byte aligned;
// x float32[n_x, D] with n_x <= nc * tile (rows past n_x read as zero);
// out float32[nr * tile, D]; all contiguous.
extern "C" int repro_block_spmm_compact(const int* mask, const float* tiles, void* work, int nr,
                                        int nc, int tile, void* stream) {
  if (nr < 0 || nc < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_tiles = static_cast<long long>(nr) * nc;
  if (tile != 128 && tile != 256) return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles == 0) return static_cast<int>(cudaSuccess);
  if (n_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_tile(tile, [&](auto t) {
    compact_kernel<decltype(t)::value>
        <<<static_cast<unsigned>(n_tiles), kCompactThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            mask, tiles, static_cast<unsigned char*>(work));
    return static_cast<long long>(cudaGetLastError());
  }));
}

extern "C" int repro_block_spmm_gather(const int* mask, const void* work, const float* x,
                                       float* out, int nr, int nc, long long n_x, int D,
                                       int tile, void* stream) {
  if (tile != 128 && tile != 256) return static_cast<int>(cudaErrorInvalidValue);
  if (nr <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  if (nc < 0 || n_x < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* w = static_cast<const unsigned char*>(work);
  return static_cast<int>(with_tile(tile, [&](auto t) {
    return static_cast<long long>(
        gather_for<decltype(t)::value>(mask, w, x, out, nr, nc, n_x, D, s));
  }));
}
