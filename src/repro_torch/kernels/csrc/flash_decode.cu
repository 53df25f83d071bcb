// Split-S flash-decode attention for Hopper (sm_90a): one new token per
// sequence against its KV cache, with grouped queries (GQA).
//
// Replaces the Pallas TPU kernel
//   repro/kernels/flash_decode.py:73  flash_decode
// which, for each of BH = B * n_kv rows, takes the Q = n_heads / n_kv query
// rows of one kv head, q (Q, d), and that head's cache k, v (S, d), and
// returns softmax(q k^T / sqrt(d), masked to positions < length) v as an
// online softmax (m, l, acc) carried across S blocks of 512, finishing with
// acc / max(l, 1e-30) cast to q's dtype (a row of length 0 gives 0).  On
// the TPU the S axis is the sequential minor grid axis of one core, with
// the carry in VMEM scratch.
//
// Bound: memory.  The function must read the valid K and V rows once,
// 2 * BH * length * d * elem bytes, against 4 * Q flops per cached
// element (a multiply-add for the score and one for the output): Q / elem
// FMAs per byte, far below the f32 ridge of the card (67 TFLOP/s over
// 3.35 TB/s), so HBM bandwidth bounds it.  At smollm-360m's long_500k
// (BH = 5, S = 524,288, d = 64, bf16) that is 671 MB, 0.200 ms per layer.
// The partials add 4 * BH * n_split * Q * (d + 2) bytes each way.
//
// Design.  Blocks run in parallel and in no order here, and long_500k has
// only BH = 5 rows, so S is split across blocks (FlashDecoding): block
// (bh, s) of grid (BH, n_split) takes keys [s * chunk, min((s + 1) *
// chunk, length)).  The blocks of one split start together for all the
// rows, so the n_kv heads' rows, which lie interleaved in the cache
// ((B, S_max, n_kv, d)), are read from the same DRAM pages at about the
// same time.  (A plan that cut the rows' valid tiles into equal ranges,
// one per block of a single wave, balanced decode_32k's ragged lengths
// but read each head's rows at other times, and ran slower at both
// long_500k and decode_32k.)  Two routes, one kernel each; one call is
// one launch.
//   * TMA route (flash_tma_kernel), the rule: a producer warp streams K
//     and V tiles of T keys through a ring of 4-8 stages in shared memory
//     with TMA (cp.async.bulk.tensor over a tensor map of the cache slice
//     (d, n_kv, S_max, B) as it lies, box (d, 1, T, 1)); each stage has a
//     "full" mbarrier that the copy completes and an "empty" one that each
//     of the 4 consumer warps arrives on when done, so no block-wide
//     barrier runs per tile and up to a ring of tiles is in flight.  It
//     takes caches whose row bytes and used strides are multiples of 16
//     and whose base is 16-byte aligned (the wrapper's rule, checked here
//     again).  The tensor maps are encoded with cuTensorMapEncodeTiled,
//     reached through cudaGetDriverEntryPoint (no -lcuda), on every call:
//     an encode costs about 0.1 us on the host, no more than a lookup in
//     a cache of encoded maps did.
//   * cp.async route (flash_cpasync_kernel), for every other cache (d = 12
//     in bf16 has 24-byte rows): 256 threads copy tiles with 16-, 8- or
//     4-byte cp.async vectors into two padded stages, with a barrier
//     before and after each tile.
//   * Compute, both routes: a group of G lanes owns one key at a time,
//     each lane E head dims (G = pow2(ceil(d / E))); the lanes' partial
//     dots meet in a shuffle butterfly.  On the TMA route E = 16 for up to
//     4 query rows (so d = 64 takes G = 4 lanes and two butterfly levels
//     per key, not 8 lanes and three) and 8 above, and each lane keeps its
//     dims of every query row in registers, loaded once per block (Q <= 8;
//     the Q = 16 bucket keeps q in shared memory, since its accumulator
//     alone takes 128 registers).  A lane reads its dims as 16-byte
//     vectors c, c + G, ... of the row, so a quarter-warp reads one
//     contiguous 128-byte span.  Each group carries its own online softmax
//     (m, l, acc) in float32 registers over KB keys at a time, in base 2
//     (q pre-scaled by log2(e) / sqrt(d)); float32 FMAs, no tensor cores
//     (the work is far below the ridge; no TF32).  At the end the groups
//     merge by shuffles in a warp and through shared memory across warps,
//     in a fixed order.
//   * The combine is fused: with one split the block writes the output;
//     else each block writes its partial (m, l, acc) to a float32
//     workspace, counts itself on a per-row counter, and the row's last
//     block merges the partials in split order (so the result does not
//     depend on which block came last), writes acc / max(l, 1e-30) in q's
//     dtype and sets the counter back to 0 for the next call.
//   * Optional log-sum-exp: given an `lse` pointer, the block that writes
//     a row's output (the one block with one split, else the combine)
//     also writes each query row's natural log-sum-exp of its scaled,
//     masked scores, float32 (B * n_kv, Q): ln 2 * (m + log2 l) in the
//     kernel's base-2 terms, -inf for a row of length 0.  Ranks that hold
//     a sequence-sharded cache combine their partial outputs with it.
//     Without it (a null pointer) nothing else changes.
//   * The cache is read where it lies, through (batch, position, head)
//     strides: attention_decode passes one layer's (B, S_max, n_kv, d)
//     slice with no transpose (the reference copies the whole cache to
//     (B * n_kv, S_max, d) every step, repro/models/layers.py:250-252).
//     Lengths are per batch row; any S, no padding.  q may be f32 or bf16
//     independently of the cache; K and V share one dtype.
//   * n_split is sized by repro_flash_decode_plan from the card's resident
//     block slots: one wave when a row can take four splits or more, else
//     four waves or more.  The shared-memory limit of each kernel instance
//     is set once per device.
//
// Known limits, left for later work: Q is rounded up to a compiled bucket
// (1, 2, 3, 4, 8, 16), so Q = 9 does the work of 16; n_split is a fixed
// rule, not tuned.
#include <cuda.h>  // CUtensorMap and its enums only: the driver is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <chrono>
#include <cstdint>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float neg_inf() { return __int_as_float(static_cast<int>(0xff800000u)); }

__device__ __forceinline__ float bf16_bits_to_float(unsigned short b) {
  return __uint_as_float(static_cast<unsigned>(b) << 16);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// One 16-byte vector from shared memory as float32: 4 floats or 8 bf16.
__device__ __forceinline__ void load_vec(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
}

__device__ __forceinline__ void load_vec(const unsigned short* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);  // 8 bf16, low half first
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 8 consecutive values from shared memory as float32.
template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&o)[8]) {
#pragma unroll
  for (int i = 0; i < 8; i += 16 / sizeof(T)) load_vec(p + i, o + i);
}

__device__ __forceinline__ void cp_async(void* smem, const void* gmem, int bytes) {
  const unsigned s = smem_u32(smem);
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// mbarriers and TMA (PTX for sm_90).
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spins until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra.uni DONE;\n"
      "bra.uni LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

template <typename TO>
__device__ __forceinline__ void store_out(TO* p, float x);
template <>
__device__ __forceinline__ void store_out<float>(float* p, float x) { *p = x; }
template <>
__device__ __forceinline__ void store_out<unsigned short>(unsigned short* p, float x) {
  *p = __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store_any(void* out, int q_bf16, long long at, float x) {
  if (q_bf16) {
    store_out<unsigned short>(static_cast<unsigned short*>(out) + at, x);
  } else {
    store_out<float>(static_cast<float*>(out) + at, x);
  }
}

// The end of a row's piece of work, both routes.  The merged result is in
// shared memory: sm_acc[QM][DP] (indexed by head dim) and sm_ml[0..QM) =
// m, sm_ml[QM..2QM) = l.  If the row has one piece (n_parts = 1) it is
// the row's output; else it becomes the partial in slot `slot` of the
// workspace (n_slots slots: m and l, then acc), the row's counter counts
// it, and the row's last piece (the counter, set back to 0 by that block)
// merges the row's partials, slots first_slot .. first_slot + n_parts - 1,
// in slot order, whichever came last.  `bar` / `nthr` name the barrier of
// the `nthr` threads that run this.  The block that writes the output
// writes the row's log-sum-exp too where `lse` is not null.
__device__ __forceinline__ float natural_lse(float m, float l) {
  return l > 0.f ? (m + log2f(l)) * kLn2 : neg_inf();
}

__device__ void finish_piece(const float* sm_acc, int DP, const float* sm_ml, int QM, int* sm_flag,
                             float* __restrict__ work, long long n_slots, long long slot,
                             long long first_slot, int n_parts, unsigned* __restrict__ counter,
                             void* __restrict__ out, float* __restrict__ lse, int q_bf16,
                             long long row, int Q, int d, int tid, int nthr, int bar) {
  const long long o0 = row * Q * d;
  if (n_parts == 1) {
    for (int i = tid; i < Q * d; i += nthr) {
      const int qr = i / d;
      store_any(out, q_bf16, o0 + i, sm_acc[qr * DP + i % d] / fmaxf(sm_ml[QM + qr], 1e-30f));
    }
    if (lse != nullptr && tid < Q) lse[row * Q + tid] = natural_lse(sm_ml[tid], sm_ml[QM + tid]);
    return;
  }
  float* ml_out = work + slot * Q * 2;
  float* acc_out = work + n_slots * Q * 2 + slot * Q * d;
  for (int i = tid; i < Q * d; i += nthr) acc_out[i] = sm_acc[(i / d) * DP + i % d];
  if (tid < Q) {
    ml_out[2 * tid] = sm_ml[tid];
    ml_out[2 * tid + 1] = sm_ml[QM + tid];
  }
  __threadfence();  // this piece's partial, before its count
  bar_sync(bar, nthr);
  if (tid == 0) *sm_flag = atomicAdd(counter, 1u) == static_cast<unsigned>(n_parts - 1);
  bar_sync(bar, nthr);
  if (!*sm_flag) return;
  __threadfence();  // every other piece's partial, after the count
  const float* ml = work + first_slot * Q * 2;
  const float* acc = work + n_slots * Q * 2 + first_slot * Q * d;
  for (int i = tid; i < Q * d; i += nthr) {
    const int qr = i / d;
    float M = neg_inf();
#pragma unroll 8
    for (int s = 0; s < n_parts; ++s) M = fmaxf(M, __ldcg(ml + (s * Q + qr) * 2));
    const float ms = M == neg_inf() ? 0.f : M;
    float L = 0.f, A = 0.f;
#pragma unroll 4
    for (int s = 0; s < n_parts; ++s) {
      const float fs = exp2f(__ldcg(ml + (s * Q + qr) * 2) - ms);
      L += __ldcg(ml + (s * Q + qr) * 2 + 1) * fs;
      A += __ldcg(acc + static_cast<long long>(s) * Q * d + i) * fs;
    }
    store_any(out, q_bf16, o0 + i, A / fmaxf(L, 1e-30f));
    if (lse != nullptr && i % d == 0) lse[row * Q + qr] = natural_lse(ms, L);
  }
  if (tid == 0) *counter = 0u;  // ready for the next call on this stream
}

// Merges the online-softmax states of the groups of a warp (lanes c, c + G,
// c + 2G, ... hold the same dims) by shuffles, in a fixed order.
template <int QM, int E>
__device__ __forceinline__ void merge_groups(float (&m)[QM], float (&l)[QM], float (&acc)[QM][E],
                                             int G) {
  for (int off = G; off < 32; off <<= 1) {
#pragma unroll
    for (int qq = 0; qq < QM; ++qq) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[qq], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[qq], off);
      const float mn = fmaxf(m[qq], mo);
      const float ms = mn == neg_inf() ? 0.f : mn;
      const float a = exp2f(m[qq] - ms), bb = exp2f(mo - ms);
      l[qq] = l[qq] * a + lo * bb;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[qq][e], off);
        acc[qq][e] = acc[qq][e] * a + ao * bb;
      }
      m[qq] = mn;
    }
  }
}

// Merges the warps' states through shared memory, in warp order, into
// sm_acc[QM][DP] and sm_ml (m then l).  `dim(c, e)` is the head dim of a
// lane's e-th value; lanes c < G of each warp take part, those with
// live(c, e) write.
template <int QM, int E, typename Dim, typename Live>
__device__ __forceinline__ void merge_warps(const float (&m)[QM], const float (&l)[QM],
                                            const float (&acc)[QM][E], float* sm_m, float* sm_l,
                                            float* sm_acc, float* sm_ml, int DP, int n_warps,
                                            int warp, int lane, int G, int tid, int bar,
                                            Dim dim, Live live) {
  if (lane == 0) {
#pragma unroll
    for (int qq = 0; qq < QM; ++qq) {
      sm_m[warp * QM + qq] = m[qq];
      sm_l[warp * QM + qq] = l[qq];
    }
  }
  bar_sync(bar, n_warps * 32);
  float f[QM];
#pragma unroll
  for (int qq = 0; qq < QM; ++qq) {
    float mx = neg_inf();
    for (int w = 0; w < n_warps; ++w) mx = fmaxf(mx, sm_m[w * QM + qq]);
    const float ms = mx == neg_inf() ? 0.f : mx;
    f[qq] = exp2f(m[qq] - ms);
    if (tid == 0) {
      float lsum = 0.f;
      for (int w = 0; w < n_warps; ++w) lsum += sm_l[w * QM + qq] * exp2f(sm_m[w * QM + qq] - ms);
      sm_ml[qq] = mx;
      sm_ml[QM + qq] = lsum;
    }
  }
  for (int w = 0; w < n_warps; ++w) {
    if (warp == w && lane < G) {
#pragma unroll
      for (int qq = 0; qq < QM; ++qq) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (live(lane, e)) {
            const int at = qq * DP + dim(lane, e);
            const float x = acc[qq][e] * f[qq];
            sm_acc[at] = w == 0 ? x : sm_acc[at] + x;
          }
        }
      }
    }
    bar_sync(bar, n_warps * 32);
  }
}

// ---------------------------------------------------------------------------
// cp.async route
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kE = 8;  // head dims per lane

// Keys per group per tile: fewer when Q is large, to bound registers.
__host__ __device__ constexpr int keys_per_group(int qm) { return qm <= 4 ? 4 : 2; }

// Launch geometry, shared by the host planner and the kernel.
struct Geometry {
  int G;      // lanes per key
  int T;      // keys per tile
  int pitch;  // bytes per staged row: the row rounded up to 16, plus 16 (bank spread)
  int DP;     // padded head dim of the q and accumulator tiles (G * kE)
  int stage_bytes;
  int smem_bytes;
};

__host__ __device__ inline Geometry geometry(int d, int es, int qm) {
  Geometry g;
  const int nchunk = (d + kE - 1) / kE;
  g.G = 1;
  while (g.G < nchunk) g.G <<= 1;
  g.T = (kThreads / g.G) * keys_per_group(qm);
  const int row_bytes = d * es;
  g.pitch = ((row_bytes + 15) & ~15) + 16;
  g.DP = g.G * kE;
  g.stage_bytes = 2 * g.T * g.pitch;  // K rows, then V rows
  // two stages, q (qm x DP), the merged accumulator (qm x DP), per-warp m
  // and l, the merged m and l, the last-block flag
  g.smem_bytes = 2 * g.stage_bytes + 4 * (2 * qm * g.DP + 2 * kWarps * qm + 2 * qm + 1);
  return g;
}

template <typename TKV, int QM>
__global__ void __launch_bounds__(kThreads)
    flash_cpasync_kernel(const void* __restrict__ q, int q_bf16, const void* __restrict__ k,
                         const void* __restrict__ v, const int* __restrict__ lengths,
                         float* __restrict__ work, unsigned* __restrict__ counters,
                         void* __restrict__ out, float* __restrict__ lse, int n_kv, int S, int Q,
                         int d, long long ksb,
                         long long kss, long long ksh, long long vsb, long long vss,
                         long long vsh, int chunk, int vec, float qscale) {
  constexpr int KB = keys_per_group(QM);
  constexpr int es = sizeof(TKV);
  extern __shared__ __align__(16) unsigned char smem[];
  const Geometry geo = geometry(d, es, QM);
  const int G = geo.G, T = geo.T, pitch = geo.pitch, DP = geo.DP;
  const int bh = blockIdx.x, split = blockIdx.y;
  const int BH = gridDim.x, n_split = gridDim.y;
  const int b = bh / n_kv, h = bh % n_kv;
  const int len = min(max(lengths[b], 0), S);
  const int t_begin = split * chunk;
  const int t_stop = min(t_begin + chunk, len);
  const int n_tiles = t_stop > t_begin ? (t_stop - t_begin + T - 1) / T : 0;

  float* qs = reinterpret_cast<float*>(smem + 2 * geo.stage_bytes);  // [QM][DP]
  float* sm_acc = qs + QM * DP;                                       // [QM][DP]
  float* sm_m = sm_acc + QM * DP;                                     // [kWarps][QM]
  float* sm_l = sm_m + kWarps * QM;                                   // [kWarps][QM]
  float* sm_ml = sm_l + kWarps * QM;                                  // [2][QM]
  int* sm_flag = reinterpret_cast<int*>(sm_ml + 2 * QM);

  // q, pre-scaled into base-2 logits, zero past Q and d
  const long long q0 = static_cast<long long>(bh) * Q * d;
  for (int i = threadIdx.x; i < QM * DP; i += kThreads) {
    const int qr = i / DP, j = i % DP;
    float x = 0.f;
    if (qr < Q && j < d) {
      const long long at = q0 + static_cast<long long>(qr) * d + j;
      x = q_bf16 ? bf16_bits_to_float(static_cast<const unsigned short*>(q)[at])
                 : static_cast<const float*>(q)[at];
    }
    qs[i] = x * qscale;
  }
  // zero each staged row's padding once: cp.async never writes it, and a
  // lane whose 8 dims run past d reads it as zeros
  const int row_bytes = d * es;
  const int pad_words = (pitch - row_bytes) / 4;
  for (int i = threadIdx.x; i < 4 * T * pad_words; i += kThreads) {
    const int row = i / pad_words, w = i % pad_words;
    reinterpret_cast<unsigned*>(smem + row * pitch + row_bytes)[w] = 0u;
  }

  const unsigned char* kb = static_cast<const unsigned char*>(k) + (b * ksb + h * ksh) * es;
  const unsigned char* vb = static_cast<const unsigned char*>(v) + (b * vsb + h * vsh) * es;
  // the copy walks (row, vector) pairs with a stride of kThreads vectors;
  // its divisions are hoisted here, out of the tile loop
  const int nv = row_bytes / vec;
  const int r_first = threadIdx.x / nv, x_first = threadIdx.x % nv;
  const int r_step = kThreads / nv, x_step = kThreads % nv;
  auto copy_rows = [&](unsigned char* dst, const unsigned char* src, long long stride, int t0,
                       int rows) {
    int r = r_first, x = x_first;
    for (int j = threadIdx.x; j < rows * nv; j += kThreads) {
      cp_async(dst + r * pitch + x * vec, src + (t0 + r) * stride * es + x * vec, vec);
      r += r_step;
      x += x_step;
      if (x >= nv) {
        x -= nv;
        ++r;
      }
    }
  };
  auto issue = [&](int tile) {
    unsigned char* st = smem + (tile & 1) * geo.stage_bytes;
    const int t0 = t_begin + tile * T;
    const int rows = min(T, t_stop - t0);
    copy_rows(st, kb, kss, t0, rows);
    copy_rows(st + T * pitch, vb, vss, t0, rows);
    cp_async_commit();
  };

  const int grp = threadIdx.x / G, c = threadIdx.x % G;
  const int nchunk = (d + kE - 1) / kE;
  const bool lane_live = c < nchunk;
  float m[QM], l[QM], acc[QM][kE];
#pragma unroll
  for (int qq = 0; qq < QM; ++qq) {
    m[qq] = neg_inf();
    l[qq] = 0.f;
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[qq][e] = 0.f;
  }

  if (n_tiles > 0) issue(0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) {
      issue(tile + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* ks = smem + (tile & 1) * geo.stage_bytes;
    const unsigned char* vs = ks + T * pitch;
    const int t0 = t_begin + tile * T;

    float s[KB][QM];
#pragma unroll
    for (int i = 0; i < KB; ++i) {
      float kf[kE];
      if (lane_live) {
        load8(reinterpret_cast<const TKV*>(ks + (grp * KB + i) * pitch) + c * kE, kf);
      } else {
#pragma unroll
        for (int e = 0; e < kE; ++e) kf[e] = 0.f;
      }
#pragma unroll
      for (int qq = 0; qq < QM; ++qq) {
        float qv[kE];
        load8(qs + qq * DP + c * kE, qv);
        float acc_s = 0.f;
#pragma unroll
        for (int e = 0; e < kE; ++e) acc_s = fmaf(qv[e], kf[e], acc_s);
        s[i][qq] = acc_s;
      }
    }
#pragma unroll
    for (int i = 0; i < KB; ++i) {
      const bool valid = t0 + grp * KB + i < t_stop;
#pragma unroll
      for (int qq = 0; qq < QM; ++qq) {
        float x = s[i][qq];
        for (int off = G >> 1; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
        s[i][qq] = valid ? x : neg_inf();
      }
    }
    // online softmax over this group's KB keys; s becomes p
#pragma unroll
    for (int qq = 0; qq < QM; ++qq) {
      float mb = s[0][qq];
#pragma unroll
      for (int i = 1; i < KB; ++i) mb = fmaxf(mb, s[i][qq]);
      const float mn = fmaxf(m[qq], mb);
      const float ms = mn == neg_inf() ? 0.f : mn;
      const float alpha = exp2f(m[qq] - ms);
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < KB; ++i) {
        s[i][qq] = exp2f(s[i][qq] - ms);
        psum += s[i][qq];
      }
      l[qq] = l[qq] * alpha + psum;
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[qq][e] *= alpha;
      m[qq] = mn;
    }
#pragma unroll
    for (int i = 0; i < KB; ++i) {
      const int r = grp * KB + i;
      if (lane_live && t0 + r < t_stop) {  // masked rows are never read
        float vf[kE];
        load8(reinterpret_cast<const TKV*>(vs + r * pitch) + c * kE, vf);
#pragma unroll
        for (int qq = 0; qq < QM; ++qq) {
#pragma unroll
          for (int e = 0; e < kE; ++e) acc[qq][e] = fmaf(s[i][qq], vf[e], acc[qq][e]);
        }
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's issue
  }

  merge_groups<QM, kE>(m, l, acc, G);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  merge_warps<QM, kE>(
      m, l, acc, sm_m, sm_l, sm_acc, sm_ml, DP, kWarps, warp, lane, G, threadIdx.x, 0,
      [](int cc, int e) { return cc * kE + e; }, [&](int cc, int e) { return cc < nchunk; });
  const long long n_slots = static_cast<long long>(BH) * n_split;
  finish_piece(sm_acc, DP, sm_ml, QM, sm_flag, work, n_slots,
               static_cast<long long>(bh) * n_split + split, static_cast<long long>(bh) * n_split,
               n_split, counters + bh, out, lse, q_bf16, bh, Q, d, threadIdx.x, kThreads, 0);
}

// ---------------------------------------------------------------------------
// TMA route
// ---------------------------------------------------------------------------

constexpr int kConsumerWarps = 4;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kTmaThreads = kConsumers + 32;  // and one producer warp
constexpr int kRingBytes = 96 * 1024;
constexpr int kMinStages = 4;
constexpr int kMaxStages = 8;

// Head dims per lane, and keys per group per stage.
__host__ __device__ constexpr int tma_dims_per_lane(int qm) { return qm <= 4 ? 16 : 8; }
__host__ __device__ constexpr int tma_keys_per_group(int qm) { return qm <= 8 ? 2 : 1; }

struct TmaGeometry {
  int G;            // lanes per key
  int DP;           // G * E, padded head dim of the accumulator tile
  int T;            // keys per stage (the TMA box's rows)
  int tile_bytes;   // one K or V tile: T dense rows of d elements
  int stage_bytes;  // K tile, V tile, rounded up to 128
  int stages;
  int smem_bytes;
};

__host__ __device__ inline TmaGeometry tma_geometry(int d, int es, int qm) {
  TmaGeometry g;
  const int E = tma_dims_per_lane(qm);
  g.G = 1;
  while (g.G * E < d) g.G <<= 1;
  g.DP = g.G * E;
  g.T = kConsumerWarps * (32 / g.G) * tma_keys_per_group(qm);
  g.tile_bytes = g.T * d * es;
  g.stage_bytes = (2 * g.tile_bytes + 127) & ~127;
  g.stages = kRingBytes / g.stage_bytes;
  if (g.stages < kMinStages) g.stages = kMinStages;
  if (g.stages > kMaxStages) g.stages = kMaxStages;
  const int q_smem = qm > 8 ? qm * g.DP : 0;  // the Q = 16 bucket keeps q here
  // the ring, a full and an empty barrier per stage, q, the merged
  // accumulator, per-warp m and l, the merged m and l, the last-block flag
  g.smem_bytes = g.stages * g.stage_bytes + 16 * g.stages +
                 4 * (q_smem + qm * g.DP + 2 * kConsumerWarps * qm + 2 * qm + 1);
  return g;
}

template <typename TKV, int QM>
__global__ void __launch_bounds__(kTmaThreads, QM <= 8 ? 2 : 1)
    flash_tma_kernel(const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, const void* __restrict__ q,
                     int q_bf16, const int* __restrict__ lengths, float* __restrict__ work,
                     unsigned* __restrict__ counters, void* __restrict__ out,
                     float* __restrict__ lse, int n_kv, int S, int Q, int d, int chunk,
                     float qscale) {
  constexpr int es = sizeof(TKV);
  constexpr int E = tma_dims_per_lane(QM);
  constexpr int KB = tma_keys_per_group(QM);
  constexpr int VE = 16 / es;  // elements per 16-byte vector
  constexpr int NV = E / VE;   // vectors per lane
  constexpr bool kQInRegs = QM <= 8;
  extern __shared__ __align__(128) unsigned char tma_smem[];
  unsigned char* smem = tma_smem;
  const TmaGeometry geo = tma_geometry(d, es, QM);
  const int G = geo.G, T = geo.T, DP = geo.DP, stages = geo.stages;
  const int bh = blockIdx.x, split = blockIdx.y;
  const int BH = gridDim.x, n_split = gridDim.y;
  const int b = bh / n_kv, h = bh % n_kv;
  const int len = min(max(lengths[b], 0), S);
  const int t_begin = split * chunk;
  const int t_stop = min(t_begin + chunk, len);
  const int n_tiles = t_stop > t_begin ? (t_stop - t_begin + T - 1) / T : 0;

  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * geo.stage_bytes);
  uint64_t* empty = full + stages;
  float* qs = reinterpret_cast<float*>(empty + stages);  // [QM][DP], Q = 16 bucket only
  float* sm_acc = qs + (kQInRegs ? 0 : QM * DP);         // [QM][DP]
  float* sm_m = sm_acc + QM * DP;                        // [kConsumerWarps][QM]
  float* sm_l = sm_m + kConsumerWarps * QM;              // [kConsumerWarps][QM]
  float* sm_ml = sm_l + kConsumerWarps * QM;             // [2][QM]
  int* sm_flag = reinterpret_cast<int*>(sm_ml + 2 * QM);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer warp: one lane keeps the ring full
    if (lane == 0) {
      for (int tile = 0; tile < n_tiles; ++tile) {
        const int st = tile % stages, round = tile / stages;
        if (round > 0) mbar_wait(empty + st, (round - 1) & 1);
        unsigned char* dst = smem + st * geo.stage_bytes;
        mbar_arrive_expect_tx(full + st, 2 * geo.tile_bytes);
        const int t0 = t_begin + tile * T;
        tma_load_4d(dst, &kmap, full + st, 0, h, t0, b);
        tma_load_4d(dst + geo.tile_bytes, &vmap, full + st, 0, h, t0, b);
      }
    }
    return;
  }

  // consumers: lane c of group grp owns 16-byte vectors c, c + G, ... of a row
  const int grp = lane / G, c = lane % G;
  const int key0 = (warp * (32 / G) + grp) * KB;  // this group's first key in a stage
  auto vec_live = [&](int kk) { return (c + G * kk) * VE < d; };

  {
    // q, pre-scaled into base-2 logits, zero past Q and d
    const long long q0 = static_cast<long long>(bh) * Q * d;
    auto q_at = [&](int qq, int dim) {
      float x = 0.f;
      if (qq < Q && dim < d) {
        const long long at = q0 + static_cast<long long>(qq) * d + dim;
        x = q_bf16 ? bf16_bits_to_float(static_cast<const unsigned short*>(q)[at])
                   : static_cast<const float*>(q)[at];
      }
      return x * qscale;
    };
    float qr[kQInRegs ? QM : 1][E];
    if constexpr (kQInRegs) {
#pragma unroll
      for (int qq = 0; qq < QM; ++qq) {
#pragma unroll
        for (int kk = 0; kk < NV; ++kk) {
#pragma unroll
          for (int e = 0; e < VE; ++e) qr[qq][kk * VE + e] = q_at(qq, (c + G * kk) * VE + e);
        }
      }
    } else {
      for (int i = tid; i < QM * DP; i += kConsumers) qs[i] = q_at(i / DP, i % DP);
      bar_sync(1, kConsumers);
    }

    float m[QM], l[QM], acc[QM][E];
#pragma unroll
    for (int qq = 0; qq < QM; ++qq) {
      m[qq] = neg_inf();
      l[qq] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[qq][e] = 0.f;
    }

    for (int tile = 0; tile < n_tiles; ++tile) {
      const int st = tile % stages, round = tile / stages;
      mbar_wait(full + st, round & 1);
      const TKV* ks = reinterpret_cast<const TKV*>(smem + st * geo.stage_bytes);
      const TKV* vs = reinterpret_cast<const TKV*>(smem + st * geo.stage_bytes + geo.tile_bytes);
      const int t0 = t_begin + tile * T;

      float s[KB][QM];
#pragma unroll
      for (int i = 0; i < KB; ++i) {
        float kf[E];
#pragma unroll
        for (int kk = 0; kk < NV; ++kk) {
          if (vec_live(kk)) {
            load_vec(ks + (key0 + i) * d + (c + G * kk) * VE, kf + kk * VE);
          } else {
#pragma unroll
            for (int e = 0; e < VE; ++e) kf[kk * VE + e] = 0.f;
          }
        }
#pragma unroll
        for (int qq = 0; qq < QM; ++qq) {
          float acc_s = 0.f;
          if constexpr (kQInRegs) {  // two chains of E / 2 FMAs, for the issue slots
            float acc_o = 0.f;
#pragma unroll
            for (int e = 0; e < E; e += 2) {
              acc_s = fmaf(qr[qq][e], kf[e], acc_s);
              acc_o = fmaf(qr[qq][e + 1], kf[e + 1], acc_o);
            }
            acc_s += acc_o;
          } else {
#pragma unroll
            for (int kk = 0; kk < NV; ++kk) {
              float qv[VE];  // q is float32 in shared memory: VE / 4 vectors
#pragma unroll
              for (int e = 0; e < VE; e += 4) {
                load_vec(qs + qq * DP + (c + G * kk) * VE + e, qv + e);
              }
#pragma unroll
              for (int e = 0; e < VE; ++e) acc_s = fmaf(qv[e], kf[kk * VE + e], acc_s);
            }
          }
          s[i][qq] = acc_s;
        }
      }
#pragma unroll
      for (int i = 0; i < KB; ++i) {
        const bool valid = t0 + key0 + i < t_stop;
#pragma unroll
        for (int qq = 0; qq < QM; ++qq) {
          float x = s[i][qq];
          for (int off = G >> 1; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
          s[i][qq] = valid ? x : neg_inf();
        }
      }
      // online softmax over this group's KB keys; s becomes p
#pragma unroll
      for (int qq = 0; qq < QM; ++qq) {
        float mb = s[0][qq];
#pragma unroll
        for (int i = 1; i < KB; ++i) mb = fmaxf(mb, s[i][qq]);
        const float mn = fmaxf(m[qq], mb);
        const float ms = mn == neg_inf() ? 0.f : mn;
        const float alpha = exp2f(m[qq] - ms);
        float psum = 0.f;
#pragma unroll
        for (int i = 0; i < KB; ++i) {
          s[i][qq] = exp2f(s[i][qq] - ms);
          psum += s[i][qq];
        }
        l[qq] = l[qq] * alpha + psum;
        // rescale only when some group's running max rose from a finite
        // value (alpha is then < 1; else it is 1, or acc is still 0): the
        // same bits as always rescaling, and rare once the max settles
        if (__any_sync(0xffffffffu, mn != m[qq] && m[qq] != neg_inf())) {
#pragma unroll
          for (int e = 0; e < E; ++e) acc[qq][e] *= alpha;
        }
        m[qq] = mn;
      }
#pragma unroll
      for (int i = 0; i < KB; ++i) {
        if (t0 + key0 + i < t_stop) {  // masked rows are never read
#pragma unroll
          for (int kk = 0; kk < NV; ++kk) {
            if (vec_live(kk)) {
              float vf[VE];
              load_vec(vs + (key0 + i) * d + (c + G * kk) * VE, vf);
#pragma unroll
              for (int qq = 0; qq < QM; ++qq) {
#pragma unroll
                for (int e = 0; e < VE; ++e)
                  acc[qq][kk * VE + e] = fmaf(s[i][qq], vf[e], acc[qq][kk * VE + e]);
              }
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + st);  // this warp is done with the stage
    }

    merge_groups<QM, E>(m, l, acc, G);
    merge_warps<QM, E>(
        m, l, acc, sm_m, sm_l, sm_acc, sm_ml, DP, kConsumerWarps, warp, lane, G, tid, 1,
        [&](int cc, int e) { return (cc + G * (e / VE)) * VE + e % VE; },
        [&](int cc, int e) { return (cc + G * (e / VE)) * VE < d; });
    const long long n_slots = static_cast<long long>(BH) * n_split;
    finish_piece(sm_acc, DP, sm_ml, QM, sm_flag, work, n_slots,
                 static_cast<long long>(bh) * n_split + split, static_cast<long long>(bh) * n_split,
                 n_split, counters + bh, out, lse, q_bf16, bh, Q, d, tid, kConsumers, 1);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using CpAsyncFn = void (*)(const void*, int, const void*, const void*, const int*, float*,
                           unsigned*, void*, float*, int, int, int, int, long long, long long,
                           long long, long long, long long, long long, int, int, float);
using TmaFn = void (*)(const CUtensorMap, const CUtensorMap, const void*, int, const int*, float*,
                       unsigned*, void*, float*, int, int, int, int, int, float);

constexpr int kBuckets[6] = {1, 2, 3, 4, 8, 16};

int q_bucket(int Q) {
  if (Q <= 4) return Q;
  return Q <= 8 ? 8 : 16;
}

int bucket_index(int qm) {
  for (int i = 0; i < 6; ++i)
    if (kBuckets[i] == qm) return i;
  return 5;
}

template <typename TKV>
CpAsyncFn cpasync_for(int qm) {
  switch (qm) {
    case 1: return flash_cpasync_kernel<TKV, 1>;
    case 2: return flash_cpasync_kernel<TKV, 2>;
    case 3: return flash_cpasync_kernel<TKV, 3>;
    case 4: return flash_cpasync_kernel<TKV, 4>;
    case 8: return flash_cpasync_kernel<TKV, 8>;
    default: return flash_cpasync_kernel<TKV, 16>;
  }
}

template <typename TKV>
TmaFn tma_for(int qm) {
  switch (qm) {
    case 1: return flash_tma_kernel<TKV, 1>;
    case 2: return flash_tma_kernel<TKV, 2>;
    case 3: return flash_tma_kernel<TKV, 3>;
    case 4: return flash_tma_kernel<TKV, 4>;
    case 8: return flash_tma_kernel<TKV, 8>;
    default: return flash_tma_kernel<TKV, 16>;
  }
}

bool shape_ok(int Q, int d, int kv_bf16) {
  return Q >= 1 && Q <= 16 && d >= 1 && d <= 256 && (d * (kv_bf16 ? 2 : 4)) % 4 == 0;
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<unsigned long long>(p) % bytes == 0;
}

// Devices whose shared-memory limit is set, per (route, dtype, bucket).
std::atomic<unsigned long long> g_smem_set[2][2][6];

struct Kernel {
  const void* fn;
  int threads;
  int smem_bytes;
  int T;       // keys per tile
  int stages;  // ring stages (TMA), 2 (cp.async)
};

// The kernel instance for these shapes; sets its shared-memory limit on
// the current device the first time it is asked for.
int kernel_for(int Q, int d, int kv_bf16, int tma, Kernel* kern) {
  const int qm = q_bucket(Q);
  const int es = kv_bf16 ? 2 : 4;
  if (tma) {
    const TmaGeometry g = tma_geometry(d, es, qm);
    const void* fn = reinterpret_cast<const void*>(kv_bf16 ? tma_for<unsigned short>(qm)
                                                           : tma_for<float>(qm));
    *kern = {fn, kTmaThreads, g.smem_bytes, g.T, g.stages};
  } else {
    const Geometry g = geometry(d, es, qm);
    const void* fn = reinterpret_cast<const void*>(kv_bf16 ? cpasync_for<unsigned short>(qm)
                                                           : cpasync_for<float>(qm));
    *kern = {fn, kThreads, g.smem_bytes, g.T, 2};
  }
  int dev = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc != 0) return rc;
  // the limit is the card's most, since an instance's shared memory grows
  // with d; a block still takes only what its launch asks for
  std::atomic<unsigned long long>& done =
      g_smem_set[tma ? 1 : 0][kv_bf16 ? 1 : 0][bucket_index(qm)];
  const unsigned long long bit = 1ULL << (dev & 63);
  if (!(done.load() & bit)) {
    int most = 0;
    rc = static_cast<int>(
        cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
    if (rc != 0) return rc;
    rc = static_cast<int>(
        cudaFuncSetAttribute(kern->fn, cudaFuncAttributeMaxDynamicSharedMemorySize, most));
    if (rc != 0) return rc;
    done.fetch_or(bit);
  }
  return 0;
}

// cuTensorMapEncodeTiled, through the runtime's driver entry point.
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeFn encode_fn() {
  static const EncodeFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                            cudaEnableDefault, &found);
#else
    const cudaError_t rc =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return rc == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeFn>(p)
                                                                     : nullptr;
  }();
  return fn;
}

// A tensor map's shape: the cache slice (d, n_kv, S, B), strides in
// bytes; a dimension of size 1 takes a packed stride, which it never uses.
struct MapKey {
  const void* base;
  long long es;
  cuuint64_t dims[4];
  cuuint64_t strides[3];  // bytes, of dims 1..3
  long long box_rows;
};

MapKey map_key(const void* base, int es, int d, int n_kv, int S, int B, long long sb,
               long long ss, long long sh, int T) {
  MapKey key;
  key.base = base;
  key.es = es;
  key.dims[0] = d;
  key.dims[1] = n_kv;
  key.dims[2] = S;
  key.dims[3] = B;
  key.strides[0] = n_kv > 1 ? sh * es : static_cast<cuuint64_t>(d) * es;
  key.strides[1] = S > 1 ? ss * es : key.strides[0] * n_kv;
  key.strides[2] = B > 1 ? sb * es : key.strides[1] * S;
  key.box_rows = T;
  return key;
}

bool tma_ok(const MapKey& key) {
  if ((key.dims[0] * key.es) % 16 || !aligned(key.base, 16)) return false;
  for (int i = 0; i < 3; ++i)
    if (key.strides[i] % 16 || key.strides[i] >= (1ULL << 40)) return false;
  return key.dims[2] >= 1;
}

int encode(const MapKey& key, CUtensorMap* map) {
  const EncodeFn fn = encode_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(key.dims[0]), 1u,
                             static_cast<cuuint32_t>(key.box_rows), 1u};
  const cuuint32_t elem_strides[4] = {1u, 1u, 1u, 1u};
  const CUresult r = fn(map, key.es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                         : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                        4, const_cast<void*>(key.base), key.dims, key.strides, box, elem_strides,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launch plan (host only; `stream` unused).  out[0] = n_split, the number
// of S splits per row (at least one, at most one per tile of keys), from
// the card's resident block slots of the route's kernel; out[1] = chunk,
// keys per split, a whole number of tiles, with n_split * chunk >= S;
// out[2] = T, keys per tile; out[3] = ring stages; out[4] = dynamic
// shared memory per block.
extern "C" int repro_flash_decode_plan(int BH, int S, int Q, int d, int kv_bf16, int tma, int* out,
                                       void* stream) {
  (void)stream;
  if (BH < 1 || S < 0 || !shape_ok(Q, d, kv_bf16)) return static_cast<int>(cudaErrorInvalidValue);
  Kernel kern;
  int rc = kernel_for(Q, d, kv_bf16, tma, &kern);
  if (rc != 0) return rc;
  int dev = 0, sms = 0, per_sm = 0;
  if ((rc = static_cast<int>(cudaGetDevice(&dev))) != 0) return rc;
  if ((rc = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))))
    return rc;
  if ((rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern.fn, kern.threads, kern.smem_bytes))))
    return rc;
  const long long slots = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  const long long tiles = (static_cast<long long>(S) + kern.T - 1) / kern.T;
  out[2] = kern.T;
  out[3] = kern.stages;
  out[4] = kern.smem_bytes;
  // one wave of equal blocks where the rows leave room for four or more
  // splits each (long_500k: BH = 5); else four waves or more, so that the
  // last wave's share of ragged rows stays small (decode_32k: BH = 160)
  long long n_split = slots / BH;
  if (n_split < 4) n_split = (4 * slots + BH - 1) / BH;
  if (n_split > tiles) n_split = tiles;
  if (n_split > 65535) n_split = 65535;
  if (n_split < 1) n_split = 1;
  const long long per = (tiles + n_split - 1) / n_split;  // tiles per split
  const long long chunk = per > 0 ? per * kern.T : kern.T;
  n_split = S > 0 ? (S + chunk - 1) / chunk : 1;
  out[0] = static_cast<int>(n_split);
  out[1] = static_cast<int>(chunk);
  return static_cast<int>(cudaSuccess);
}

// Host cost of a K or V tensor map (host only; `stream` unused): out[0] =
// mean ns of `reps` cuTensorMapEncodeTiled calls.  Strides in elements.
extern "C" int repro_flash_tma_map_ns(const void* base, int kv_bf16, int d, int n_kv, int S, int B,
                                      long long sb, long long ss, long long sh, int T, int reps,
                                      double* out, void* stream) {
  (void)stream;
  const MapKey key = map_key(base, kv_bf16 ? 2 : 4, d, n_kv, S, B, sb, ss, sh, T);
  if (!tma_ok(key) || reps < 1) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  using clock = std::chrono::steady_clock;
  auto t0 = clock::now();
  for (int i = 0; i < reps; ++i) {
    const int rc = encode(key, &map);
    if (rc != 0) return rc;
  }
  out[0] = std::chrono::duration<double, std::nano>(clock::now() - t0).count() / reps;
  return 0;
}

// Plain C entry point (bound with ctypes); one launch on `stream`, returns
// cudaGetLastError().
//   q        (B * n_kv, Q, d) contiguous, float32 (q_bf16 = 0) or bf16 (1);
//   k, v     element (b, t, h, j) at b * sb + t * ss + h * sh + j (strides
//            in elements, each its own), float32 (kv_bf16 = 0) or bf16 (1);
//   lengths  int32 (B,): valid keys of batch row b (clamped to [0, S]);
//   out      (B * n_kv, Q, d) contiguous, q's dtype;
//   lse      float32 (B * n_kv, Q) contiguous, each query row's log-sum-exp,
//            or null (not written);
//   work     float32, B * n_kv * n_split * Q * (d + 2) (unused with one split);
//   counters uint32 (B * n_kv,), zero, left zero by the call;
//   n_split, chunk from repro_flash_decode_plan with the same route
//   (tma = 1: the TMA route, which needs 16-byte row bytes, used strides
//   and bases; tma = 0: the cp.async route).
extern "C" int repro_flash_decode(const void* q, int q_bf16, const void* k, const void* v,
                                  int kv_bf16, const int* lengths, void* out, float* lse,
                                  float* work,
                                  unsigned* counters, int B, int n_kv, int S, int Q, int d,
                                  long long ksb, long long kss, long long ksh, long long vsb,
                                  long long vss, long long vsh, int n_split, int chunk, int tma,
                                  void* stream) {
  const long long BH = static_cast<long long>(B) * n_kv;
  if (B < 0 || n_kv < 1 || S < 0 || !shape_ok(Q, d, kv_bf16) || BH > 0x7fffffffLL ||
      n_split < 1 || n_split > 65535 || chunk < 1 ||
      static_cast<long long>(n_split) * chunk < S)
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Kernel kern;
  int rc = kernel_for(Q, d, kv_bf16, tma, &kern);
  if (rc != 0) return rc;
  const int es = kv_bf16 ? 2 : 4;
  const float qscale = kLog2e / sqrtf(static_cast<float>(d));
  const dim3 grid(static_cast<unsigned>(BH), static_cast<unsigned>(n_split));
  if (tma) {
    if (chunk % kern.T) return static_cast<int>(cudaErrorInvalidValue);
    const MapKey kkey = map_key(k, es, d, n_kv, S, B, ksb, kss, ksh, kern.T);
    const MapKey vkey = map_key(v, es, d, n_kv, S, B, vsb, vss, vsh, kern.T);
    if (!tma_ok(kkey) || !tma_ok(vkey)) return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap kmap, vmap;  // encoded per call: about 0.1 us each, as cheap as a lookup
    if ((rc = encode(kkey, &kmap)) != 0) return rc;
    if ((rc = encode(vkey, &vmap)) != 0) return rc;
    const TmaFn fn = reinterpret_cast<TmaFn>(const_cast<void*>(kern.fn));
    fn<<<grid, kern.threads, kern.smem_bytes, st>>>(kmap, vmap, q, q_bf16, lengths, work,
                                                    counters, out, lse, n_kv, S, Q, d, chunk,
                                                    qscale);
    return static_cast<int>(cudaGetLastError());
  }
  // the widest copy vector that every row start and row length allow
  int vec = 16;
  for (; vec >= 4; vec >>= 1) {
    const long long b = vec;
    if ((d * es) % b == 0 && (ksb * es) % b == 0 && (kss * es) % b == 0 && (ksh * es) % b == 0 &&
        (vsb * es) % b == 0 && (vss * es) % b == 0 && (vsh * es) % b == 0 && aligned(k, vec) &&
        aligned(v, vec))
      break;
  }
  if (vec < 4) return static_cast<int>(cudaErrorMisalignedAddress);
  const CpAsyncFn fn = reinterpret_cast<CpAsyncFn>(const_cast<void*>(kern.fn));
  fn<<<grid, kern.threads, kern.smem_bytes, st>>>(q, q_bf16, k, v, lengths, work, counters, out,
                                                  lse, n_kv, S, Q, d, ksb, kss, ksh, vsb, vss,
                                                  vsh, chunk, vec, qscale);
  return static_cast<int>(cudaGetLastError());
}
