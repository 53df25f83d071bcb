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
// Design.  Blocks run in parallel and in no order here, and long_500k has
// only BH = 5 rows, so S is split across blocks (FlashDecoding):
//   * Pass 1 (flash_split_kernel): grid (BH, n_split), 256 threads.  Block
//     (bh, s) takes keys [s * chunk, min((s + 1) * chunk, length)).  It
//     stages tiles of T keys of K and V through shared memory with
//     cp.async (16-byte vectors where the row bytes, strides and pointers
//     allow, else 8 or 4), two stages deep, so one tile is in flight while
//     the other is used.  A group of G lanes owns one key at a time, each
//     lane 8 head dims (G = pow2(ceil(d / 8)) <= 32); the lanes' partial
//     dots meet in a shuffle butterfly.  Each group carries its own online
//     softmax (m, l, acc[Q][8]) in float32 registers over KB keys at a
//     time, in base 2 (q is pre-scaled by log2(e) / sqrt(d)).  At the end
//     the groups merge by shuffles inside a warp and through shared memory
//     across warps, in a fixed order, and the block writes one partial
//     (m, l, acc[Q][d]) into a float32 workspace.  A block whose range
//     lies past its length reads nothing and writes (-inf, 0, 0).
//   * Pass 2 (flash_combine_kernel): one thread per output element merges
//     the n_split partials of its row and writes acc / max(l, 1e-30) in
//     q's dtype.
//   * The cache is read where it lies, through (batch, position, head)
//     strides: attention_decode passes one layer's (B, S_max, n_kv, d)
//     slice with no transpose (the reference copies the whole cache to
//     (B * n_kv, S_max, d) every step, repro/models/layers.py:250-252).
//     Lengths are per batch row; any S, no padding.
//   * float32 FMAs throughout, no tensor cores (no TF32).  q may be f32 or
//     bf16 independently of the cache (the reference's generate pairs an
//     f32 model with its bf16 cache); K and V share one dtype.
//   * n_split is sized by repro_flash_decode_plan from the card's resident
//     block slots (two blocks per SM at smollm's shapes): one wave when a
//     row can take four splits or more, else four waves or more.
//
// Bound: memory.  The function must read the valid K and V rows once,
// 2 * BH * length * d * elem bytes, against 4 * Q flops per cached
// element (a multiply-add for the score and one for the output): Q / elem
// FMAs per byte, far below the f32 ridge of the card (67 TFLOP/s over
// 3.35 TB/s), so HBM bandwidth bounds it.  At smollm-360m's long_500k
// (BH = 5, S = 524,288, d = 64, bf16) that is 671 MB, 0.200 ms per layer.
// The partials add 4 * BH * n_split * Q * (d + 2) bytes each way.
//
// Known limits, left for later work: no wgmma or TMA (the work is far
// below the ridge); Q is rounded up to a compiled bucket (1, 2, 3, 4, 8,
// 16), so Q = 9 does the work of 16; n_split is a fixed rule, not tuned.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kE = 8;  // head dims per lane
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float neg_inf() { return __int_as_float(static_cast<int>(0xff800000u)); }

__device__ __forceinline__ float bf16_bits_to_float(unsigned short b) {
  return __uint_as_float(static_cast<unsigned>(b) << 16);
}

// 8 consecutive values from shared memory as float32.
__device__ __forceinline__ void load8(const float* p, float (&o)[kE]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void load8(const unsigned short* p, float (&o)[kE]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);  // 8 bf16, low half first
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void cp_async(void* smem, const void* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
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
  // two stages, q (qm x DP), per-warp m and l, the merged accumulator (qm x DP)
  g.smem_bytes = 2 * g.stage_bytes + 4 * (2 * qm * g.DP + 2 * kWarps * qm);
  return g;
}

template <typename TKV, int QM>
__global__ void __launch_bounds__(kThreads)
    flash_split_kernel(const void* __restrict__ q, int q_bf16, const void* __restrict__ k,
                       const void* __restrict__ v, const int* __restrict__ lengths,
                       float* __restrict__ work, int n_kv, int S, int Q, int d, long long ksb,
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

  float* ml_out = work + (static_cast<long long>(bh) * n_split + split) * Q * 2;
  float* acc_out = work + static_cast<long long>(BH) * n_split * Q * 2 +
                   (static_cast<long long>(bh) * n_split + split) * Q * d;
  if (n_tiles == 0) {  // nothing valid in this range: (-inf, 0, 0), no reads
    for (int i = threadIdx.x; i < Q * d; i += kThreads) acc_out[i] = 0.f;
    if (threadIdx.x < Q) {
      ml_out[2 * threadIdx.x] = neg_inf();
      ml_out[2 * threadIdx.x + 1] = 0.f;
    }
    return;
  }

  float* qs = reinterpret_cast<float*>(smem + 2 * geo.stage_bytes);  // [QM][DP]
  float* sm_acc = qs + QM * DP;                                       // [QM][DP]
  float* sm_m = sm_acc + QM * DP;                                     // [kWarps][QM]
  float* sm_l = sm_m + kWarps * QM;                                   // [kWarps][QM]

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

  issue(0);
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

  // merge the groups of a warp (lanes c, c + G, c + 2G, ... hold one chunk)
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
      for (int e = 0; e < kE; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[qq][e], off);
        acc[qq][e] = acc[qq][e] * a + ao * bb;
      }
      m[qq] = mn;
    }
  }
  // merge the warps through shared memory, in warp order
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
#pragma unroll
    for (int qq = 0; qq < QM; ++qq) {
      sm_m[warp * QM + qq] = m[qq];
      sm_l[warp * QM + qq] = l[qq];
    }
  }
  __syncthreads();
  float M[QM], L[QM], f[QM];
#pragma unroll
  for (int qq = 0; qq < QM; ++qq) {
    float mx = neg_inf();
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * QM + qq]);
    const float ms = mx == neg_inf() ? 0.f : mx;
    float lsum = 0.f;
    for (int w = 0; w < kWarps; ++w) lsum += sm_l[w * QM + qq] * exp2f(sm_m[w * QM + qq] - ms);
    M[qq] = mx;
    L[qq] = lsum;
    f[qq] = exp2f(m[qq] - ms);
  }
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w && lane < G && lane_live) {
#pragma unroll
      for (int qq = 0; qq < QM; ++qq) {
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const int at = qq * DP + c * kE + e;
          const float x = acc[qq][e] * f[qq];
          sm_acc[at] = w == 0 ? x : sm_acc[at] + x;
        }
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < Q * d; i += kThreads) acc_out[i] = sm_acc[(i / d) * DP + i % d];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int qq = 0; qq < QM; ++qq) {
      if (qq < Q) {
        ml_out[2 * qq] = M[qq];
        ml_out[2 * qq + 1] = L[qq];
      }
    }
  }
}

template <typename TO>
__device__ __forceinline__ void store_out(TO* p, float x);
template <>
__device__ __forceinline__ void store_out<float>(float* p, float x) { *p = x; }
template <>
__device__ __forceinline__ void store_out<unsigned short>(unsigned short* p, float x) {
  *p = __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

template <typename TO>
__global__ void __launch_bounds__(128)
    flash_combine_kernel(const float* __restrict__ work, void* __restrict__ out, int n_split,
                         int Q, int d) {
  const int bh = blockIdx.x, BH = gridDim.x;
  const int i = blockIdx.y * blockDim.x + threadIdx.x;
  if (i >= Q * d) return;
  const int qr = i / d;
  const float* ml = work + static_cast<long long>(bh) * n_split * Q * 2;
  const float* acc = work + static_cast<long long>(BH) * n_split * Q * 2 +
                     static_cast<long long>(bh) * n_split * Q * d;
  float M = neg_inf();
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, ml[(s * Q + qr) * 2]);
  const float ms = M == neg_inf() ? 0.f : M;
  float L = 0.f, A = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float fs = exp2f(ml[(s * Q + qr) * 2] - ms);
    L += ml[(s * Q + qr) * 2 + 1] * fs;
    A += acc[static_cast<long long>(s) * Q * d + i] * fs;
  }
  store_out<TO>(static_cast<TO*>(out) + static_cast<long long>(bh) * Q * d + i,
                A / fmaxf(L, 1e-30f));
}

using SplitFn = void (*)(const void*, int, const void*, const void*, const int*, float*, int,
                         int, int, int, long long, long long, long long, long long, long long,
                         long long, int, int, float);

int q_bucket(int Q) {
  if (Q <= 4) return Q;
  return Q <= 8 ? 8 : 16;
}

template <typename TKV>
SplitFn split_for(int qm) {
  switch (qm) {
    case 1: return flash_split_kernel<TKV, 1>;
    case 2: return flash_split_kernel<TKV, 2>;
    case 3: return flash_split_kernel<TKV, 3>;
    case 4: return flash_split_kernel<TKV, 4>;
    case 8: return flash_split_kernel<TKV, 8>;
    default: return flash_split_kernel<TKV, 16>;
  }
}

SplitFn split_fn(int kv_bf16, int qm) {
  return kv_bf16 ? split_for<unsigned short>(qm) : split_for<float>(qm);
}

bool shape_ok(int Q, int d, int kv_bf16) {
  return Q >= 1 && Q <= 16 && d >= 1 && d <= 256 && (d * (kv_bf16 ? 2 : 4)) % 4 == 0;
}

// Sets the kernel's shared-memory limit; returns its geometry.
int prepare(int Q, int d, int kv_bf16, SplitFn* fn, Geometry* geo) {
  const int qm = q_bucket(Q);
  *fn = split_fn(kv_bf16, qm);
  *geo = geometry(d, kv_bf16 ? 2 : 4, qm);
  return static_cast<int>(cudaFuncSetAttribute(
      reinterpret_cast<const void*>(*fn), cudaFuncAttributeMaxDynamicSharedMemorySize,
      geo->smem_bytes));
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<unsigned long long>(p) % bytes == 0;
}

}  // namespace

// Launch plan (host only; `stream` unused): out[0] = n_split, the number
// of S splits per row (at least one, at most one per tile of keys), from
// the card's resident block slots of the split kernel; out[1] = chunk,
// keys per split, a whole number of tiles, with n_split * chunk >= S.
extern "C" int repro_flash_decode_plan(int BH, int S, int Q, int d, int kv_bf16, int* out,
                                       void* stream) {
  (void)stream;
  if (BH < 1 || S < 0 || !shape_ok(Q, d, kv_bf16)) return static_cast<int>(cudaErrorInvalidValue);
  SplitFn fn;
  Geometry geo;
  int rc = prepare(Q, d, kv_bf16, &fn, &geo);
  if (rc != 0) return rc;
  int dev = 0, sms = 0, per_sm = 0;
  if ((rc = static_cast<int>(cudaGetDevice(&dev))) != 0) return rc;
  if ((rc = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))))
    return rc;
  if ((rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fn, kThreads, geo.smem_bytes))))
    return rc;
  const long long slots = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  const long long tiles = (static_cast<long long>(S) + geo.T - 1) / geo.T;
  // one wave of equal blocks where the rows leave room for four or more
  // splits each (long_500k: BH = 5); else four waves or more, so that the
  // last wave's share of ragged rows stays small (decode_32k: BH = 160)
  long long n_split = slots / BH;
  if (n_split < 4) n_split = (4 * slots + BH - 1) / BH;
  if (n_split > tiles) n_split = tiles;
  if (n_split > 65535) n_split = 65535;
  if (n_split < 1) n_split = 1;
  const long long per = (tiles + n_split - 1) / n_split;  // tiles per split
  const long long chunk = per > 0 ? per * geo.T : geo.T;
  n_split = S > 0 ? (S + chunk - 1) / chunk : 1;
  out[0] = static_cast<int>(n_split);
  out[1] = static_cast<int>(chunk);
  return static_cast<int>(cudaSuccess);
}

// Plain C entry point (bound with ctypes); launches both passes on
// `stream` and returns cudaGetLastError().
//   q        (B * n_kv, Q, d) contiguous, float32 (q_bf16 = 0) or bf16 (1);
//   k, v     element (b, t, h, j) at b * sb + t * ss + h * sh + j (strides
//            in elements, each its own), float32 (kv_bf16 = 0) or bf16 (1);
//   lengths  int32 (B,): valid keys of batch row b (clamped to [0, S]);
//   out      (B * n_kv, Q, d) contiguous, q's dtype;
//   work     float32, B * n_kv * n_split * Q * (d + 2);
//   n_split, chunk from repro_flash_decode_plan (n_split * chunk >= S).
extern "C" int repro_flash_decode(const void* q, int q_bf16, const void* k, const void* v,
                                  int kv_bf16, const int* lengths, void* out, float* work, int B,
                                  int n_kv, int S, int Q, int d, long long ksb, long long kss,
                                  long long ksh, long long vsb, long long vss, long long vsh,
                                  int n_split, int chunk, void* stream) {
  const long long BH = static_cast<long long>(B) * n_kv;
  if (B < 0 || n_kv < 1 || S < 0 || !shape_ok(Q, d, kv_bf16) || BH > 0x7fffffffLL ||
      n_split < 1 || n_split > 65535 || chunk < 1 ||
      static_cast<long long>(n_split) * chunk < S)
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  SplitFn fn;
  Geometry geo;
  int rc = prepare(Q, d, kv_bf16, &fn, &geo);
  if (rc != 0) return rc;
  // the widest copy vector that every row start and row length allow
  const int es = kv_bf16 ? 2 : 4;
  int vec = 16;
  for (; vec >= 4; vec >>= 1) {
    const long long b = vec;
    if ((d * es) % b == 0 && (ksb * es) % b == 0 && (kss * es) % b == 0 && (ksh * es) % b == 0 &&
        (vsb * es) % b == 0 && (vss * es) % b == 0 && (vsh * es) % b == 0 && aligned(k, vec) &&
        aligned(v, vec))
      break;
  }
  if (vec < 4) return static_cast<int>(cudaErrorMisalignedAddress);
  const float qscale = kLog2e / sqrtf(static_cast<float>(d));
  fn<<<dim3(static_cast<unsigned>(BH), static_cast<unsigned>(n_split)), kThreads, geo.smem_bytes,
       st>>>(q, q_bf16, k, v, lengths, work, n_kv, S, Q, d, ksb, kss, ksh, vsb, vss, vsh, chunk,
             vec, qscale);
  if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
  const dim3 grid(static_cast<unsigned>(BH), static_cast<unsigned>((Q * d + 127) / 128));
  if (q_bf16) {
    flash_combine_kernel<unsigned short><<<grid, 128, 0, st>>>(work, out, n_split, Q, d);
  } else {
    flash_combine_kernel<float><<<grid, 128, 0, st>>>(work, out, n_split, Q, d);
  }
  return static_cast<int>(cudaGetLastError());
}
