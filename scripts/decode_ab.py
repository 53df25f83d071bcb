#!/usr/bin/env python3
"""Side-by-side timing of chunk-decode kernel designs on one GPU.

    mkdir -p build/old && git archive 10f5a20 src/repro_torch/kernels/csrc | tar -x -C build/old
    python3 scripts/decode_ab.py --old build/old/src/repro_torch/kernels/csrc

Builds, with ``nvcc``, libraries of ``src/repro_torch/kernels/csrc/
delta_decode.cu`` and variants of it made here by text substitution:

- ``new``: the committed text (the adaptive form in two launches: a
  pre-pass finds each tile's first hi row by a decoupled look-back over
  the wide tags, then the decode, a tile a block);
- ``one_launch``: the look-back inside the decode, one launch: as many
  blocks as fit at once take runs of tiles in ticket order, look back
  once and decode their runs;
- ``per_tile``: the same with a block, a ticket and a look-back per
  32-row tile;
- ``prepass1``: a pre-pass of one block of 1024 threads that counts and
  scans every tile's tags in rounds, with no look-back;
- ``rows2``, ``rows8``: 2 or 8 rows a warp instead of the committed 4
  (``rows2`` with 512-thread blocks, so a tile still holds 32 rows);
- ``stream_store``: a streaming 16-byte store (``st.global.cs``) in place
  of the ordinary one;
- with ``--old``, a directory holding an earlier ``delta_decode.cu`` and
  its ``chunk_decode.cuh`` whose adaptive entry takes an int32[R] hi-row
  index, built per call as that design's wrapper did (``hi_rows``).

Each is held against the plain version (exactly, twice), then timed in
turns (a, b, ..., b, a: ``ms`` per synchronised call, ``pipelined_ms``
back to back) on ``chip_smoke.py``'s ``compressed_scale`` lanes: the
adaptive and int16 ``srcbd_c`` lanes of 128 rMAT communities of 2^15
vertices.  The committed wrapper (``delta_decode.delta_decode_chunked
_adaptive``) is timed too, and ``torch.profiler`` gives each variant's
device time per call by kernel.  One JSON line per lane, after the
registers of each variant's kernels; the card's name and power limit
first.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "decode_ab"

PREPASS = r'''
// The tags of every tile counted and scanned by one block: tile_prefix[t]
// = wide chunks in tiles 0 .. t - 1.  A round gives each thread 4
// consecutive tiles (a warp reads contiguous bytes; bool bytes are 0 or 1,
// so a word's popcount counts its set tags), then scans the threads'
// counts across the block and carries the total to the next round.
constexpr int kPreThreads = 1024;
constexpr int kPreTiles = 4;
__global__ void __launch_bounds__(kPreThreads)
    prepass_kernel(const unsigned char* __restrict__ wide, long long R,
                   unsigned* __restrict__ tile_prefix, unsigned n_tiles) {
  __shared__ unsigned s_warp[32], s_total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned carry = 0;
  for (unsigned base = 0; base < n_tiles; base += kPreThreads * kPreTiles) {
    unsigned c[kPreTiles];
#pragma unroll
    for (int u = 0; u < kPreTiles; ++u) {
      const long long r0 =
          static_cast<long long>(base + threadIdx.x * kPreTiles + u) * kTileRows;
      unsigned n = 0;
#pragma unroll
      for (int i = 0; i < kTileRows; i += 16) {
        if (r0 + i + 16 <= R) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(wide + r0 + i));
          n += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
        } else {
          for (long long r = r0 + i; r < R && r < r0 + i + 16; ++r) n += wide[r] != 0;
        }
      }
      c[u] = n;
    }
    unsigned mine = 0;
#pragma unroll
    for (int u = 0; u < kPreTiles; ++u) mine += c[u];
    unsigned incl = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const unsigned w = s_warp[lane];
      unsigned wi = w;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned v = __shfl_up_sync(kFull, wi, off);
        if (lane >= off) wi += v;
      }
      s_warp[lane] = wi - w;
      if (lane == 31) s_total = wi;
    }
    __syncthreads();
    unsigned run = carry + s_warp[warp] + incl - mine;
#pragma unroll
    for (int u = 0; u < kPreTiles; ++u) {
      const unsigned t = base + threadIdx.x * kPreTiles + u;
      if (t < n_tiles) tile_prefix[t] = run;
      run += c[u];
    }
    carry += s_total;
    __syncthreads();  // s_warp and s_total are rewritten next round
  }
}

'''

ONE_LAUNCH = r'''
constexpr int kRunTiles = 256;  // tiles whose tags a block holds at a time

// One launch: a block takes, in ticket order, a run of per_block tiles,
// counts the run's wide tags, publishes the count and looks back for the
// wide chunks before it (warp 0), then decodes the run kRunTiles tiles at
// a time: the tiles' tags go to shared memory with, for each tile, the
// wide chunks before it, and then each warp walks its rows of those tiles
// with no barrier between tiles.
__global__ void __launch_bounds__(kThreads)
    adaptive_decode_kernel(ChunkedLane c, int* __restrict__ out, LookBack lb,
                           unsigned per_block) {
  __shared__ unsigned s_block, s_run;
  __shared__ unsigned s_count[kWarps];
  __shared__ unsigned s_tags[kRunTiles * kTagWords];
  __shared__ unsigned s_before[kRunTiles];  // wide chunks before each tile
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_block = take_ticket(lb);
  __syncthreads();
  const unsigned b = s_block;
  const long long n_tiles = (c.R + kTileRows - 1) / kTileRows;
  const long long t0 = min(static_cast<long long>(b) * per_block, n_tiles);
  const long long t1 = min(t0 + per_block, n_tiles);
  const long long r_end = min(t1 * kTileRows, c.R);
  unsigned mine = 0u;  // the run's wide tags, 4 loads a thread in flight at a time
  for (long long r = t0 * kTileRows + threadIdx.x; r < r_end; r += 4 * kThreads) {
    unsigned char w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) w[u] = r + u * kThreads < r_end ? c.wide[r + u * kThreads] : 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) mine += w[u] != 0;
  }
  mine = __reduce_add_sync(kFull, mine);
  if (lane == 0) s_count[warp] = mine;
  __syncthreads();
  if (warp == 0) {
    unsigned agg = 0u;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) agg += s_count[k];
    const unsigned p = look_back(lb, b, agg, lane);
    if (lane == 0) s_run = p;
  }
  for (long long ta = t0; ta < t1; ta += kRunTiles) {
    const int n = static_cast<int>(min(static_cast<long long>(kRunTiles), t1 - ta));
    for (int k = warp; k < n; k += kWarps) {  // the tags, a ballot a word
#pragma unroll
      for (int g = 0; g < kTagWords; ++g) {
        const long long r = (ta + k) * kTileRows + g * 32 + lane;
        const unsigned m = __ballot_sync(kFull, r < c.R && c.wide[r] != 0);
        if (lane == 0) s_tags[k * kTagWords + g] = m;
      }
    }
    __syncthreads();  // the tags, and on the first pass the look-back's prefix
    if (warp == 0) {  // wide chunks before each tile: lane l scans tiles 8l .. 8l + 7
      constexpr int kPer = kRunTiles / 32;
      unsigned cnt[kPer], sum = 0u;
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int k = lane * kPer + u;
        cnt[u] = 0u;
#pragma unroll
        for (int g = 0; g < kTagWords; ++g) cnt[u] += k < n ? __popc(s_tags[k * kTagWords + g]) : 0u;
        sum += cnt[u];
      }
      unsigned incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned v = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += v;
      }
      unsigned before = s_run + incl - sum;
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        s_before[lane * kPer + u] = before;
        before += cnt[u];
      }
      __syncwarp();
      if (lane == 31) s_run = before;  // the wide chunks before the next pass
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const long long row0 = (ta + k) * kTileRows;
      RowLoads x[kRowsPerWarp];
      load_tile<1>(c, row0, warp, lane, x);
      finish_tile<1, true>(c, out, row0, x, s_tags + k * kTagWords, s_before[k], warp, lane);
    }
    __syncthreads();  // the next pass rewrites the tags
  }
}


// Blocks of adaptive_decode_kernel that fit on the device at once (the
// look-back needs no more than run together), found once per device.
int resident_blocks() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, adaptive_decode_kernel, kThreads,
                                                      0) != cudaSuccess) {
      return 0;
    }
    cached[dev] = sms * per_sm;
  }
  return cached[dev];
}

'''


def variants(text: str) -> dict[str, str]:
    """name -> source text; raises if a substituted line moved."""

    def sub(s, pairs):
        for a, b in pairs:
            if s.count(a) != 1:
                raise RuntimeError(f"delta_decode.cu changed: {a[:60]!r} found {s.count(a)} times")
            s = s.replace(a, b)
        return s

    rows = "constexpr int kRowsPerWarp = 4;"
    threads = "constexpr int kThreads = 256;"
    two = ("    const unsigned blocks = static_cast<unsigned>((n_tiles + kPrefixThreads - 1) / "
           "kPrefixThreads);\n")
    launch = "    tile_prefix_kernel<<<blocks, kPrefixThreads, 0, s>>>(c, lb, prefix, n_tiles);\n"
    one_launch = [
        ("int launch_chunked(", ONE_LAUNCH + "int launch_chunked("),
        (two, "    const int resident = resident_blocks();\n"
              "    if (resident <= 0) return static_cast<int>(cudaErrorInvalidValue);\n"
              "    const long long per_block = (n_tiles + resident - 1) / resident;\n"
              "    const unsigned blocks = static_cast<unsigned>((n_tiles + per_block - 1) / "
              "per_block);\n"),
        (launch + "    const int err = static_cast<int>(cudaGetLastError());\n"
                  "    if (err != 0) return err;\n"
                  "    chunked_decode_kernel<1, true><<<grid, kThreads, 0, s>>>(c, out, prefix);\n",
         "    adaptive_decode_kernel<<<blocks, kThreads, 0, s>>>(c, out, lb, "
         "static_cast<unsigned>(per_block));\n"),
    ]
    return {
        "new": text,
        "one_launch": sub(text, one_launch),
        "per_tile": sub(sub(text, one_launch), [
            ("    const long long per_block = (n_tiles + resident - 1) / resident;",
             "    const long long per_block = 1;")]),
        "prepass1": sub(text, [
            ("int launch_chunked(", PREPASS + "int launch_chunked("),
            (launch, "    prepass_kernel<<<1, kPreThreads, 0, s>>>(c.wide, c.R, prefix, "
                     "static_cast<unsigned>(n_tiles));\n")]),
        "rows2": sub(text, [(rows, "constexpr int kRowsPerWarp = 2;"),  # 16 warps: 32-row tiles
                            (threads, "constexpr int kThreads = 512;")]),
        "rows8": sub(text, [(rows, "constexpr int kRowsPerWarp = 8;")]),
        "stream_store": sub(text, [("  *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);",
                                    "  __stcs(reinterpret_cast<int4*>(p), make_int4(v[0], v[1], v[2], "
                                    "v[3]));")]),
    }


def build(old: str | None) -> dict:
    from repro_torch.kernels import _build

    dirs = {}
    for name, text in variants((CSRC / "delta_decode.cu").read_text()).items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "delta_decode.cu").write_text(text)
        (d / "chunk_decode.cuh").write_text((CSRC / "chunk_decode.cuh").read_text())
        dirs[name] = d
    if old:
        dirs["old"] = Path(old)
    procs = {}
    for name, d in dirs.items():
        lib = OUT / f"lib{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(d / "delta_decode.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs, logs = {}, {}
    for name, (p, lib) in procs.items():
        logs[name], _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{logs[name]}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs, logs


def lanes(cs):
    """compressed_scale's srcbd_c lanes: {"adaptive": s, "fixed2": s}."""
    from repro_torch.core import flat_graph as fg
    from repro_torch.core.traversal import torch_backend as tb

    n = 128 << 15
    edges = cs.rmat_symmetric_device(15, 2**25, seed=4, communities=128)
    g = fg.from_edges(n, edges, device="cuda")
    del edges
    out = {}
    for name, kw in (("adaptive", {}), ("fixed2", {"width": 2})):
        out[name] = tb.CompressedEngine(fg.compress_host(g, **kw)).caux.srcbd_c
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", help="a directory with an earlier delta_decode.cu and its header")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("decode_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core import compressed as cz
    from repro_torch.kernels import delta_decode as dd

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    libs, logs = build(args.old)
    cs.emit({"build_s": time.perf_counter() - t0,
             "registers": {k: cs.ptxas_summary({"log": v}) for k, v in logs.items()}})
    t0 = time.perf_counter()
    streams = lanes(cs)
    cs.emit({"lanes_s": time.perf_counter() - t0})
    P, I, LL = (lambda t: ctypes.c_void_p(t.data_ptr())), ctypes.c_int, ctypes.c_longlong
    raw_stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)  # noqa: E731

    for layout, s in streams.items():
        R, K = s.ovf_pos.shape
        a, d, p, v = s.anchors, s.deltas, s.ovf_pos, s.ovf_add
        adaptive = s.hi is not None
        fns = {}
        if adaptive:
            fns["wrapper"] = lambda: dd.delta_decode_chunked_adaptive(a, d, s.hi, s.wide, p, v)
            want = dd.delta_decode_chunked_adaptive_plain(a, d, s.hi, s.wide, p, v)
        else:
            fns["wrapper"] = lambda: dd.delta_decode_chunked(a, d, p, v)
            want = dd.delta_decode_chunked_plain(a, d, p, v)
        for name, lib in libs.items():
            out = torch.empty((R, cz.CHUNK), dtype=torch.int32, device="cuda")
            if not adaptive:
                fn = lib.repro_delta_decode_chunked
                fns[name] = (lambda fn=fn, out=out: (fn(
                    P(a), P(d), I(2), P(p), P(v), P(out), LL(R), I(K), raw_stream()), out)[1])
            elif name == "old":
                def call(fn=lib.repro_delta_decode_chunked_adaptive, out=out):
                    hi_row = dd.hi_rows(s.wide, s.hi.shape[0])  # per call, as that wrapper did
                    rc = fn(P(a), P(d), P(s.hi), P(s.wide), P(hi_row), I(s.hi.shape[0]), P(p),
                            P(v), P(out), LL(R), I(K), raw_stream())
                    if rc:
                        raise RuntimeError(f"cudaError {rc}")
                    return out
                fns[name] = call
            else:
                fn = lib.repro_delta_decode_chunked_adaptive
                lb = torch.zeros(16 + 12 * R, dtype=torch.uint8, device="cuda")  # any tiling
                epoch = [0]

                def call(fn=fn, out=out, lb=lb, epoch=epoch):
                    epoch[0] += 1
                    rc = fn(P(a), P(d), P(s.hi), P(s.wide), I(s.hi.shape[0]), P(p), P(v),
                            P(out), LL(R), I(K), P(lb), ctypes.c_uint(epoch[0]), raw_stream())
                    if rc:
                        raise RuntimeError(f"cudaError {rc}")
                    return out
                fns[name] = call
        for name, fn in fns.items():
            for _ in range(2):  # the same bits twice
                if not torch.equal(fn(), want):
                    raise AssertionError(f"decode_ab {layout}: {name} differs from the plain version")
        res = {k: {"ms": [], "pipelined_ms": []} for k in fns}
        for k in list(fns) + list(fns)[::-1]:
            res[k]["ms"].append(cs.time_ms(fns[k]))
            res[k]["pipelined_ms"].append(cs.time_ms_pipelined(fns[k]))
        device_us = {}
        for k, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
            device_us[k] = {ev.key[:60]: cs.device_us(ev) / 20 for ev in prof.key_averages()
                            if cs.device_us(ev) > 0}
        bound_ms, _ = cs.chunked_decode_bound(s)
        cs.emit({"lane": layout, "R": R, "K": K,
                 "wide": 0 if s.wide is None else int(s.wide.sum()),
                 "bound_ms": bound_ms, "rows_per_warp": dd.chunked_plan()["rows_per_warp"],
                 **res, "device_us_per_call": device_us})
    return 0


if __name__ == "__main__":
    sys.exit(main())
