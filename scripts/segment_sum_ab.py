#!/usr/bin/env python3
"""Side-by-side timing of segment-sum kernel designs on one GPU.

    mkdir -p build/old && git archive 10f5a20 src/repro_torch/kernels/csrc | tar -x -C build/old
    python3 scripts/segment_sum_ab.py --old build/old/src/repro_torch/kernels/csrc/segment_reduce.cu

Builds, with ``nvcc``, three libraries of the same C interface:
``new`` (``src/repro_torch/kernels/csrc/segment_reduce.cu`` as it is),
``fused`` (the same text with the carry fix-up run by the last block to
finish, elected by a tile counter it sets back to 0, instead of a second
launch; generated here by text substitution) and, with ``--old``, an
earlier ``segment_reduce.cu``, built with the ``chunk_decode.cuh`` beside
it (the current one where there is none).  A text older than commit
10f5a20 is the bounds-pass design, whose C entries take an int64[n_out +
1] bounds scratch in place of the carries (commit 08c8542's): pass
``--old-bounds`` with it.
Each is held against the plain version, then timed in turns (a, b, c,
c, b, a: ``ms`` per synchronised call and ``pipelined_ms`` back to back)
on the scale phase's raw lane (rMAT 2^22, 2^25 draws, padded to 2^26
slots; D = 1 and 8, plain and weighted) and on the adaptive chunked lane
of 128 rMAT communities of 2^15 vertices (D = 1 and 8), and the committed
design's two launches are split with ``torch.profiler``.  One JSON line
per workload; the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "segment_sum_ab"

FUSED_TAIL = r'''
template <int V>
__device__ void fused_tail(const int* ckey, const float* cval, float* out, unsigned* counter,
                           int N, int D, int n_out, int T) {
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (long long i = threadIdx.x / T; i <= N; i += kThreads / T) {
    const int k = i < N ? __ldcg(ckey + i) : n_out;
    const int kp = i > 0 ? __ldcg(ckey + i - 1) : -1;
    const bool starts = i < N && k >= 0 && k < n_out && (i == 0 || kp != k);
    Sink<V> o{out, D, n_out, 0, true, false, nullptr, nullptr, 0};
    for (o.col = (threadIdx.x & (T - 1)) * V; o.col < D; o.col += T * V) {
      if (i % 2 == 0) o.zeros(kp, k);
      if (!starts) continue;
      float acc[V];
      const float* vp = cval + i * D + o.col;
      for (int c = 0; c < V; ++c) acc[c] = __ldcg(vp + c);
      for (long long j = i + 1; j < N && __ldcg(ckey + j) == k; ++j) {
        vp += D;
        for (int c = 0; c < V; ++c) acc[c] += __ldcg(vp + c);
      }
      o.row(k, acc);
    }
  }
  if (threadIdx.x == 0) *counter = 0;
}
template <bool kWeighted, class Keys>
__global__ void __launch_bounds__(kThreads)
    tile_d1_kernel(Keys keys, const float* __restrict__ w, const float* __restrict__ msg,
                   float* __restrict__ out, int* __restrict__ ckey, float* __restrict__ cval,
                   long long E, int n_out, bool vec, unsigned* counter, int N) {
  tile_d1_body<kWeighted, Keys>(keys, w, msg, out, ckey, cval, E, n_out, vec);
  fused_tail<1>(ckey, cval, out, counter, N, 1, n_out, 1);
}
template <bool kWeighted, int V, class Keys>
__global__ void __launch_bounds__(kThreads)
    tile_cols_kernel(Keys keys, const float* __restrict__ w, const float* __restrict__ msg,
                     float* __restrict__ out, int* __restrict__ ckey, float* __restrict__ cval,
                     long long E, int D, int n_out, int T, bool vec, unsigned* counter, int N) {
  tile_cols_body<kWeighted, V, Keys>(keys, w, msg, out, ckey, cval, E, D, n_out, T, vec);
  fused_tail<V>(ckey, cval, out, counter, N, D, n_out, T);
}
'''


def fused_source(s: str) -> str:
    """The committed text with the fix-up in the last block: the scratch
    gains a 16-byte counter (zeroed by the caller) before the carries."""
    n = "counter, static_cast<int>(2 * tiles));"
    subs = [
        ("(keys, w, msg, out, ckey, cval, E, n_out, vec);",
         "(keys, w, msg, out, ckey, cval, E, n_out, vec, " + n, 1),
        ("(keys, w, msg, out, ckey, cval, E, D, n_out, T, vec);",
         "(keys, w, msg, out, ckey, cval, E, D, n_out, T, vec, " + n, 2),
        ("    const int err = static_cast<int>(cudaGetLastError());\n    if (err != 0) return err;\n"
         "  }\n  const int N",
         "    return static_cast<int>(cudaGetLastError());\n  }\n  const int N", 1),
        ("  int* ckey = static_cast<int*>(scratch);",
         "  unsigned* counter = static_cast<unsigned*>(scratch);\n"
         "  scratch = static_cast<char*>(scratch) + 16;\n  int* ckey = static_cast<int*>(scratch);", 1),
        ("template <bool kWeighted, class Keys>\n__global__ void __launch_bounds__(kThreads)\n"
         "    tile_d1_kernel(", "template <bool kWeighted, class Keys>\n__device__ void tile_d1_body(", 1),
        ("template <bool kWeighted, int V, class Keys>\n__global__ void __launch_bounds__(kThreads)\n"
         "    tile_cols_kernel(",
         "template <bool kWeighted, int V, class Keys>\n__device__ void tile_cols_body(", 1),
        ("// The fix-up: a thread per carry", FUSED_TAIL + "\n// The fix-up: a thread per carry", 1),
    ]
    for a, b, count in subs:
        if s.count(a) != count:
            raise RuntimeError(f"segment_reduce.cu changed: {a[:60]!r} found {s.count(a)} times")
        s = s.replace(a, b)
    return s


def build(args) -> dict:
    from repro_torch.kernels import _build

    srcs = {"new": (CSRC / "segment_reduce.cu").read_text()}
    srcs["fused"] = fused_source(srcs["new"])
    if args.old:
        srcs["old"] = Path(args.old).read_text()
    procs = {}
    for name, text in srcs.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "segment_reduce.cu").write_text(text)
        # an older text is built with the header beside it, where there is one
        header = Path(args.old).parent if name == "old" else CSRC
        if not (header / "chunk_decode.cuh").is_file():
            header = CSRC
        (d / "chunk_decode.cuh").write_text((header / "chunk_decode.cuh").read_text())
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "segment_reduce.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(OUT / name / "lib.so"))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", help="an earlier segment_reduce.cu to time beside")
    ap.add_argument("--old-bounds", action="store_true",
                    help="the --old text takes a bounds scratch (commits before 10f5a20)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("segment_sum_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core import compressed as cz
    from repro_torch.kernels import delta_decode as dd
    from repro_torch.kernels import segment_reduce as sr

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    libs = build(args)
    cs.emit({"build_s": time.perf_counter() - t0, "variants": list(libs)})
    dev = torch.device("cuda")
    P, I, LL = (lambda t: ctypes.c_void_p(t.data_ptr())), ctypes.c_int, ctypes.c_longlong
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)  # noqa: E731
    n, E = 2**22, 2**26

    def scratch(kind, slots, D):
        if kind == "old" and args.old_bounds:
            return torch.empty(n + 1, dtype=torch.int64, device=dev)
        tiles = -(-slots // sr.TILE)
        return torch.zeros(16 + -(-8 * tiles // 16) * 16 + 8 * tiles * D, dtype=torch.uint8,
                           device=dev)

    def timed(label, fns, want, extra=None):
        for k, f in fns.items():
            cs.check_close(f().clone(), want, f"{label} {k}")
        order = list(fns) + list(fns)[::-1]
        res = {k: {"ms": [], "pipelined_ms": []} for k in fns}
        for k in order:
            res[k]["ms"].append(cs.time_ms(fns[k]))
            res[k]["pipelined_ms"].append(cs.time_ms_pipelined(fns[k]))
        prof = {}
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as p:
            for _ in range(10):
                fns["new"]()
            torch.cuda.synchronize()
        for ev in p.key_averages():
            us = getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
            name = re.search(r"(\w+_kernel)", ev.key)
            if us and name:
                prof[name.group(1)] = us / ev.count
        cs.emit({"workload": label, **res, **(extra or {}), "new_kernel_us": prof})

    # the raw lane of the scale phase
    keys = cs.rmat_keys_device(22, 2**25, seed=2)
    dst = torch.sort((keys & 0xFFFFFFFF).to(torch.int32)).values
    del keys
    m = dst.numel()
    dst = torch.cat([dst, torch.full((E - m,), n, dtype=torch.int32, device=dev)])
    w = torch.rand(E, device=dev) * (dst < n)
    for D in (1, 8):
        src = torch.randint(0, n, (E,), device=dev)
        msg = torch.rand((D, n), device=dev)[:, src].T.contiguous() * (dst < n)[:, None]
        del src
        for weighted in (False, True):
            fns = {}
            for k, lib in libs.items():
                out, sc = torch.empty((n, D), device=dev), scratch(k, E, D)
                if weighted:
                    fn = lib.repro_segment_sum_weighted_sorted
                    fns[k] = (lambda fn=fn, out=out, sc=sc: (fn(
                        P(dst), P(w), P(msg), P(out), P(sc), LL(E), I(D), I(n), stream()), out)[1])
                else:
                    fn = lib.repro_segment_sum_sorted
                    fns[k] = (lambda fn=fn, out=out, sc=sc: (fn(
                        P(dst), P(msg), P(out), P(sc), LL(E), I(D), I(n), stream()), out)[1])
            want = (sr.segment_sum_weighted_sorted_plain(dst, w, msg, n) if weighted
                    else sr.segment_sum_sorted_plain(dst, msg, n))
            timed(f"raw_scale_D{D}_{'weighted' if weighted else 'plain'}", fns, want,
                  {"E": E, "E_valid": m})
        del msg
    del dst, w
    torch.cuda.empty_cache()

    # the adaptive chunked lane of compressed_scale's communities
    keys = cs.rmat_keys_device(15, 2**25, seed=4, communities=128)
    lane = torch.sort((keys & 0xFFFFFFFF).to(torch.int32)).values
    del keys
    m = lane.numel()
    lane = torch.cat([lane, torch.full((E - m,), n, dtype=torch.int32, device=dev)])
    hi_cap = int(cz.encode_stream_adaptive(lane, hi_cap=E // cz.CHUNK).wide.sum()) + 3
    s = cz.encode_stream_adaptive(lane, hi_cap=hi_cap)
    del lane
    R, K = s.ovf_pos.shape
    hi_row = dd.hi_rows(s.wide, s.hi.shape[0])
    for D in (1, 8):
        msg = torch.rand((R * cz.CHUNK, D), device=dev)
        fns = {}
        for k, lib in libs.items():
            out, sc = torch.empty((n, D), device=dev), scratch(k, R * cz.CHUNK, D)
            fn = lib.repro_segment_sum_sorted_chunked_adaptive
            fns[k] = (lambda fn=fn, out=out, sc=sc: (fn(
                P(s.anchors), P(s.deltas), P(s.hi), P(s.wide), P(hi_row), I(s.hi.shape[0]),
                P(s.ovf_pos), P(s.ovf_add), P(msg), P(out), P(sc), LL(R), I(K), I(D), I(n),
                stream()), out)[1])
        want = sr.segment_sum_sorted_chunked_plain(s.anchors, s.deltas, s.ovf_pos, s.ovf_add,
                                                   msg, n, s.hi, s.wide)
        timed(f"adaptive_chunked_D{D}", fns, want,
              {"R": R, "E_valid": m, "stream_bytes": cz.stream_nbytes(s)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
