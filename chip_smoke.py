#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (into
``build/repro_torch_kernels/``), then drives the port's main path and
checks every result.  One JSON object per phase goes to stdout:

  env     the card as nvidia-smi reports it, versions, kernel build time;
  kernels each hand kernel against its plain PyTorch version on ragged
          shapes with out-of-range pad entries, D in {1, 8, 64}, timed
          against the plain version and the ``index_add_`` yardstick;
  stream  ``AspenStream`` (paper §7.3 setting) at 2^18 vertices: update
          batches through the host C-tree and the device mirror, queries
          held against the numpy engine on the same version after every
          publish, then ``run_concurrent``;
  scale   the device engine at soc-LiveJournal scale (2^22 vertices,
          ~66 M directed rMAT edges, drawn on the card) built straight
          into the device pool:
          engine_aux, PageRank, PageRank x8, BFS x16 (depths held against
          scipy), and each kernel against its plain version at these shapes.

Then the kernel summary line and, last, ``{"ok": true, "device": ...}``.
Any mismatch or exception ends the run with a nonzero exit and no ``ok``
line.  Without a GPU, or outside a checkout of the repo, it exits nonzero
before printing any result.  It imports nothing of JAX.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
# Stream-phase PageRank (float32, 10 rounds) against the numpy engine's
# float64, relative to each entry.
PR_RTOL = 1e-5

# H100 SXM data-sheet peaks (dense): HBM bandwidth and float32 rate
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int = 20) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def check_close(got, want, what: str) -> float:
    """Kernel vs plain version.  The plain version's ``index_add_`` uses
    atomics on the card, so its float32 summation order differs from the
    kernel's fixed order: held to rtol 1e-5 and atol 1e-6 * max|out|."""
    import torch

    atol = 1e-6 * max(float(want.abs().max()) if want.numel() else 0.0, 1e-30)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=atol, msg=lambda m: f"{what}: {m}")
    return float((got - want).abs().max()) if got.numel() else 0.0


def rmat_symmetric_device(log_n: int, n_draws: int, seed: int):
    """rMAT edges (a=0.5, b=c=0.1, d=0.3, paper §7.4) drawn on the card from
    a seeded generator, then symmetrized, deduplicated and stripped of
    self loops there: the semantics of ``repro_torch.data.rmat``'s
    ``symmetrize(rmat_edges(...))`` with the card's random stream.  At
    2^25 draws the numpy pair took 296.6 s on the H100 machine's host,
    a quarter of this script's time limit (PERF.md).  Returns a host
    (m, 2) int64 array, sorted by (src, dst)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    a, b, c = 0.5, 0.1, 0.1
    src = torch.zeros(n_draws, dtype=torch.int64, device="cuda")
    dst = torch.zeros_like(src)
    for _ in range(log_n):
        r = torch.rand(n_draws, generator=gen, device="cuda")
        src_bit = r >= a + b
        dst_bit = torch.where(src_bit, r >= a + b + c, r >= a)
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    keys = torch.cat([(src << 32) | dst, (dst << 32) | src])
    keys = torch.unique(keys)
    keys = keys[(keys >> 32) != (keys & 0xFFFFFFFF)]
    return torch.stack([keys >> 32, keys & 0xFFFFFFFF], 1).cpu().numpy()


def bound(e_valid: int, n_out: int, D: int, weighted: bool):
    """Least time (ms) for the work: each input read once, each output
    written once, over HBM; the adds (and multiplies) over the f32 peak."""
    nbytes = e_valid * (4 + 4 * D + (4 if weighted else 0)) + n_out * 4 * D
    flops = e_valid * D * (2 if weighted else 1)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_env(smi: str) -> None:
    import torch

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    emit({
        "phase": "env",
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0),
        "build_s": time.perf_counter() - t0,
        "nvcc_s": {k: v["seconds"] for k, v in _build.BUILD_INFO.items()},
    })


def _kernel_inputs(E: int, n_out: int, D: int, gen):
    import torch

    hi = n_out + max(1, n_out // 8)  # ~1/9 of entries are pads >= n_out
    dst = torch.sort(torch.randint(0, hi, (E,), generator=gen, device="cuda")).values
    msg = torch.randn((E, D), generator=gen, device="cuda")
    w = torch.rand((E,), generator=gen, device="cuda")
    return dst.to(torch.int32), msg, w


def phase_kernels() -> None:
    import torch

    from repro_torch.kernels import segment_reduce as sr

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for E, n_out in [(1, 1), (777, 130), (100_003, 9_973), (3_999_971, 262_139)]:
        for D in (1, 8, 64):
            dst, msg, w = _kernel_inputs(E, n_out, D, gen)
            idx = torch.where(dst < n_out, dst, n_out).long()
            ext = torch.zeros((n_out + 1, D), device="cuda")
            row = {"E": E, "n_out": n_out, "D": D}
            for name, kern, plain in (
                ("segment_sum", lambda: sr.segment_sum_sorted(dst, msg, n_out),
                 lambda: sr.segment_sum_sorted_plain(dst, msg, n_out)),
                ("segment_sum_weighted",
                 lambda: sr.segment_sum_weighted_sorted(dst, w, msg, n_out),
                 lambda: sr.segment_sum_weighted_sorted_plain(dst, w, msg, n_out)),
            ):
                row[f"{name}_max_abs_err"] = check_close(kern(), plain(), f"{name} E={E} D={D}")
                if E > 100_000:
                    row[f"{name}_ms"] = time_ms(kern)
                    row[f"{name}_plain_ms"] = time_ms(plain)
            if E > 100_000:
                row["index_add_ms"] = time_ms(lambda: ext.zero_().index_add_(0, idx, msg))
            rows.append(row)
    emit({"phase": "kernels", "tolerance": "rtol 1e-5, atol 1e-6*max|out|", "cases": rows})


def phase_stream() -> dict:
    import torch

    from repro_torch.core import graph as G
    from repro_torch.core import streaming as st
    from repro_torch.core.traversal import algorithms as talg
    from repro_torch.data.rmat import rmat_edges, symmetrize
    from repro_torch.kernels import segment_reduce as sr

    log_n, batch, n_batches = 18, 10_000, 4
    n = 2**log_n
    rng = np.random.default_rng(SEED)
    E0 = symmetrize(rmat_edges(log_n, 2_000_000, seed=1))
    base, updates = st.make_update_stream(E0, n_batches * batch + 20_000, seed=1)
    t0 = time.perf_counter()
    stream = st.AspenStream(G.build_graph(n, base), device="cuda")
    build_s = time.perf_counter() - t0

    lat = {"bfs": [], "pagerank": [], "sssp": []}
    publish_s = []
    checked = 0
    pr_rel_err = [0.0]

    def timed(kind, **kw):
        t = time.perf_counter()
        out = stream.query_batch(kind=kind, **kw)
        lat[kind].append(time.perf_counter() - t)
        return out

    def check_version(weighted: bool) -> None:
        nonlocal checked
        deg = stream.engine("numpy").degrees
        srcs = rng.choice(np.flatnonzero(deg > 0), 16, replace=False)
        resets = rng.random((8, n))
        resets /= resets.sum(1, keepdims=True)
        got = timed("bfs", sources=srcs)
        want = stream.query_batch(srcs, kind="bfs", backend="numpy")
        if not np.array_equal(got, want):
            raise AssertionError("stream: bfs parents differ from the numpy engine")
        got = timed("pagerank", resets=resets)
        want = stream.query_batch(kind="pagerank", backend="numpy", resets=resets)
        # float32 on the card against the numpy engine's float64: relative
        # to each entry (they average 1/n), with a floor for the smallest.
        atol = 1e-6 * float(np.abs(want).max())
        err = np.abs(got - want)
        pr_rel_err[0] = max(pr_rel_err[0], float((err / np.maximum(np.abs(want), atol)).max()))
        if not (np.all(np.isfinite(got)) and np.allclose(got, want, rtol=PR_RTOL, atol=atol)):
            raise AssertionError(f"stream: pagerank off by {err.max()} (rel {pr_rel_err[0]})")
        if weighted:
            got = timed("sssp", sources=srcs[:4])
            want = stream.query_batch(srcs[:4], kind="sssp", backend="numpy")
            if not np.array_equal(got, want):
                raise AssertionError("stream: sssp distances differ from the numpy engine")
        checked += 1

    def publish(fn, *args, **kw):
        t = time.perf_counter()
        fn(*args, **kw)
        torch.cuda.synchronize()
        publish_s.append(time.perf_counter() - t)

    sr.reset_launches()
    for b in range(n_batches):  # each batch: an insert publish, then a delete publish
        rows = updates[b * batch:(b + 1) * batch]
        publish(stream.insert_edges, rows[rows[:, 2] == 0, :2])
        check_version(weighted=False)
        publish(stream.delete_edges, rows[rows[:, 2] == 1, :2])
        check_version(weighted=False)
    wedges = updates[n_batches * batch:n_batches * batch + batch, :2]
    weights = rng.integers(1, 10, size=wedges.shape[0]).astype(np.float64)
    publish(stream.insert_edges, wedges, weights=weights)
    check_version(weighted=True)
    launches = dict(sr.LAUNCHES)
    if min(launches.values()) == 0:
        raise AssertionError(f"stream: a kernel was never launched: {launches}")
    kernel_err = stream_kernel_check(stream.engine("torch"))

    srcs = np.arange(16)
    conc = st.run_concurrent(
        stream, updates[n_batches * batch + batch:], lambda eng: talg.bfs_multi(eng, srcs),
        duration_s=3.0, batch_size=1000, engine_backend="torch", queries_per_call=16,
    )
    out = {
        "phase": "stream",
        "n": n,
        "m": stream.engine("torch").m,
        "tree_build_s": build_s,
        "batches": n_batches + 1,
        "updates_per_batch": batch,
        "publishes": len(publish_s),
        "versions_checked_vs_numpy": checked,
        "pagerank_max_rel_err": pr_rel_err[0],
        "pagerank_rtol": PR_RTOL,
        "kernel_max_abs_err": kernel_err,
        "mean_publish_s": float(np.mean(publish_s)),
        "p50_query_s": {k: float(np.median(v)) for k, v in lat.items()},
        "launches": launches,
        "concurrent": conc._asdict(),
    }
    emit(out)
    return launches


def stream_kernel_check(eng) -> dict:
    """The stream's own kernel shapes on its last (weighted) version: the
    engine's ``edge_map_reduce`` (D = 1) and ``edge_map_reduce_batch``
    (D = 8, the PageRank reset lanes), and the unweighted kernel on the
    same pool, each held against the plain version of the same reduce."""
    import torch

    from repro_torch.core.traversal import torch_backend as tb
    from repro_torch.kernels import segment_reduce as sr

    a, n = eng.aux, eng.g.n
    if a.w_by_dst is None:
        raise AssertionError("stream: the weighted batch left the mirror unweighted")
    dev = a.dst_sorted.device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    vals = torch.rand((8, n), generator=gen, device=dev)
    msg = tb._reduce_msgs_batch(vals, a.src_by_dst, a.valid_by_dst)
    dst = a.dst_sorted.to(torch.int32).contiguous()
    errs = {}
    for D in (1, 8):
        got = eng.edge_map_reduce(vals[0]) if D == 1 else eng.edge_map_reduce_batch(vals)
        want = sr.segment_sum_weighted_sorted_plain(dst, a.w_by_dst, msg[:, :D].contiguous(), n)
        errs[f"segment_sum_weighted_D{D}"] = check_close(
            got.reshape(-1, n).T, want, f"stream edge_map_reduce D={D}")
        m = msg[:, :D].contiguous()
        errs[f"segment_sum_D{D}"] = check_close(
            sr.segment_sum_sorted(dst, m, n), sr.segment_sum_sorted_plain(dst, m, n),
            f"stream segment_sum D={D}")
    return errs


def phase_scale() -> tuple:
    import scipy.sparse as sp
    import torch
    from scipy.sparse.csgraph import shortest_path

    from repro_torch.core import flat_graph as fg
    from repro_torch.core.traversal import algorithms as talg
    from repro_torch.core.traversal import torch_backend as tb
    from repro_torch.kernels import segment_reduce as sr

    log_n = 22
    n = 2**log_n
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    edges = rmat_symmetric_device(log_n, 2**25, seed=2)
    gen_s = time.perf_counter() - t0
    out = {"phase": "scale", "n": n, "edges_generated": int(edges.shape[0]), "gen_s": gen_s}

    def step(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[f"{name}_s"] = time.perf_counter() - t
        out[f"{name}_peak_bytes"] = torch.cuda.max_memory_allocated()
        return res

    g = step("from_edges", lambda: fg.from_edges(n, edges, device="cuda"))
    out["m"] = int(g.m)
    out["edge_capacity"] = g.edge_capacity
    sr.reset_launches()
    aux = step("engine_aux", lambda: tb.engine_aux(g))
    eng = tb.TorchEngine(g, aux=aux)
    iters = 10

    def launched():
        return sum(sr.LAUNCHES.values())

    before = launched()
    pr = step("pagerank10", lambda: talg.pagerank(eng, iters=iters))
    out["launches_per_pagerank_iter"] = (launched() - before) / iters
    if not (np.all(np.isfinite(pr)) and abs(pr.sum() - 1.0) < 1e-3):
        raise AssertionError(f"scale: pagerank sums to {pr.sum()}")
    resets = rng.random((8, n))
    resets /= resets.sum(1, keepdims=True)
    before = launched()
    prm = step("pagerank_multi8", lambda: talg.pagerank_multi(eng, resets, iters=iters))
    out["launches_per_pagerank_multi_iter"] = (launched() - before) / iters
    if not (np.all(np.isfinite(prm)) and np.allclose(prm.sum(1), 1.0, atol=1e-3)):
        raise AssertionError(f"scale: pagerank_multi row sums {prm.sum(1)}")
    deg = aux.degrees.cpu().numpy()
    in_deg = torch.diff(aux.dst_offsets)
    out["max_in_degree"] = int(in_deg.max())
    out["mean_in_degree"] = float(in_deg.float().mean())
    srcs = rng.choice(np.flatnonzero(deg > 0), 16, replace=False)
    _, depths = step("bfs_batch16", lambda: eng.bfs_batch(srcs))
    launches = dict(sr.LAUNCHES)

    depths = depths.cpu().numpy()
    t = time.perf_counter()
    adj = sp.csr_matrix((np.ones(edges.shape[0], np.int8), (edges[:, 0], edges[:, 1])),
                        shape=(n, n))
    ref = shortest_path(adj, unweighted=True, indices=srcs[:2])
    ref = np.where(np.isfinite(ref), ref, -1).astype(np.int64)
    out["scipy_s"] = time.perf_counter() - t
    if not np.array_equal(depths[:2], ref):
        raise AssertionError("scale: bfs depths differ from scipy")
    out["bfs_reached"] = int((depths >= 0).sum(1).max())
    out["max_depth"] = int(depths.max())
    emit(out)
    return g, aux, launches


def phase_scale_kernels(g, aux) -> list:
    """Each kernel at the scale phase's shapes (the PageRank reduce:
    dst_sorted over the whole pool, n_out = n, D = 1 and the x8 lanes)
    against its plain version, timed beside ``index_add_`` (unweighted)
    and a sparse CSR product (weighted)."""
    import torch

    from repro_torch.core.traversal import torch_backend as tb
    from repro_torch.kernels import segment_reduce as sr

    n = g.n
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dst = aux.dst_sorted
    e_valid = int((dst < n).sum())
    idx = dst.long()
    w = torch.rand(dst.shape, generator=gen, device="cuda")
    wv = torch.where(dst < n, w, 0.0)
    offs = aux.dst_offsets.long()
    csr_w = torch.sparse_csr_tensor(offs, torch.arange(e_valid, device="cuda"), wv[:e_valid],
                                    size=(n, dst.shape[0]))
    summary = []
    for D in (1, 8):
        vals = torch.rand((D, n), generator=gen, device="cuda")
        msg = tb._reduce_msgs_batch(vals, aux.src_by_dst, aux.valid_by_dst)
        ext = torch.zeros((n + 1, msg.shape[1]), device="cuda")
        for name, weighted in (("segment_sum", False), ("segment_sum_weighted", True)):
            if weighted:
                kern = lambda: sr.segment_sum_weighted_sorted(dst, w, msg, n)  # noqa: E731
                plain = lambda: sr.segment_sum_weighted_sorted_plain(dst, w, msg, n)  # noqa: E731
                lib = lambda: torch.sparse.mm(csr_w, msg)  # noqa: E731
            else:
                kern = lambda: sr.segment_sum_sorted(dst, msg, n)  # noqa: E731
                plain = lambda: sr.segment_sum_sorted_plain(dst, msg, n)  # noqa: E731
                lib = lambda: ext.zero_().index_add_(0, idx, msg)  # noqa: E731
            err = check_close(kern(), plain(), f"scale {name} D={D}")
            bound_ms, bound_by = bound(e_valid, n, D, weighted)
            summary.append({
                "name": name, "D": D, "E": int(dst.shape[0]), "E_valid": e_valid, "n_out": n,
                "max_abs_err": err, "ms": time_ms(kern), "plain_ms": time_ms(plain),
                "library_ms": time_ms(lib), "bound_ms": bound_ms, "bound_by": bound_by,
            })
    emit({"phase": "scale_kernels", "cases": summary})
    return summary


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repo (src/repro_torch missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    phase_env(smi)
    phase_kernels()
    stream_launches = phase_stream()
    g, aux, scale_launches = phase_scale()
    cases = phase_scale_kernels(g, aux)

    summary = []
    for name in ("segment_sum", "segment_sum_weighted"):
        c = next(c for c in cases if c["name"] == name and c["D"] == 1)
        summary.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/segment_reduce.cu",
            "replaces": "src/repro/kernels/segment_reduce.py:"
                        + ("53" if name == "segment_sum" else "109"),
            "launches": stream_launches[name] + scale_launches[name],
            "max_abs_err": c["max_abs_err"],
            "ms": c["ms"],
            "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"],
            "library_ms": c["library_ms"],
        })
    print(smi, flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
