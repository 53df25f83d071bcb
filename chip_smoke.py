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
          scipy), and each kernel against its plain version at these shapes;
  compressed_kernels
          each chunked kernel against its plain version on ragged chunk
          counts: fixed int8 / int16 lanes with escapes, adaptive lanes
          mixing narrow and wide chunks (escapes in both, spare hi rows),
          and a narrow adaptive lane with an empty hi plane;
  compressed_stream
          ``AspenStream(compressed=True)`` at 2^18 vertices on 8 disjoint
          rMAT communities of 2^15 vertices (first showing that the stream
          phase's plain rMAT tree raises, as the reference's layout does),
          each of the 9 publishes held against its host tree, decoded
          once, and the numpy engine on that decode, and both adaptive
          kernels held against their plain versions on the
          last version's own lane (D = 1 and 8);
  compressed_scale
          with the flat scale graph freed, 128 disjoint rMAT
          communities of 2^15 vertices (2^22 vertices,
          ~63 M edges, drawn on the card) in the adaptive and the int16
          layout, plain and weighted: ``CompressedEngine`` held against the
          raw engine on the same edges, each chunked kernel timed against
          its plain version and the raw kernel on the decoded lane (first
          showing that the scale phase's plain rMAT graph raises), and the
          two chunked decode kernels timed on each layout's source lane;
  decode_kernels
          each delta-decode kernel against its plain version, exactly, on
          synthetic inputs that reach the corners: padded rows of ragged
          length, int8 / int16 chunk rows with escapes at columns 0, 1,
          127, below 0 and at the row's end, adaptive lanes all narrow, all
          wide, mixed, and with an empty hi plane;
  host_decode
          ``ops.decode_pool`` on the stream phase's final host snapshot
          (per-vertex neighbour lists chunked at vertex starts and hash
          heads, packed in uint16 and uint8), equal to
          ``chunks.unpack_deltas``, and the padded kernel timed at that
          shape;
  scale_decode
          the padded kernel on the scale phase's pool dst lane cut into
          128-slot rows (67 M real ids), against its plain version and
          ``torch.cumsum``.

  gnn_kernels
          the fanout and block SpMM kernels against their plain versions:
          fanout mean / sum / max with bool, fractional and empty-bag
          masks at B = 1, B not a multiple of 8, the reference's test
          shapes and the three full-width GraphSAGE launches; SpMM at
          n = 256, 300, 2708 and D = 1, 16, 64, 1433 with a nonzero tile
          masked off and a row of empty tiles;
  gnn_sampled
          graphsage-reddit FULL on minibatch_lg: ~114.6 M rMAT edges over
          232,965 vertices drawn on the card into a flat graph, 602
          features per vertex, four minibatches of B = 1024 at fanout
          (15, 10) with 512 edges streamed in between batches; the kernel
          forward held against the torch expression, every pick checked
          to be an edge, 3 fanout launches per forward, each timed;
  gnn_full
          gcn-cora FULL on full_graph_sm (a 10,562-edge power-law graph
          at Cora's 2,708 vertices): ``gcn.forward`` on the flat graph
          held against the CPU, then ``ops.spmm_from_edges`` at D = 16
          and 1433 held against GCN's segment-sum aggregation and the
          plain SpMM, two kernel calls held to the same bits, timed
          beside CSR ``torch.sparse.mm``.

  flash_kernels
          the flash-decode kernel against its plain version in float32 and
          bf16: the reference's test shapes, S = 1000, lengths 0, 1 and 7,
          d = 12 and 256, an f32 query over a bf16 cache, and strided
          (B, S_max, n_kv, d) cache slices at the FULL configs' (Q, d),
          each case's route (TMA or cp.async) printed, and the TMA route
          asserted for the FULL configs' bf16 slices;
  lm_decode_long
          smollm-360m FULL on long_500k: B = 1, a bf16 cache of 524,288
          positions (21.5 GB) drawn on the card at cache_len = S_max - 4
          (a prefill of 524,288 tokens does not fit this script's time),
          four ``decode_step``s through the kernel (32 launches each, all
          on the TMA route), each held against the same step without it;
          layer 0's kernel call held against its plain version and timed
          (per call and back to back) beside its bound, the plain version
          and SDPA, with the host cost of its tensor maps and of setting
          ctypes argtypes on every call;
  lm_decode_32k
          the same on decode_32k at B = 32 (cut from 128, whose cache would
          take 172 GB), ragged cache lengths in [16,384, 32,767], 3 steps;
  lm_serve
          ``make_prefill`` at B = 1, S = 3072 (blockwise attention) in
          float32 against the token-by-token decode of the same prompt
          through ``make_serve_step`` on the kernel (full width, depth cut
          to 8 layers for time), the bf16 model's drift from float32 on
          one step, then ``generate`` on the kernel in bf16 with all 32
          layers for 8 left-padded prompts of 5-32 tokens, 16 new tokens.

The compressed layout (128-slot chunks, int8/int16 deltas, 8 escapes per
chunk) holds only graphs whose ids have community locality: on plain
rMAT beyond 2^15 vertices some chunk needs more than 8 int16 escapes and
``compress_host`` raises, in the reference as in the port (PERF.md §7).

The compressed engine decodes its lanes through the chunked decode
kernels (``core/compressed.decode_rows`` on the card), so the compressed
phases count their launches too.

Then the kernel summary line and, last, ``{"ok": true, "device": ...}``.
Any mismatch or exception ends the run with a nonzero exit and no ``ok``
line.  Without a GPU, or outside a checkout of the repo, it exits nonzero
before printing any result.  It imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import gc
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


def check_close(got, want, what: str, rtol: float = 1e-5, atol: float | None = None) -> float:
    """``got`` against ``want`` (a kernel against its plain version, a
    forward against another path) within rtol and atol; returns
    max|got - want|.  The plain version's ``index_add_`` uses atomics on
    the card, so its float32 summation order differs from the kernel's
    fixed order: by default rtol 1e-5 and atol 1e-6 * max|want|."""
    import torch

    if atol is None:
        atol = 1e-6 * max(float(want.abs().max()) if want.numel() else 0.0, 1e-30)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol, msg=lambda m: f"{what}: {m}")
    return float((got - want).abs().max()) if got.numel() else 0.0


def rmat_symmetric_device(log_n: int, n_draws: int, seed: int, communities: int = 1):
    """rMAT edges (a=0.5, b=c=0.1, d=0.3, paper §7.4) drawn on the card from
    a seeded generator, then symmetrized, deduplicated and stripped of
    self loops there: the semantics of ``repro_torch.data.rmat``'s
    ``symmetrize(rmat_edges(...))`` with the card's random stream.  At
    2^25 draws the numpy pair took 296.6 s on the H100 machine's host,
    a quarter of this script's time limit (PERF.md).  With
    ``communities`` > 1 the draws split into that many equal runs, run c
    over its own 2^log_n ids numbered from c << log_n (disjoint rMAT
    communities).  Returns a host (m, 2) int64 array, sorted by (src, dst)."""
    import torch

    keys = rmat_keys_device(log_n, n_draws, seed, communities)
    return torch.stack([keys >> 32, keys & 0xFFFFFFFF], 1).cpu().numpy()


def rmat_keys_device(log_n: int, n_draws: int, seed: int, communities: int = 1):
    """``rmat_symmetric_device``'s edges as packed ``(src << 32) | dst``
    keys, sorted and unique, left on the card."""
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
    if communities > 1:
        off = (torch.arange(n_draws, device="cuda") * communities // n_draws) << log_n
        src, dst = src + off, dst + off
    keys = torch.cat([(src << 32) | dst, (dst << 32) | src])
    keys = torch.unique(keys)
    return keys[(keys >> 32) != (keys & 0xFFFFFFFF)]


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
        "flash_decode_ptxas": ptxas_summary(_build.BUILD_INFO.get("flash_decode", {})),
        "block_spmm_ptxas": ptxas_summary(_build.BUILD_INFO.get("block_spmm", {})),
    })


def ptxas_summary(info: dict) -> list:
    """[kernel, registers, spill-store bytes] per entry function, from the
    ``-Xptxas -v`` log of a build made in this process."""
    import re

    rows, name, spill = [], None, 0
    for line in info.get("log", "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            short = re.search(r"(flash_(?:tma|cpasync)_kernel)I([ft])Li(\d+)E", name)
            if short:  # e.g. flash_tma_kernel<bf16, Q<=3>
                kern, t, qm = short.groups()
                name = f"{kern}<{'f32' if t == 'f' else 'bf16'}, Q<={qm}>"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append([name, int(m.group(1)), spill])
            name, spill = None, 0
    return rows


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
    if min(launches["segment_sum"], launches["segment_sum_weighted"]) == 0:
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
    return launches, stream


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

# ---------------------------------------------------------------------------
# delta-decode phases
# ---------------------------------------------------------------------------

DECODE_KERNELS = ("delta_decode_chunked", "delta_decode_chunked_adaptive", "delta_decode_padded")


def padded_decode_bound(R: int, L: int):
    """Least time (ms) of the padded decode: 4 B per delta read, 4 B per
    anchor, 4 B per id written over HBM; one add per id over the f32
    peak (the scans' shuffles are not counted)."""
    t_bytes, t_ops = (8 * R * L + 4 * R) / HBM_BYTES_PER_S, R * L / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def chunked_decode_bound(s):
    """Least time (ms) of a chunked decode of stream ``s``: the lane, the
    hi rows that wide chunks use, per row the anchor and the escape table
    (adaptive: the wide tag and the hi row index too), and 4 B per id
    written; one add per id and per escape over the f32 peak."""
    R, K = s.ovf_pos.shape
    L = s.deltas.shape[1]
    per_row = 4 + 8 * K + (5 if s.hi is not None else 0)
    hi_used = 0 if s.hi is None or s.hi_cap == 0 else int(s.wide.sum()) * L
    nbytes = s.deltas.numel() * s.deltas.element_size() + hi_used + per_row * R + 4 * R * L
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, R * (L + K) / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def decode_calls(s):
    """(kernel, plain version) of the chunked decode for stream ``s``'s
    layout, as thunks."""
    from repro_torch.kernels import delta_decode as dd

    a, d, p, v = s.anchors, s.deltas, s.ovf_pos, s.ovf_add
    if s.hi is None:
        return (lambda: dd.delta_decode_chunked(a, d, p, v),
                lambda: dd.delta_decode_chunked_plain(a, d, p, v))
    return (lambda: dd.delta_decode_chunked_adaptive(a, d, s.hi, s.wide, p, v),
            lambda: dd.delta_decode_chunked_adaptive_plain(a, d, s.hi, s.wide, p, v))


def check_equal(got, want, what: str) -> float:
    """Integer decode: the kernel must equal its plain version exactly."""
    import torch

    if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{what}: kernel differs from its plain version")
    return 0.0


def escape_rows(R: int, width: int, seed: int):
    """Fixed-width chunk rows (int8 or int16 lane, 8 escape slots) whose
    row r uses 1 + r % 8 slots at distinct columns: one corner in turn
    (column 0, 1, 127, -3, or 128 = the row's end, which must never act,
    with a nonzero delta) and the rest in [2, 127); anchors over the whole
    int32 range, so the decode wraps."""
    import torch

    rng = np.random.default_rng(seed)
    K, lim = 8, (100 if width == 1 else 30_000)
    deltas = rng.integers(-lim, lim, (R, 128)).astype(np.int8 if width == 1 else np.int16)
    cols = np.argsort(rng.random((R, 125)), axis=1)[:, :K - 1] + 2
    corner = np.array([0, 1, 127, -3, 128])[np.arange(R) % 5]
    pos = np.concatenate([corner[:, None], cols], 1)
    used = np.arange(K)[None, :] < (1 + np.arange(R) % K)[:, None]
    add = np.where(used, rng.integers(-(1 << 20), 1 << 20, (R, K)), 0)
    pos = np.where(used, pos, 128)
    order = np.argsort(pos, axis=1, kind="stable")
    pos, add = np.take_along_axis(pos, order, 1), np.take_along_axis(add, order, 1)
    r_idx, c_idx = np.nonzero((pos >= 0) & (pos < 128))
    deltas[r_idx, pos[r_idx, c_idx]] = 0  # escaped slots hold 0 in the lane
    deltas[:, 0] = 0
    anchors = rng.integers(-(2**31), 2**31, R, dtype=np.int64).astype(np.int32)
    return [torch.from_numpy(np.ascontiguousarray(x)).cuda()
            for x in (anchors, deltas, pos.astype(np.int32), add.astype(np.int32))]


def phase_decode_kernels() -> None:
    import torch

    from repro_torch.core import compressed as cz
    from repro_torch.kernels import delta_decode as dd

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    rows = []
    for R, L in [(1, 1), (3, 40), (17, 300), (65539, 257), (2, 4097)]:
        full = dict(low=-(2**31), high=2**31, generator=gen, device="cuda", dtype=torch.int32)
        a, d = torch.randint(size=(R,), **full), torch.randint(size=(R, L), **full)
        rows.append({"kernel": "delta_decode_padded", "R": R, "L": L, "max_abs_err": check_equal(
            dd.delta_decode_padded(a, d), dd.delta_decode_padded_plain(a, d), f"padded {R}x{L}")})
    for R in (1, 1001, 7919):
        for width in (1, 2):
            a, d, p, v = escape_rows(R, width, seed=R + width)
            s = cz.ChunkedStream(a, d, p, v, torch.zeros((), dtype=torch.bool, device="cuda"))
            kern, plain = decode_calls(s)
            lane = f"int{8 * width}"
            rows.append({"kernel": "delta_decode_chunked", "lane": lane, "R": R,
                         "escapes": int(((p >= 0) & (p < 128)).sum()),
                         "max_abs_err": check_equal(kern(), plain(), f"chunked {lane} R={R}")})
        rng = np.random.default_rng(R)
        small = np.cumsum(rng.integers(-100, 100, R * 128)).astype(np.int32)
        big = np.cumsum(rng.integers(-30_000, 30_000, R * 128)).astype(np.int32)
        mixed, _ = ascending_lane(R, "mixed", seed=R, esc_every=3)
        for kind, lane, hi_cap in (("narrow", small, 4), ("wide", big, R),
                                   ("mixed", mixed, None), ("narrow_h0", small, 0)):
            lane_t = torch.from_numpy(lane).cuda()
            if hi_cap is None:  # spare hi rows past the wide count
                hi_cap = int(cz.encode_stream_adaptive(lane_t, hi_cap=R).wide.sum()) + 3
            s = cz.encode_stream_adaptive(lane_t, hi_cap=hi_cap)
            n_wide = int(s.wide.sum())
            if bool(s.spill) or (R > 1 and not {"narrow": n_wide == 0, "narrow_h0": n_wide == 0,
                                                  "wide": n_wide == R,
                                                  "mixed": 0 < n_wide < R}[kind]):
                raise AssertionError(f"decode_kernels: adaptive {kind} R={R} is not {kind}")
            kern, plain = decode_calls(s)
            err = check_equal(kern(), plain(), f"adaptive {kind} R={R}")
            if R > 1 and not torch.equal(kern().reshape(-1)[:lane.size], lane_t):
                raise AssertionError(f"decode_kernels: adaptive {kind} R={R} does not round-trip")
            rows.append({"kernel": "delta_decode_chunked_adaptive", "lane": kind, "R": R,
                         "wide": n_wide, "hi_rows": s.hi_cap,
                         "escapes": int((s.ovf_pos < 128).sum()), "max_abs_err": err})
    emit({"phase": "decode_kernels", "tolerance": "exact", "cases": rows,
          "phase_s": time.perf_counter() - t0})


def phase_host_decode(stream) -> tuple:
    """``ops.decode_pool`` on the stream's final host snapshot: every
    vertex's sorted neighbour list, end to end, chunked where a vertex
    starts and at the C-tree's hash heads (``ctree.DEFAULT_B``), packed in
    uint16 and uint8.  Equal to ``chunks.unpack_deltas`` exactly; the
    padded kernel then timed at this pool's shape."""
    import torch

    from repro_torch.core import chunks as ck
    from repro_torch.core import ctree
    from repro_torch.core.hash import is_head_np
    from repro_torch.core.traversal.numpy_backend import gather_csr
    from repro_torch.kernels import delta_decode as dd
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    snap = stream.flat_snapshot()
    offsets, nbrs = gather_csr(snap, np.arange(snap.n, dtype=np.int64))
    out = {"phase": "host_decode", "n": snap.n, "m": int(nbrs.size),
           "gather_s": time.perf_counter() - t0}
    heads = np.flatnonzero(is_head_np(nbrs, ctree.DEFAULT_B))
    chunk_off = np.unique(np.concatenate([[0], offsets[:-1][np.diff(offsets) > 0], heads,
                                          [nbrs.size]])).astype(np.int64)
    packs = {w: ck.pack_deltas(nbrs, chunk_off, width=w) for w in ("uint16", "uint8")}
    dd.reset_launches()
    got = {}
    for w, p in packs.items():
        t = time.perf_counter()
        got[w] = ops.decode_pool(p, device="cuda")
        out[f"decode_pool_{w}_s"] = time.perf_counter() - t
    launches = dict(dd.LAUNCHES)
    if launches["delta_decode_padded"] == 0:
        raise AssertionError(f"host_decode: delta_decode_padded was never launched: {launches}")
    for w, p in packs.items():
        t = time.perf_counter()
        want = ck.unpack_deltas(p)
        out[f"unpack_deltas_{w}_s"] = time.perf_counter() - t
        if not (np.array_equal(got[w], want) and np.array_equal(want, nbrs)):
            raise AssertionError(f"host_decode: decode_pool ({w}) differs from unpack_deltas")
        out[f"escapes_{w}"] = int(p.overflow.size)
    anchors, rows, _ = ops.pool_rows(packs["uint16"], device="cuda")
    rows[:, 0] = 0
    R, L = rows.shape
    kern = lambda: dd.delta_decode_padded(anchors, rows)  # noqa: E731
    plain = lambda: dd.delta_decode_padded_plain(anchors, rows)  # noqa: E731
    lib = lambda: torch.cumsum(rows, 1, dtype=torch.int32) + anchors[:, None]  # noqa: E731
    err = check_equal(kern(), plain(), "host_decode padded")
    bound_ms, bound_by = padded_decode_bound(R, L)
    out.update(chunks=R, max_len=L, padded_bytes=4 * R * L, max_abs_err=err,
               ms=time_ms(kern), plain_ms=time_ms(plain), library_ms=time_ms(lib),
               bound_ms=bound_ms, bound_by=bound_by, launches=launches,
               phase_s=time.perf_counter() - t0)
    emit(out)
    return launches


def phase_scale_decode(g) -> dict:
    """The padded kernel at full size: the scale pool's dst lane (real
    ids, pads included) cut into 128-slot rows, held against its plain
    version and the lane itself, timed beside ``torch.cumsum``."""
    import torch

    from repro_torch.kernels import delta_decode as dd

    lane = (g.keys & 0xFFFFFFFF).to(torch.int32)  # pad slots wrap to -1, as int32 does
    rows = lane[: lane.shape[0] // 128 * 128].view(-1, 128)
    anchors = rows[:, 0].contiguous()
    deltas = torch.diff(rows, dim=1, prepend=rows[:, :1])  # column 0 = 0; int32 wraps
    R, L = deltas.shape
    kern = lambda: dd.delta_decode_padded(anchors, deltas)  # noqa: E731
    plain = lambda: dd.delta_decode_padded_plain(anchors, deltas)  # noqa: E731
    lib = lambda: torch.cumsum(deltas, 1, dtype=torch.int32) + anchors[:, None]  # noqa: E731
    err = check_equal(kern(), plain(), "scale_decode padded")
    check_equal(kern(), rows, "scale_decode padded vs the lane")
    bound_ms, bound_by = padded_decode_bound(R, L)
    out = {"phase": "scale_decode", "name": "delta_decode_padded", "R": R, "L": L,
           "max_abs_err": err, "ms": time_ms(kern), "plain_ms": time_ms(plain),
           "library_ms": time_ms(lib), "bound_ms": bound_ms, "bound_by": bound_by}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# compressed phases
# ---------------------------------------------------------------------------

CHUNKED_KERNELS = ("segment_sum_chunked", "segment_sum_weighted_chunked",
                   "segment_sum_chunked_adaptive", "segment_sum_weighted_chunked_adaptive")


def ascending_lane(R: int, kind: str, seed: int, esc_every: int, tail: int = 37):
    """(values int32[R * 128 - tail], n_out): an ascending dst lane whose
    chunks carry ``kind``'s deltas.  ``int8``: small gaps, int8 escapes in
    two chunks of three; ``int16``: 12 int16-sized gaps per chunk, int16
    escapes (1-8) in one chunk of ``esc_every``; ``mixed``: narrow,
    narrow with int8 escapes, wide, wide with int16 escapes, in turn.
    Values past the 90th percentile are cut to ``n_out`` (pads)."""
    rng = np.random.default_rng(seed)
    gaps = rng.integers(0, 3, (R, 128)).astype(np.int64)
    for r in range(R):
        cols = rng.permutation(np.arange(1, 128))
        j = 1 + r % 8
        role = r % 4 if kind == "mixed" else {"int8": 1, "int16": 3}[kind]
        if role == 1 and r % 3 != 2:
            gaps[r, cols[:j]] = rng.integers(128, 1000, j)
        if role in (2, 3):
            gaps[r, cols[j:j + 12]] = rng.integers(200, 1000, 12)
        if role == 3 and r % esc_every == esc_every - 1:
            gaps[r, cols[:j]] = rng.integers(32_768, 40_000, j)
    vals = np.cumsum(gaps.reshape(-1))[: R * 128 - tail]
    n_out = int(vals[int(0.9 * vals.size)])
    return np.minimum(vals, n_out).astype(np.int32), n_out


def chunked_call(s, msg, n_out, w=None, plain=False):
    """The chunked kernel for stream ``s``'s layout (or its plain version)."""
    from repro_torch.kernels import segment_reduce as sr

    args = (s.anchors, s.deltas, s.ovf_pos, s.ovf_add)
    if plain:
        if w is None:
            return sr.segment_sum_sorted_chunked_plain(*args, msg, n_out, s.hi, s.wide)
        return sr.segment_sum_weighted_chunked_plain(*args, w, msg, n_out, s.hi, s.wide)
    if s.hi is None:
        if w is None:
            return sr.segment_sum_sorted_chunked(*args, msg, n_out)
        return sr.segment_sum_weighted_chunked(*args, w, msg, n_out)
    a, d, p, v = args
    if w is None:
        return sr.segment_sum_sorted_chunked_adaptive(a, d, s.hi, s.wide, p, v, msg, n_out)
    return sr.segment_sum_weighted_chunked_adaptive(a, d, s.hi, s.wide, p, v, w, msg, n_out)


def chunked_name(s, weighted: bool) -> str:
    return ("segment_sum_weighted_chunked" if weighted else "segment_sum_chunked") + (
        "_adaptive" if s.hi is not None else "")


def phase_compressed_kernels() -> None:
    import torch

    from repro_torch.core import compressed as cz

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for R, D in [(1, 1), (1, 8), (1, 64), (1001, 1), (1001, 8), (1001, 64), (7919, 1), (7919, 8)]:
        for layout, kind in (("fixed1", "int8"), ("fixed2", "int16"), ("adaptive", "mixed"),
                             ("adaptive_h0", "int8")):
            vals, n_out = ascending_lane(R, kind, seed=R * 7 + D,
                                         esc_every=3 if R < 1000 else 16 if R < 5000 else 61)
            lane = torch.from_numpy(vals).cuda()
            if layout.startswith("fixed"):
                s = cz.encode_stream(lane, width=int(layout[-1]))
            else:
                hi_cap = 0
                if layout == "adaptive":  # spare hi rows past the wide count
                    hi_cap = int(cz.encode_stream_adaptive(lane, hi_cap=R).wide.sum()) + 3
                s = cz.encode_stream_adaptive(lane, hi_cap=hi_cap)
            if bool(s.spill):
                raise AssertionError(f"compressed_kernels: {layout} R={R} spilled")
            msg = torch.randn((R * 128, D), generator=gen, device="cuda")
            w = torch.rand((R * 128,), generator=gen, device="cuda")
            row = {"layout": layout, "R": R, "D": D, "n_out": n_out,
                   "escapes": int((s.ovf_pos < 128).sum()),
                   "wide": 0 if s.wide is None else int(s.wide.sum()), "hi_rows": s.hi_cap}
            for weighted in (False, True):
                wt = w if weighted else None
                name = chunked_name(s, weighted)
                row[f"{name}_max_abs_err"] = check_close(
                    chunked_call(s, msg, n_out, wt), chunked_call(s, msg, n_out, wt, plain=True),
                    f"{name} {layout} R={R} D={D}")
            rows.append(row)
    for r in rows:
        if r["R"] > 1 and r["escapes"] == 0:
            raise AssertionError(f"compressed_kernels: no escapes in {r}")
    emit({"phase": "compressed_kernels", "tolerance": "rtol 1e-5, atol 1e-6*max|out|",
          "cases": rows, "phase_s": time.perf_counter() - t0})


def phase_compressed_stream(plain_stream) -> dict:
    import torch

    from repro_torch.core import compressed as cz
    from repro_torch.core import flat_graph as fg
    from repro_torch.core import graph as G
    from repro_torch.core import streaming as st
    from repro_torch.core.traversal import CompressedEngine, flat_graph_of
    from repro_torch.core.traversal.numpy_backend import NumpyEngine
    from repro_torch.data.rmat import rmat_communities
    from repro_torch.kernels import delta_decode as dd
    from repro_torch.kernels import segment_reduce as sr

    t_phase = time.perf_counter()
    out = {"phase": "compressed_stream"}
    # the reference's layout cannot hold plain rMAT at 2^18: both raise
    v = plain_stream.acquire()
    try:
        st.AspenStream(v.graph, compressed=True, device="cuda")
        raise AssertionError("compressed_stream: plain rMAT 2^18 did not raise")
    except ValueError as e:
        out["plain_rmat_2^18_raises"] = str(e)
    finally:
        plain_stream.release(v)

    log_c, n_comm, batch, n_batches = 15, 8, 10_000, 4
    n = n_comm << log_c
    rng = np.random.default_rng(SEED + 1)
    E0 = rmat_communities(log_c, n_comm, 8, seed=10)
    base, updates = st.make_update_stream(E0, n_batches * batch + batch, seed=5)
    t0 = time.perf_counter()
    stream = st.AspenStream(G.build_graph(n, base), compressed=True, device="cuda")
    out.update(n=n, communities=n_comm, community_vertices=1 << log_c,
               edges_generated=int(E0.shape[0]), tree_and_mirror_build_s=time.perf_counter() - t0)

    mirror_s, publish_s, check_s, decode_s, pr_rel = [], [], [], [], [0.0]

    def timed_mirror(fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = fn(*a, **k)
            torch.cuda.synchronize()
            mirror_s.append(time.perf_counter() - t)
            return res
        return run

    stream._mirror_insert = timed_mirror(stream._mirror_insert)
    stream._mirror_delete = timed_mirror(stream._mirror_delete)

    def mirror():
        v = stream.acquire()
        try:
            return v.aux[st.MIRROR]
        finally:
            stream.release(v)

    def check_version() -> None:
        t = time.perf_counter()
        v = stream.acquire()
        try:  # the version's mirror, and its tree decoded once on the host
            cg = v.aux[st.MIRROR]
            snap = DecodedSnapshot(G.flat_snapshot(v.graph))
        finally:
            stream.release(v)
        decode_s.append(time.perf_counter() - t)
        if not isinstance(cg, fg.CompressedPool) or bool(cg.dst.spill):
            raise AssertionError("compressed_stream: the mirror is not a sound CompressedPool")
        eng_np = NumpyEngine(snap)
        got, want = fg.decompress(cg), flat_graph_of(snap, device="cuda")
        m = int(want.m)
        if not (int(got.m) == m and torch.equal(got.keys[:m], want.keys[:m])
                and torch.equal(got.offsets, want.offsets)
                and bool((got.keys[m:] == fg.SENT64).all())
                and (want.weights is None or torch.equal(got.weights[:m], want.weights[:m]))):
            raise AssertionError("compressed_stream: decompress(mirror) differs from a rebuild")
        eng = stream.engine("torch")
        if not isinstance(eng, CompressedEngine):
            raise AssertionError(f"compressed_stream: engine is {type(eng).__name__}")
        srcs = rng.choice(np.flatnonzero(eng_np.degrees > 0), 16, replace=False)
        if not np.array_equal(stream.query_batch(srcs, kind="bfs"),
                              stream._serve_kind(eng_np, "bfs", srcs, {})):
            raise AssertionError("compressed_stream: bfs parents differ from the numpy engine")
        resets = rng.random((8, n))
        resets /= resets.sum(1, keepdims=True)
        got = stream.query_batch(kind="pagerank", resets=resets)
        want = stream._serve_kind(eng_np, "pagerank", None, {"resets": resets})
        atol = 1e-6 * float(np.abs(want).max())
        pr_rel[0] = max(pr_rel[0], float((np.abs(got - want) / np.maximum(np.abs(want), atol)).max()))
        if not (np.all(np.isfinite(got)) and np.allclose(got, want, rtol=PR_RTOL, atol=atol)):
            raise AssertionError(f"compressed_stream: pagerank off (rel {pr_rel[0]})")
        if not np.array_equal(stream.query_batch(srcs[:4], kind="sssp"),
                              stream._serve_kind(eng_np, "sssp", srcs[:4], {})):
            raise AssertionError("compressed_stream: sssp distances differ from the numpy engine")
        check_s.append(time.perf_counter() - t)

    def publish(fn, *args, **kw):
        t = time.perf_counter()
        fn(*args, **kw)
        torch.cuda.synchronize()
        publish_s.append(time.perf_counter() - t)

    sr.reset_launches()
    dd.reset_launches()
    for b in range(n_batches):  # each batch: an insert publish, then a delete publish
        rows = updates[b * batch:(b + 1) * batch]
        publish(stream.insert_edges, rows[rows[:, 2] == 0, :2])
        check_version()
        publish(stream.delete_edges, rows[rows[:, 2] == 1, :2])
        check_version()
    wedges = updates[n_batches * batch:(n_batches + 1) * batch, :2]
    weights = rng.integers(1, 10, size=wedges.shape[0]).astype(np.float64)
    publish(stream.insert_edges, wedges, weights=weights)
    check_version()
    launches = {**sr.LAUNCHES, **dd.LAUNCHES}
    for name in ("segment_sum_chunked_adaptive", "segment_sum_weighted_chunked_adaptive",
                 "delta_decode_chunked_adaptive"):
        if launches[name] == 0:
            raise AssertionError(f"compressed_stream: {name} was never launched: {launches}")
    kernel_check = compressed_stream_kernel_check(stream.engine("torch"))

    cg = mirror()
    stats = fg.chunk_stats(fg.decompress(cg))
    spare = cg.dst.hi_cap - int(cg.dst.wide.sum())
    resident = cz.stream_nbytes(cg.dst)
    if resident != stats["bytes_ideal"] + spare * 128:
        raise AssertionError(f"compressed_stream: {resident} resident bytes, bytes_ideal "
                             f"{stats['bytes_ideal']} + {spare} spare hi rows")
    m = int(cg.m)
    out.update(
        m=m, batches=n_batches + 1, updates_per_batch=batch, publishes=len(publish_s),
        versions_checked=len(publish_s), pagerank_max_rel_err=pr_rel[0], pagerank_rtol=PR_RTOL,
        mean_publish_s=float(np.mean(publish_s)), mean_mirror_step_s=float(np.mean(mirror_s)),
        checks_s=float(np.sum(check_s)), checks_decode_s=float(np.sum(decode_s)),
        spill_heals=stream.spill_heals, dst_bytes=resident, bytes_ideal=stats["bytes_ideal"],
        spare_hi_rows=spare, dst_bytes_per_edge=resident / m,
        raw_key_bytes_per_edge=8 * cg.edge_capacity / m,
        wide_chunks=int(cg.dst.wide.sum()), chunks=cg.dst.deltas.shape[0],
        kernel_check=kernel_check, launches=launches, phase_s=time.perf_counter() - t_phase,
    )
    emit(out)
    return launches


class DecodedSnapshot:
    """A version's host ``FlatSnapshot`` decoded once into a CSR, with the
    same snapshot protocol (``n``, ``neighbors``, ``degree``, ``degrees``,
    ``m``, ``weighted``, ``edge_weights``).  The numpy engine on the tree
    decodes each frontier vertex's chunks again in every sparse round
    (half of a check's host time); here it slices the one decode, which
    is the same ``gather_csr`` over the same tree."""

    def __init__(self, snap):
        from repro_torch.core.traversal.numpy_backend import gather_csr

        self.n, self.weighted, self._snap = snap.n, snap.weighted, snap
        self.offsets, self.nbrs = gather_csr(snap, np.arange(snap.n, dtype=np.int64))
        self.degrees = np.diff(self.offsets)
        self.m = int(self.offsets[-1])

    def neighbors(self, v: int):
        return self.nbrs[self.offsets[v]:self.offsets[v + 1]]

    def degree(self, v: int) -> int:
        return int(self.degrees[v])

    def edge_weights(self, srcs, dsts):
        return self._snap.edge_weights(srcs, dsts)


def compressed_stream_kernel_check(eng) -> dict:
    """``stream_kernel_check`` for the compressed stream's last (weighted)
    version: the engine's ``edge_map_reduce`` (D = 1) and
    ``edge_map_reduce_batch`` (D = 8) against the weighted chunked plain
    version on the same ``dst_sorted_c`` lane and messages, and the
    unweighted chunked kernel on that lane against its plain version."""
    import torch

    from repro_torch.core import compressed as cz
    from repro_torch.core.traversal import torch_backend as tb

    a, n = eng.caux, eng.cg.n
    if a.w_by_dst is None:
        raise AssertionError("compressed_stream: the weighted batch left the mirror unweighted")
    s = a.dst_sorted_c
    if s.hi is None:
        raise AssertionError("compressed_stream: the aux dst lane is not adaptive")
    src_by_dst = cz.decode_stream(a.srcbd_c)
    valid = torch.arange(src_by_dst.shape[0], device=src_by_dst.device) < a.m_valid
    gen = torch.Generator(device=src_by_dst.device).manual_seed(SEED)
    vals = torch.rand((8, n), generator=gen, device=src_by_dst.device)
    msg = tb._reduce_msgs_batch(vals, src_by_dst, valid)
    out = {"R": s.deltas.shape[0], "wide": int(s.wide.sum()), "hi_rows": s.hi_cap,
           "escapes": int((s.ovf_pos < cz.CHUNK).sum())}
    for D in (1, 8):
        got = eng.edge_map_reduce(vals[0]) if D == 1 else eng.edge_map_reduce_batch(vals)
        m = msg[:, :D].contiguous()
        out[f"segment_sum_weighted_chunked_adaptive_D{D}_max_abs_err"] = check_close(
            got.reshape(-1, n).T, chunked_call(s, m, n, a.w_by_dst, plain=True),
            f"compressed_stream edge_map_reduce D={D}")
        out[f"segment_sum_chunked_adaptive_D{D}_max_abs_err"] = check_close(
            chunked_call(s, m, n), chunked_call(s, m, n, plain=True),
            f"compressed_stream segment_sum_chunked_adaptive D={D}")
    return out


def plain_scale_graph_raises(g) -> str:
    """``compress_host``'s error on the scale phase's plain rMAT 2^22 graph:
    the reference's layout cannot hold it either."""
    from repro_torch.core import flat_graph as fg

    try:
        fg.compress_host(g)
    except ValueError as e:
        return str(e)
    raise AssertionError("compressed_scale: plain rMAT 2^22 did not raise")


def chunked_bound(s, e_valid: int, n_out: int, D: int, weighted: bool):
    """``bound`` with the dst read at the stream's real bytes."""
    from repro_torch.core import compressed as cz

    nbytes = cz.stream_nbytes(s) + e_valid * (4 * D + (4 if weighted else 0)) + n_out * 4 * D
    flops = e_valid * D * (2 if weighted else 1)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_compressed_scale(plain_raises: str) -> tuple:
    import torch

    from repro_torch.core import compressed as cz
    from repro_torch.core import flat_graph as fg
    from repro_torch.core.traversal import algorithms as talg
    from repro_torch.core.traversal import torch_backend as tb
    from repro_torch.kernels import delta_decode as dd
    from repro_torch.kernels import segment_reduce as sr

    t_phase = time.perf_counter()
    out = {"phase": "compressed_scale", "plain_rmat_2^22_raises": plain_raises,
           "allocated_at_start_bytes": torch.cuda.memory_allocated()}

    log_c, n_comm = 15, 128
    n = n_comm << log_c
    t0 = time.perf_counter()
    edges = rmat_symmetric_device(log_c, 2**25, seed=4, communities=n_comm)
    out.update(n=n, communities=n_comm, community_vertices=1 << log_c,
               edges_generated=int(edges.shape[0]), gen_s=time.perf_counter() - t0)
    g = fg.from_edges(n, edges, device="cuda")
    del edges
    m, cap = int(g.m), g.edge_capacity
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    slot_valid = torch.arange(cap, device="cuda") < m
    gw = g._replace(weights=torch.rand(cap, generator=gen, device="cuda") * slot_valid)
    out.update(m=m, edge_capacity=cap, raw_pool_bytes_per_edge=8 * cap / m)
    rng = np.random.default_rng(SEED + 4)
    srcs = rng.choice(np.flatnonzero(torch.diff(g.offsets).cpu().numpy() > 0), 16, replace=False)
    resets = rng.random((8, n))
    resets /= resets.sum(1, keepdims=True)
    iters = 10

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t

    raw = {}  # the raw engine on the same edges: answers and times
    for tag, graph in (("plain", g), ("weighted", gw)):
        eng = tb.TorchEngine(graph)
        r = raw[tag] = {}
        r["pr"], r["pagerank10_s"] = timed(lambda: talg.pagerank(eng, iters=iters))
        r["prm"], r["pagerank_multi8_s"] = timed(
            lambda: talg.pagerank_multi(eng, resets, iters=iters))
        if tag == "plain":
            (_, r["depths"]), r["bfs_batch16_s"] = timed(lambda: eng.bfs_batch(srcs))
        r["resident_bytes_per_edge"] = eng.resident_nbytes / m
        del eng
    out["raw_engine"] = {tag: {k: v for k, v in r.items() if k.endswith(("_s", "_edge"))}
                         for tag, r in raw.items()}

    def close(got, want, what):
        atol = 1e-6 * float(np.abs(want).max())
        rel = float((np.abs(got - want) / np.maximum(np.abs(want), atol)).max())
        if not (np.all(np.isfinite(got)) and np.allclose(got, want, rtol=PR_RTOL, atol=atol)):
            raise AssertionError(f"compressed_scale: {what} off (rel {rel})")
        return rel

    layouts, lanes = {}, {}
    sr.reset_launches()
    dd.reset_launches()
    for name, graph, kw in (("adaptive", g, {}), ("fixed2", g, {"width": 2}),
                            ("adaptive_weighted", gw, {}), ("fixed2_weighted", gw, {"width": 2})):
        tag = "weighted" if graph is gw else "plain"
        res = {}
        cg, res["compress_s"] = timed(lambda: fg.compress_host(graph, **kw))
        res["dst_bytes_per_edge"] = cz.stream_nbytes(cg.dst) / m
        res["pool_bytes_per_edge"] = cz.pytree_nbytes(cg) / m
        if name == "adaptive":
            stats = fg.chunk_stats(graph)
            if stats["bytes_ideal"] != cz.stream_nbytes(cg.dst):
                raise AssertionError("compressed_scale: resident bytes != bytes_ideal")
            res.update(bytes_ideal=stats["bytes_ideal"], wide_chunks=stats["n_wide"],
                       chunks=stats["fixed_chunks"], escapes_i16=stats["escapes_i16"])
        eng, res["engine_aux_s"] = timed(lambda: tb.CompressedEngine(cg))
        res["resident_bytes_per_edge"] = eng.resident_nbytes / m
        before = sum(sr.LAUNCHES.values())
        pr, res["pagerank10_s"] = timed(lambda: talg.pagerank(eng, iters=iters))
        res["launches_per_pagerank_iter"] = (sum(sr.LAUNCHES.values()) - before) / iters
        res["pagerank_max_rel_err_vs_raw"] = close(pr, raw[tag]["pr"], f"{name} pagerank")
        before = sum(sr.LAUNCHES.values())
        prm, res["pagerank_multi8_s"] = timed(lambda: talg.pagerank_multi(eng, resets, iters=iters))
        res["launches_per_pagerank_multi_iter"] = (sum(sr.LAUNCHES.values()) - before) / iters
        res["pagerank_multi_max_rel_err_vs_raw"] = close(prm, raw[tag]["prm"], f"{name} multi")
        (_, depths), res["bfs_batch16_s"] = timed(lambda: eng.bfs_batch(srcs))
        if not torch.equal(depths, raw["plain"]["depths"]):  # the same edges either way
            raise AssertionError(f"compressed_scale: {name} bfs depths differ from raw")
        res["max_depth"] = int(depths.max())
        layouts[name] = res
        lanes[name] = eng.caux
        del eng, cg
        torch.cuda.empty_cache()
    launches = {**sr.LAUNCHES, **dd.LAUNCHES}
    for k in CHUNKED_KERNELS + DECODE_KERNELS[:2]:
        if launches[k] == 0:
            raise AssertionError(f"compressed_scale: {k} was never launched: {launches}")
    out.update(layouts=layouts, launches=launches)

    # each chunked kernel at these shapes (the dst-major lane of the
    # layout's aux, n_out = n) against its plain version and against the
    # raw kernel on the decoded lane; these launches are not counted above
    cases = []
    for name, caux in lanes.items():
        s = caux.dst_sorted_c
        weighted = caux.w_by_dst is not None
        w = caux.w_by_dst
        dec = cz.decode_stream(s)
        e_valid = int((dec < n).sum())
        for D in (1, 8):
            msg = torch.rand((s.length, D), generator=gen, device="cuda")
            kern = lambda: chunked_call(s, msg, n, w)  # noqa: E731
            plain = lambda: chunked_call(s, msg, n, w, plain=True)  # noqa: E731
            if weighted:
                raw_k = lambda: sr.segment_sum_weighted_sorted(dec, w, msg, n)  # noqa: E731
            else:
                raw_k = lambda: sr.segment_sum_sorted(dec, msg, n)  # noqa: E731
            err = check_close(kern(), plain(), f"compressed_scale {name} D={D}")
            check_close(kern(), raw_k(), f"compressed_scale {name} vs raw kernel D={D}")
            bound_ms, bound_by = chunked_bound(s, e_valid, n, D, weighted)
            cases.append({
                "name": chunked_name(s, weighted), "layout": name, "D": D, "R": s.deltas.shape[0],
                "E_valid": e_valid, "n_out": n, "stream_bytes": cz.stream_nbytes(s),
                "max_abs_err": err, "ms": time_ms(kern), "plain_ms": time_ms(plain),
                "raw_kernel_ms": time_ms(raw_k), "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None,
            })
        del dec

    # each chunked decode kernel on its layout's source lane (the lane
    # every compressed PageRank iteration decodes; the weighted layouts
    # hold the same edges), against its plain version, exactly
    decode_cases = []
    for name in ("adaptive", "fixed2"):
        s = lanes[name].srcbd_c
        kern, plain = decode_calls(s)
        err = check_equal(kern(), plain(), f"compressed_scale {name} srcbd_c decode")
        bound_ms, bound_by = chunked_decode_bound(s)
        decode_cases.append({
            "name": "delta_decode_chunked" + ("_adaptive" if s.hi is not None else ""),
            "layout": name, "lane": "srcbd_c", "R": s.deltas.shape[0], "K": s.k,
            "wide": 0 if s.wide is None else int(s.wide.sum()),
            "escapes": int((s.ovf_pos < cz.CHUNK).sum()), "stream_bytes": cz.stream_nbytes(s),
            "max_abs_err": err, "ms": time_ms(kern), "plain_ms": time_ms(plain),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })
    out.update(kernels=cases, decode_kernels=decode_cases, phase_s=time.perf_counter() - t_phase)
    emit(out)
    return launches, cases + decode_cases


# ---------------------------------------------------------------------------
# GNN phases: GraphSAGE's sampled minibatch on the fanout kernel; GCN and
# the block SpMM at Cora's size
# ---------------------------------------------------------------------------

GNN_KERNELS = ("fanout_aggregate", "block_spmm")
# rMAT draws over 2^18 ids for minibatch_lg: symmetrized, deduplicated and
# with ids >= 232,965 dropped, 79.2 M draws leave 114,607,538 directed
# edges (gnn_sampled's ``m``), within 0.01% of minibatch_lg's 114,615,892.
REDDIT_DRAWS = 79_200_000
# power_law_graph(2708, 8500, seed=0) symmetrizes to 10,562 directed
# edges, within 0.1% of full_graph_sm's 10,556 (5278 draws give 6,592).
CORA_DRAWS = 8500


def time_ms_pipelined(fn, reps: int = 20) -> float:
    """Mean time of ``reps`` calls of ``fn`` issued back to back between
    two CUDA events, after one warm-up: the host's launch overhead
    overlaps the card's work, as it does inside a decode step."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def time_uncounted(fn, timer=None) -> float:
    """``time_ms`` (or ``timer``) of a kernel called only to be timed: the
    GNN and flash launch counts are put back afterwards, so they keep the
    main path's launches."""
    from repro_torch.kernels import csr_spmm
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import segment_reduce as sr

    saved = [(d, dict(d)) for d in (sr.LAUNCHES, csr_spmm.LAUNCHES, fd.LAUNCHES)]
    try:
        return (timer or time_ms)(fn)
    finally:
        for d, s in saved:
            d.update(s)


def fanout_bound(B: int, K: int, D: int):
    """Least time (ms) of one fanout reduce: features, mask and output
    once over HBM; a multiply and an add per feature over the f32 peak."""
    t_bytes = 4 * (B * K * D + B * K + B * D) / HBM_BYTES_PER_S
    t_ops = 2 * B * K * D / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def spmm_bound(mask_np, tiles_np, n_x: int, D: int):
    """Least time (ms) of a block SpMM on these inputs: a multiply-add per
    nonzero entry of the live tiles and output column (2 nnz D flops) over
    the f32 peak; the live tiles, the mask, x and the output once over
    HBM.  Returns (ms, bound_by, live tiles, nnz)."""
    live_mask = mask_np > 0
    live = int(live_mask.sum())
    nnz = int(np.count_nonzero(tiles_np[live_mask]))
    nr, nc, R, C = tiles_np.shape
    t_ops = 2 * nnz * D / F32_FLOP_PER_S
    t_bytes = 4 * (live * R * C + nr * nc + n_x * D + nr * R * D) / HBM_BYTES_PER_S
    return (1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), live,
            nnz)


def fanout_mask(B: int, K: int, kind: str, gen):
    """A (B, K) float32 mask on the card: ``bool`` 0/1 with column 0 set
    (as the reference's test makes it), ``fractional`` values in [0, 1)
    with zeros, ``empty`` the bool mask with every third bag empty."""
    import torch

    mask = (torch.rand((B, K), generator=gen, device="cuda") < 0.7).float()
    mask[:, 0] = 1.0
    if kind == "fractional":
        mask *= torch.rand((B, K), generator=gen, device="cuda")
    elif kind == "empty":
        mask[::3] = 0.0
    return mask


def phase_gnn_kernels() -> None:
    """Each GNN kernel against its plain version on the card: the fanout
    at B = 1, B not a multiple of 8, the reference's test shapes and the
    three full-width GraphSAGE launches, each op and mask kind; the SpMM
    at n = 256, 300, 2708 and D = 1, 16, 64, 1433 with a nonzero tile
    masked off and a row of empty tiles (rtol 1e-5, atol 1e-4)."""
    import torch

    from repro_torch.kernels import csr_spmm
    from repro_torch.kernels import segment_reduce as sr

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("gnn_kernels: TF32 matmul is on; the plain SpMM must be f32")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    fan_err, n_fan = 0.0, 0
    for B, K, D in [(1, 15, 602), (13, 10, 6), (16, 10, 64), (5, 25, 128),
                    (15_360, 10, 602), (1024, 15, 602), (1024, 15, 128)]:
        feats = torch.randn((B, K, D), generator=gen, device="cuda")
        for kind in ("bool", "fractional", "empty"):
            mask = fanout_mask(B, K, kind, gen)
            for op in sr.FANOUT_OPS:
                fan_err = max(fan_err, check_close(
                    sr.fanout_aggregate(feats, mask, op), sr.fanout_aggregate_plain(feats, mask, op),
                    f"fanout {op} {kind} {(B, K, D)}", rtol=1e-6))
                n_fan += 1
        del feats
    spmm = []
    for n in (256, 300, 2708):
        rng = np.random.default_rng(SEED + n)
        E = 4 * n
        src = rng.integers(0, n, E)
        dst = rng.integers(0, n - 128, E)  # the last row tile stays empty
        mask_np, tiles_np, _ = csr_spmm.tiles_from_edges(n, src, dst)
        forced = tuple(int(v) for v in np.argwhere(mask_np > 0)[0])
        mask_np[forced] = 0  # a nonzero tile masked off: it must contribute nothing
        mask, tiles = torch.from_numpy(mask_np).cuda(), torch.from_numpy(tiles_np).cuda()
        for D in (1, 16, 64, 1433):
            x = torch.randn((n, D), generator=gen, device="cuda")
            got = csr_spmm.block_spmm(mask, tiles, x)
            err = check_close(got, csr_spmm.block_spmm_plain(mask, tiles, x),
                           f"block_spmm n={n} D={D}", 1e-5, 1e-4)
            if bool(got[-128:].any()):
                raise AssertionError(f"block_spmm n={n} D={D}: the empty row tile is not zero")
            spmm.append({"n": n, "E": E, "D": D, "live_tiles": int((mask_np > 0).sum()),
                         "tiles": int(mask_np.size), "masked_nonzero_tile": forced,
                         "max_abs_err": err})
    emit({"phase": "gnn_kernels",
          "tolerance": {"fanout": "rtol 1e-6, atol 1e-6*max|out|",
                        "block_spmm": "rtol 1e-5, atol 1e-4"},
          "fanout_cases": n_fan, "fanout_max_abs_err": fan_err, "block_spmm_cases": spmm})


def phase_gnn_sampled() -> dict:
    """graphsage-reddit FULL on minibatch_lg: a card-resident flat graph
    of ~114.6 M rMAT edges over Reddit's 232,965 vertices, 602 features
    per vertex, four minibatches of B = 1024 at fanout (15, 10) with 512
    random edges streamed in before each batch after the first.  Each
    forward on the fanout kernel is held against the torch expression on
    the same sample (rtol 1e-5, atol 1e-5 * max|logits|), and every
    sampled id is checked to be an edge of the snapshot it was drawn from."""
    import torch

    from repro_torch.configs import graphsage_reddit
    from repro_torch.configs.registry import GNN_SHAPES
    from repro_torch.core import flat_ctree as fct
    from repro_torch.core import flat_graph as fg
    from repro_torch.data.pipeline import NeighborSampler
    from repro_torch.kernels import csr_spmm
    from repro_torch.kernels import segment_reduce as sr
    from repro_torch.models.gnn import graphsage

    cfg, shape = graphsage_reddit.FULL, GNN_SHAPES["minibatch_lg"]
    n, B, d = shape["n_nodes"], shape["batch_nodes"], shape["d_feat"]
    f1, f2 = shape["fanout"]
    torch.cuda.reset_peak_memory_stats()
    out = {"phase": "gnn_sampled", "config": cfg.name, "shape": "minibatch_lg", "n": n,
           "B": B, "fanout": [f1, f2], "d_feat": d, "d_hidden": cfg.d_hidden,
           "n_classes": cfg.n_classes, "allocated_at_start_bytes": torch.cuda.memory_allocated()}

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t

    def build():
        keys = rmat_keys_device(18, REDDIT_DRAWS, seed=15)
        keys = keys[((keys >> 32) < n) & ((keys & 0xFFFFFFFF) < n)]
        empty = fg.from_edges(n, np.zeros((0, 2), np.int64), device="cuda")
        return fg.insert_edges_device(empty, fct.from_device(keys, keys.numel()))

    g, out["build_s"] = timed(build)
    out.update(m=int(g.m), target_edges=shape["n_edges"], rmat_draws=REDDIT_DRAWS,
               edge_capacity=g.edge_capacity)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    feats = torch.randn((n, d), generator=gen, device="cuda")
    params = graphsage.init(gen, d, cfg.d_hidden, cfg.n_classes, device="cuda")
    l1 = params["layers"][0]
    rng = np.random.default_rng(SEED + 15)
    out["graph_peak_bytes"] = torch.cuda.max_memory_allocated()

    sr.reset_launches()
    csr_spmm.reset_launches()
    batches = []
    for step in range(4):
        res = {"step": step}
        if step:
            new = torch.from_numpy(rng.integers(0, n, (512, 2))).cuda()
            m_before = int(g.m)
            g, res["insert_s"] = timed(lambda: fg.insert_edges_device(
                g, fct.from_device((new[:, 0] << 32) | new[:, 1], 512)))
            if not bool(fg.has_edge(g, new[:, 0], new[:, 1]).all()):
                raise AssertionError("gnn_sampled: an inserted edge is missing")
            res["inserted"] = int(g.m) - m_before
        sampler = NeighborSampler(g.offsets, g.keys[: int(g.m)] & 0xFFFFFFFF, feats)
        sample, res["host_draw_s"] = timed(lambda: sampler.sample_ids(SEED, step, B, (f1, f2)))
        b, res["device_gather_s"] = timed(lambda: sampler.gather(sample))
        before = sr.LAUNCHES["fanout_aggregate"]
        logits, res["forward_s"] = timed(lambda: graphsage.forward_sampled(
            params, b["x_self"], b["neigh_feats"], b["neigh_masks"], use_kernel=True))
        res["launches"] = sr.LAUNCHES["fanout_aggregate"] - before
        if res["launches"] != 3:
            raise AssertionError(f"gnn_sampled: {res['launches']} fanout launches, not 3")
        plain, res["forward_plain_s"] = timed(lambda: graphsage.forward_sampled(
            params, b["x_self"], b["neigh_feats"], b["neigh_masks"], use_kernel=False))
        if tuple(logits.shape) != (B, cfg.n_classes) or not bool(logits.isfinite().all()):
            raise AssertionError(f"gnn_sampled: logits {tuple(logits.shape)} not finite")
        res["max_abs_err"] = check_close(logits, plain, f"gnn_sampled step {step}", 1e-5,
                                      1e-5 * float(plain.abs().max()))
        # the sample is real: each valid pick is an edge of this snapshot
        (n1, n2), (m1, m2) = sample["ids"], sample["neigh_masks"]
        seeds = sample["seeds"]
        deg = torch.diff(g.offsets)
        if not (torch.equal(m1, (deg[seeds] > 0)[:, None].expand(-1, f1))
                and bool(fg.has_edge(g, seeds[:, None].expand(-1, f1)[m1], n1[m1]).all())
                and bool(fg.has_edge(g, n1[:, :, None].expand(-1, -1, f2)[m2], n2[m2]).all())):
            raise AssertionError(f"gnn_sampled step {step}: a sampled pick is not an edge")
        res["valid_picks"] = [int(m1.sum()), int(m2.sum())]
        # each launch of this forward, timed alone on its own inputs
        nf0, nf1 = b["neigh_feats"]
        mf1, mf2 = m1.float(), m2.reshape(-1, f2).float()
        agg2 = sr.fanout_aggregate_plain(nf1.reshape(-1, f2, d), mf2).reshape(B, f1, d)
        h1 = torch.relu(nf0 @ l1["w_self"] + agg2 @ l1["w_neigh"])
        launches = []
        for f, m in ((nf1.reshape(-1, f2, d), mf2), (nf0, mf1), (h1, mf1)):
            bound_ms, bound_by = fanout_bound(*f.shape)
            launches.append({"shape": list(f.shape), "read_bytes": 4 * f.numel(),
                             "ms": time_uncounted(lambda: sr.fanout_aggregate(f, m, "mean")),
                             "bound_ms": bound_ms, "bound_by": bound_by})
        res["fanout_launches"] = launches
        batches.append(res)
        emit({"phase": "gnn_sampled_batch", **res})
    out["launches"] = dict(sr.LAUNCHES)  # read just after the main path
    if out["launches"]["fanout_aggregate"] != 12:
        raise AssertionError(f"gnn_sampled: {out['launches']} (12 fanout launches expected)")
    out["batches"] = batches
    # the kernel row: the largest launch of the last batch, as a sum, so
    # that one library call (einsum) computes the same function; the
    # path's own op, mean, is timed beside it
    f, m = nf1.reshape(-1, f2, d), mf2
    kern = sr.fanout_aggregate(f, m, "sum")
    bound_ms, bound_by = fanout_bound(*f.shape)
    out["fanout_row"] = {
        "shape": list(f.shape), "op": "sum",
        "max_abs_err": check_close(kern, sr.fanout_aggregate_plain(f, m, "sum"),
                                   "gnn_sampled fanout row", rtol=1e-6),
        "ms": time_uncounted(lambda: sr.fanout_aggregate(f, m, "sum")),
        "mean_ms": time_uncounted(lambda: sr.fanout_aggregate(f, m, "mean")),
        "plain_ms": time_ms(lambda: sr.fanout_aggregate_plain(f, m, "sum")),
        "library_ms": time_ms(lambda: torch.einsum("bkd,bk->bd", f, m)),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    emit(out)
    return out


def phase_gnn_full() -> dict:
    """gcn-cora FULL on full_graph_sm: ``power_law_graph(2708, 8500)``
    (10,562 directed edges) in a card flat graph, ``batch_from_flat_graph``
    and ``gcn.forward`` held against the same forward on the CPU; then
    ``ops.spmm_from_edges`` on those edges with GCN's normalized weights at
    D = 16 and 1433, held against GCN's own segment-sum aggregation and
    against the plain SpMM, and timed beside CSR ``torch.sparse.mm``."""
    import torch

    from repro_torch.configs import gcn_cora
    from repro_torch.configs.registry import GNN_SHAPES
    from repro_torch.core import flat_graph as fg
    from repro_torch.data.pipeline import power_law_graph
    from repro_torch.kernels import csr_spmm, ops
    from repro_torch.kernels import segment_reduce as sr
    from repro_torch.models.gnn import common, gcn

    cfg, shape = gcn_cora.FULL, GNN_SHAPES["full_graph_sm"]
    n, d = shape["n_nodes"], shape["d_feat"]
    offsets, nbrs = power_law_graph(n, CORA_DRAWS, seed=SEED)
    edges = np.stack([np.repeat(np.arange(n), np.diff(offsets)), nbrs], 1)
    out = {"phase": "gnn_full", "config": cfg.name, "shape": "full_graph_sm", "n": n,
           "d_feat": d, "power_law_draws": CORA_DRAWS, "edges": int(edges.shape[0]),
           "target_edges": shape["n_edges"]}
    g = fg.from_edges(n, edges, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    x = torch.randn((n, d), generator=gen, device="cuda")
    params = gcn.init(gen, d, cfg.d_hidden, cfg.n_classes, device="cuda")

    sr.reset_launches()
    csr_spmm.reset_launches()
    batch = common.batch_from_flat_graph(g, x)
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits = gcn.forward(params, batch)
    torch.cuda.synchronize()
    out["gcn_forward_s"] = time.perf_counter() - t
    if tuple(logits.shape) != (n, cfg.n_classes) or not bool(logits.isfinite().all()):
        raise AssertionError(f"gnn_full: logits {tuple(logits.shape)} not finite")
    cpu = gcn.forward({"ws": [w.cpu() for w in params["ws"]]},
                      common.GraphBatch(*(v.cpu() for v in batch)))
    out["gcn_vs_cpu_max_abs_err"] = check_close(logits.cpu(), cpu, "gnn_full gcn vs cpu", 1e-5,
                                             1e-5 * float(cpu.abs().max()))
    m = int(g.m)
    src, dst = batch.src[:m], batch.dst[:m]
    coeff = common.sym_norm_coeff(batch)[:m]
    src_h, dst_h, vals_h = src.cpu().numpy(), dst.cpu().numpy(), coeff.cpu().numpy()
    runs = []
    for D, xd in ((cfg.d_hidden, x @ params["ws"][0]), (d, x)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = ops.spmm_from_edges(n, src_h, dst_h, xd, vals_h)
        torch.cuda.synchronize()
        runs.append((D, xd, got, time.perf_counter() - t))
    out["launches"] = {**sr.LAUNCHES, **csr_spmm.LAUNCHES}  # read just after the main path
    if out["launches"]["block_spmm"] != 2:
        raise AssertionError(f"gnn_full: {out['launches']} (2 block_spmm launches expected)")
    a = torch.sparse_coo_tensor(torch.stack([dst.long(), src.long()]), coeff,
                                (n, n)).coalesce().to_sparse_csr()
    mask_np, tiles_np, _ = csr_spmm.tiles_from_edges(n, src_h, dst_h, vals_h)
    mask, tiles = torch.from_numpy(mask_np).cuda(), torch.from_numpy(tiles_np).cuda()
    cases = []
    for D, xd, got, secs in runs:
        res = {"D": D, "spmm_from_edges_s": secs}
        agg = common.aggregate(xd[src.long()] * coeff[:, None], dst, n, "sum")
        res["vs_segment_sum_max_abs_err"] = check_close(got, agg, f"gnn_full spmm D={D} vs segsum",
                                                     1e-5, 1e-4)
        first = csr_spmm.block_spmm(mask, tiles, xd)
        if not torch.equal(first, csr_spmm.block_spmm(mask, tiles, xd)):
            raise AssertionError(f"gnn_full block_spmm D={D}: two calls differ in their bits")
        res["max_abs_err"] = check_close(first, csr_spmm.block_spmm_plain(mask, tiles, xd),
                                      f"gnn_full block_spmm D={D}", 1e-5, 1e-4)
        res["same_bits_twice"] = True
        res["bound_ms"], res["bound_by"], res["live_tiles"], res["nnz"] = spmm_bound(
            mask_np, tiles_np, n, D)
        res["tiles"] = int(mask_np.size)
        res["workspace_bytes"] = csr_spmm.workspace_bytes(*mask_np.shape)
        res["ms"] = time_ms(lambda: csr_spmm.block_spmm(mask, tiles, xd))
        res["plain_ms"] = time_ms(lambda: csr_spmm.block_spmm_plain(mask, tiles, xd))
        res["library_ms"] = time_ms(lambda: torch.sparse.mm(a, xd))
        cases.append(res)
    out["spmm"] = cases
    emit(out)
    return out


# ---------------------------------------------------------------------------
# LM phases: dense decode on the flash-decode kernel (smollm-360m FULL)
# ---------------------------------------------------------------------------

# Flash decode against its plain version: float32 rtol 2e-5, atol 2e-5 *
# max|out| (split sums against cuBLAS float32 products, in another
# order); bf16 rtol 1e-2, atol 1e-2 * max|out| (both round a float32
# result to bf16: one bf16 ulp is 2^-8 relative).
FLASH_TOL = {"float32": 2e-5, "bfloat16": 1e-2}
# A bf16 decode step's logits through the kernel against the same step
# without it.  The non-flash path rounds its scores and softmax weights to
# bf16 before the PV product (repro/models/layers.py:258-263) where the
# kernel keeps float32; scores near 30 carry a bf16 step of 0.125, so the
# two attention outputs already differ by a few percent, and every later
# layer rounds its own products to bf16.  Over 32 layers of random
# weights the logits drift apart as far as the bf16 model drifts from its
# float32 version (lm_serve's bf16_drift measures that on one step of its
# 8-layer check model), so this only tells a working path from a broken
# one: rtol 0.25, atol 0.25 * max|logits|.  The kernel itself is held to
# one bf16 rounding (FLASH_TOL) on layer 0 of the same step, and the
# whole decode path to rtol 1e-4 in float32 in lm_serve.
LM_BF16_RTOL = 0.25
# make_prefill's float32 last-position logits against the token-by-token
# float32 decode of the same prompt: two float32 orders of summation over
# the layers (blockwise prefill attention against the kernel's splits).
PREFILL_RTOL = 1e-4
SERVE_CHECK_LAYERS = 8


def flash_tol(want) -> dict:
    import torch

    r = FLASH_TOL["float32" if want.dtype == torch.float32 else "bfloat16"]
    return {"rtol": r, "atol": r * max(float(want.float().abs().max()), 1e-30)}


def flash_bound(keys: int, rows: int, Q: int, d: int, kv_bytes: int, q_bytes: int):
    """Least time (ms) of one flash decode over ``keys`` valid cache rows
    (summed over the rows): those K and V rows, q, the lengths and the
    output once over HBM; a multiply-add for the score and one for the
    output per cached element (4 Q d flops per key) over the f32 peak."""
    nbytes = 2 * keys * d * kv_bytes + 2 * rows * Q * d * q_bytes + 4 * rows
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 4 * keys * Q * d / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def flash_route(fn):
    """(fn(), the route its one flash call took: "tma" or "cpasync")."""
    from repro_torch.kernels import flash_decode as fd

    before = dict(fd.LAUNCHES)
    out = fn()
    routes = [r for r in ("tma", "cpasync")
              if fd.LAUNCHES["flash_decode_" + r] > before["flash_decode_" + r]]
    if len(routes) != 1 or fd.LAUNCHES["flash_decode"] != before["flash_decode"] + 1:
        raise AssertionError(f"flash call: routes {routes}, launches {fd.LAUNCHES} from {before}")
    return out, routes[0]


def phase_flash_kernels() -> None:
    """The flash-decode kernel against its plain version, in float32 and
    bf16: the reference's test shapes, S = 1000, lengths 0, 1 and 7 beside
    random lengths in [S/2, S], d = 12, an f32 query over a bf16 cache,
    and strided (B, S_max, n_kv, d) cache slices at the three FULL
    configs' (Q, d)."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.kernels import flash_decode as fd

    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    rows = []
    for BH, Q, S, d in [(4, 8, 1024, 64), (2, 4, 2048, 128), (1, 8, 640, 64), (4, 3, 1000, 64),
                        (4, 8, 2048, 64), (5, 1, 100, 12), (3, 16, 777, 256)]:
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dt)
                       for shape in ((BH, Q, d), (BH, S, d), (BH, S, d)))
            lens = torch.randint(S // 2, S + 1, (BH,), generator=gen, device="cuda",
                                 dtype=torch.int32)
            if BH >= 4:
                lens[:3] = torch.tensor([0, 1, 7], dtype=torch.int32)
            got, route = flash_route(lambda: fd.flash_decode(q, k, v, lens))
            want = fd.flash_decode_plain(q, k, v, lens)
            err = check_close(got, want, f"flash_decode {(BH, Q, S, d)} {dt}", **flash_tol(want))
            if BH >= 4 and bool(got[0].any()):
                raise AssertionError(f"flash_decode {(BH, Q, S, d)}: a length-0 row is not 0")
            rows.append({"shape": [BH, Q, S, d], "dtype": str(dt)[6:], "route": route,
                         "max_abs_err": err})
    q = torch.randn((4, 3, 64), generator=gen, device="cuda")
    k, v = (torch.randn((4, 999, 64), generator=gen, device="cuda").bfloat16() for _ in "kv")
    lens = torch.tensor([999, 500, 3, 0], dtype=torch.int32, device="cuda")
    want = fd.flash_decode_plain(q, k, v, lens)
    got, route = flash_route(lambda: fd.flash_decode(q, k, v, lens))
    rows.append({"shape": [4, 3, 999, 64], "dtype": "float32 q, bfloat16 cache", "route": route,
                 "max_abs_err": check_close(got, want, "flash_decode f32 q bf16 cache",
                                            **flash_tol(want))})
    for arch in ("smollm-360m", "qwen2.5-3b", "starcoder2-7b"):
        cfg = registry.get(arch).full
        Q, d, n_kv = cfg.n_heads // cfg.n_kv_heads, cfg.head_dim, cfg.n_kv_heads
        for dt in (torch.float32, torch.bfloat16):
            B, S_max = 3, 4096
            cache = torch.randn((2, 2, B, S_max, n_kv, d), generator=gen, device="cuda").to(dt)
            q = torch.randn((B, n_kv, Q, d), generator=gen, device="cuda").to(dt)
            lens = torch.randint(S_max // 2, S_max + 1, (B,), generator=gen, device="cuda",
                                 dtype=torch.int32)
            kc, vc = cache[0, 1], cache[1, 1]  # layer slices, read where they lie
            want = fd.flash_decode_cache_plain(q, kc, vc, lens)
            got, route = flash_route(lambda: fd.flash_decode_cache(q, kc, vc, lens))
            err = check_close(got, want, f"flash_decode_cache {arch} {dt}", **flash_tol(want))
            if dt == torch.bfloat16 and route != "tma":
                raise AssertionError(f"flash_decode_cache {arch} bf16: {route} route, not tma")
            rows.append({"cache": [B, S_max, n_kv, d], "Q": Q, "arch": arch,
                         "dtype": str(dt)[6:], "route": route, "max_abs_err": err})
            del cache
    emit({"phase": "flash_kernels",
          "tolerance": {k: f"rtol {v}, atol {v}*max|out|" for k, v in FLASH_TOL.items()},
          "cases": rows})


def _layer0_query(params, cfg, cache, token):
    """The q (B, n_kv, Q, d) that layer 0 hands the kernel for ``token``
    at the cache's current lengths."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    lp = T._layer(params["layers"], 0)
    x = T._norm(cfg, lp["ln1"], L.embed(params["embed"], token[:, None]))
    q, _, _ = L._qkv(lp["attn"], cfg.attn_config, x, cache["len"][:, None])
    B = token.shape[0]
    return q.reshape(B, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim)


def lm_decode_steps(name: str, params, cfg, cache, tokens) -> dict:
    """Decode ``tokens`` (steps, B) on the kernel: the main path, with the
    counts set to 0 before it and read after.  After each step the same
    step without the kernel runs from the same cache state (the slots the
    step wrote are saved, restored for the plain step, and put back), and
    the logits are held against each other at the bf16 tolerance; layer
    0's kernel call is held against its plain version."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models import transformer as T

    B = tokens.shape[1]
    rows = torch.arange(B, device="cuda")
    out = {"steps": [], "launches_per_step": []}
    fd.reset_launches()
    for step, tok in enumerate(tokens):
        res = {"step": step, "cache_len": cache["len"].tolist() if B <= 4 else None}
        slot = torch.clamp(cache["len"].long(), max=cache["k"].shape[2] - 1)
        pre = (cache["k"][:, rows, slot].clone(), cache["v"][:, rows, slot].clone())
        before, before_tma = fd.LAUNCHES["flash_decode"], fd.LAUNCHES["flash_decode_tma"]
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, new = T.decode_step(params, cfg, cache, tok, use_flash_kernel=True)
        torch.cuda.synchronize()
        res["step_ms"] = 1e3 * (time.perf_counter() - t)
        launches = fd.LAUNCHES["flash_decode"] - before
        tma = fd.LAUNCHES["flash_decode_tma"] - before_tma
        if launches != cfg.n_layers or tma != launches:
            raise AssertionError(f"{name} step {step}: {launches} flash launches, {tma} on the "
                                 f"TMA route, not {cfg.n_layers} each")
        out["launches_per_step"].append(launches)
        if tuple(logits.shape) != (B, cfg.vocab) or not bool(logits.isfinite().all()):
            raise AssertionError(f"{name} step {step}: logits {tuple(logits.shape)} not finite")
        post = (cache["k"][:, rows, slot].clone(), cache["v"][:, rows, slot].clone())
        cache["k"][:, rows, slot], cache["v"][:, rows, slot] = pre
        torch.cuda.synchronize()
        t = time.perf_counter()
        plain, _ = T.decode_step(params, cfg, cache, tok, use_flash_kernel=False)
        torch.cuda.synchronize()
        res["plain_step_ms"] = 1e3 * (time.perf_counter() - t)
        cache["k"][:, rows, slot], cache["v"][:, rows, slot] = post
        res["logits_vs_plain_max_abs_err"] = check_close(
            logits, plain, f"{name} step {step} logits", LM_BF16_RTOL,
            LM_BF16_RTOL * float(plain.abs().max()))
        res["logits_vs_plain_rel_l2"] = float(((logits - plain).norm(dim=-1)
                                               / plain.norm(dim=-1)).max())
        res["greedy_agree"] = int((logits.argmax(-1) == plain.argmax(-1)).sum())
        cache = new
        out["steps"].append(res)
    out["launches"] = dict(fd.LAUNCHES)  # read just after the main path
    q0 = _layer0_query(params, cfg, {"len": cache["len"] - 1}, tokens[-1])
    lens = cache["len"]  # the last step's lengths, its own token included
    kc, vc = cache["k"][0], cache["v"][0]
    want = fd.flash_decode_cache_plain(q0, kc, vc, lens)
    got = fd.flash_decode_cache(q0, kc, vc, lens)  # a comparison, after the count was read
    keys = int(torch.clamp(lens, max=kc.shape[1]).sum()) * cfg.n_kv_heads
    bound_ms, bound_by = flash_bound(keys, B * cfg.n_kv_heads, q0.shape[2], cfg.head_dim,
                                     kc.element_size(), q0.element_size())
    sdpa_q = q0.reshape(B, cfg.n_heads, 1, cfg.head_dim)
    out["kernel"] = {
        "shape": {"B": B, "n_kv": cfg.n_kv_heads, "Q": q0.shape[2], "d": cfg.head_dim,
                  "S_max": kc.shape[1], "valid_keys": keys},
        "max_abs_err": check_close(got, want, f"{name} layer 0 kernel", **flash_tol(want)),
        "ms": time_uncounted(lambda: fd.flash_decode_cache(q0, kc, vc, lens)),
        "pipelined_ms": time_uncounted(lambda: fd.flash_decode_cache(q0, kc, vc, lens),
                                       time_ms_pipelined),
        "plain_ms": time_ms(lambda: fd.flash_decode_cache_plain(q0, kc, vc, lens)),
        # yardstick only: SDPA over every position (no length mask), the
        # cache as a transposed view
        "library_ms": time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            sdpa_q, kc.transpose(1, 2), vc.transpose(1, 2), enable_gqa=True)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "plan": dict(zip(("n_split", "chunk", "keys_per_tile", "stages", "smem_bytes"),
                         fd._plan(B * cfg.n_kv_heads, kc.shape[1], q0.shape[2], cfg.head_dim,
                                  int(kc.dtype == torch.bfloat16), 1, kc.device))),
        "route": flash_route(lambda: fd.flash_decode_cache(q0, kc, vc, lens))[1],
    }
    k = out["kernel"]
    k["workspace_bytes"] = 4 * fd.workspace_floats(B * cfg.n_kv_heads, k["plan"]["n_split"],
                                                   q0.shape[2], cfg.head_dim)
    k["tma_map_encode_ns"] = tma_map_ns(kc, k["plan"]["keys_per_tile"])
    # the per-call host cost of setting a C function's argtypes on every
    # call (as the wrapper did before it kept them): pipelined, back to back
    key = ("flash_decode", "repro_flash_decode")

    def fresh_argtypes():
        _build._fns.pop(key, None)
        fd.flash_decode_cache(q0, kc, vc, lens)

    k["pipelined_ms_argtypes_per_call"] = time_uncounted(fresh_argtypes, time_ms_pipelined)
    return out


def tma_map_ns(kc, box_rows: int) -> float:
    """ns per cuTensorMapEncodeTiled call for a tensor map of the cache
    slice ``kc`` (B, S_max, n_kv, d), the mean of 1000 in C
    (``repro_flash_tma_map_ns``); the kernel's wrapper encodes two a call."""
    import ctypes

    from repro_torch.kernels import _build

    fn = _build.c_function(
        "flash_decode", "repro_flash_tma_map_ns",
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_void_p])
    out = (ctypes.c_double * 1)()
    B, S, n_kv, d = kc.shape
    rc = fn(kc.data_ptr(), int(kc.element_size() == 2), d, n_kv, S, B, kc.stride(0),
            kc.stride(1), kc.stride(2), box_rows, 1000, out, None)
    if rc != 0:
        raise RuntimeError(f"repro_flash_tma_map_ns: cudaError {rc}")
    return out[0]


def lm_decode_phase(phase: str, shape_name: str, B: int, n_steps: int, seed: int,
                    start_lens) -> dict:
    """smollm-360m FULL, bf16 weights and a bf16 cache of the shape's
    length drawn on the card as a stand-in for a prefilled history, at
    ``start_lens(S_max, gen)``, then ``n_steps`` checked decode steps
    (``lm_decode_steps``)."""
    import torch

    from repro_torch.configs import smollm_360m
    from repro_torch.configs.registry import LM_SHAPES
    from repro_torch.models import transformer as T

    cfg, shape = smollm_360m.FULL, LM_SHAPES[shape_name]
    S_max = shape["seq_len"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = T.init_params(gen, cfg, dtype=torch.bfloat16, device="cuda")
    cache = T.init_kv_cache(cfg, B, S_max, dtype=torch.bfloat16, device="cuda")
    for i in range(cfg.n_layers):
        cache["k"][i].normal_(generator=gen)
        cache["v"][i].normal_(generator=gen)
    cache["len"] = start_lens(S_max, gen)
    tokens = torch.randint(0, cfg.vocab, (n_steps, B), generator=gen, device="cuda")
    torch.cuda.synchronize()
    out = {"phase": phase, "config": cfg.name, "shape": shape_name, "B": B,
           "global_batch": shape["global_batch"], "S_max": S_max, "dtype": "bfloat16",
           "start_len_min_max": [int(cache["len"].min()), int(cache["len"].max())],
           "cache_bytes": 2 * cache["k"].numel() * cache["k"].element_size(),
           "setup_s": time.perf_counter() - t0}
    out.update(lm_decode_steps(phase, params, cfg, cache, tokens))
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    emit(out)
    return out


def phase_lm_decode_long() -> dict:
    """smollm-360m FULL on long_500k: B = 1, S_max = 524,288, a 21.5 GB
    bf16 cache at cache_len = S_max - 4 (prefilling 524,288 tokens is not
    feasible in this script's time), then four decode steps through the
    kernel that fill the last four slots."""
    import torch

    return lm_decode_phase("lm_decode_long", "long_500k", 1, 4, SEED + 18,
                           lambda S, gen: torch.full((1,), S - 4, dtype=torch.int32,
                                                     device="cuda"))


def phase_lm_decode_32k() -> dict:
    """smollm-360m FULL on decode_32k at B = 32, cut from its global batch
    of 128 (the bf16 cache would take 172 GB; at 32 it is 42.9 GB):
    ragged cache lengths drawn in [16,384, 32,767], three decode steps."""
    import torch

    return lm_decode_phase("lm_decode_32k", "decode_32k", 32, 3, SEED + 19,
                           lambda S, gen: torch.randint(S // 2, S, (32,), generator=gen,
                                                        device="cuda", dtype=torch.int32))


def bf16_drift(params, cfg, cache, token) -> dict:
    """How far one decode step of the bf16 model lies from its float32
    version, through the kernel and without it: the same weights and
    cache rounded to bf16 (norm scales stay float32, as ``init_params``
    keeps them), max|difference| / max|float32 logits|.  Measured, not
    checked; the reason for LM_BF16_RTOL.  Its launches are not counted."""
    import torch

    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models import transformer as T

    def bf16(tree, norm=False):
        if isinstance(tree, dict):
            return {k: bf16(v, norm or k.startswith("ln")) for k, v in tree.items()}
        return tree if norm else tree.bfloat16()

    def step(p, dtype, flash):
        c = {"k": cache["k"].to(dtype, copy=True), "v": cache["v"].to(dtype, copy=True),
             "len": cache["len"].clone()}
        return T.decode_step(p, cfg, c, token, use_flash_kernel=flash)[0]

    saved = dict(fd.LAUNCHES)
    p16 = bf16(params)
    f32 = step(params, torch.float32, True)
    flash, plain = step(p16, torch.bfloat16, True), step(p16, torch.bfloat16, False)
    fd.LAUNCHES.update(saved)
    scale = float(f32.abs().max())
    return {"flash_vs_f32": float((flash - f32).abs().max()) / scale,
            "plain_vs_f32": float((plain - f32).abs().max()) / scale,
            "flash_vs_plain": float((flash - plain).abs().max()) / scale,
            "max_abs_f32_logit": scale}


def phase_lm_serve() -> dict:
    """The serving entry points at smollm-360m's full width: ``make_prefill``
    at B = 1, S = 3072 (the blockwise ``chunked`` path) in float32, held
    against the token-by-token decode of the same prompt through
    ``make_serve_step`` on the kernel with a float32 cache (rtol 1e-4),
    with the depth cut to SERVE_CHECK_LAYERS; then ``generate`` on the
    kernel in bf16 with all 32 layers on 8 prompts of 5-32 tokens,
    left-padded as ``batched_request_server`` pads them, 16 new tokens."""
    import torch

    from repro_torch.configs import smollm_360m
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models import transformer as T
    from repro_torch.serve import decode as serve

    cfg = smollm_360m.FULL
    # the 3072-step check at smollm's width and 8 of its 32 layers: an
    # eager step costs 1-2 ms of host time per layer, and with all 32
    # layers the check took 172 s of this script's 1200 s
    check = dataclasses.replace(cfg, n_layers=SERVE_CHECK_LAYERS)
    out = {"phase": "lm_serve", "config": cfg.name, "check_layers": check.n_layers}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    params = T.init_params(gen, check, dtype=torch.float32, device="cuda")
    S = 3072
    prompt = torch.randint(0, cfg.vocab, (1, S), generator=gen, device="cuda")
    torch.cuda.synchronize()
    t = time.perf_counter()
    want = serve.make_prefill(check)(params, prompt)
    torch.cuda.synchronize()
    out["prefill"] = {"B": 1, "S": S, "dtype": "float32", "s": time.perf_counter() - t}
    step = serve.make_serve_step(check, use_flash_kernel=True)
    # one slot more than the prompt, for the drift step below
    cache = T.init_kv_cache(check, 1, S + 1, dtype=torch.float32, device="cuda")
    fd.reset_launches()
    t = time.perf_counter()
    for s in range(S):
        logits, cache = step(params, cache, prompt[:, s])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    out["token_by_token"] = {"steps": S, "s": dt, "ms_per_step": 1e3 * dt / S,
                             "launches": dict(fd.LAUNCHES)}
    launches = fd.LAUNCHES["flash_decode"]
    if launches != S * check.n_layers or fd.LAUNCHES["flash_decode_tma"] != launches:
        raise AssertionError(f"lm_serve: {fd.LAUNCHES} flash launches, not {S * check.n_layers} "
                             "on the TMA route")
    out["prefill"]["vs_decode_max_abs_err"] = check_close(
        logits, want, "lm_serve prefill vs decode", PREFILL_RTOL,
        PREFILL_RTOL * float(want.abs().max()))
    out["bf16_drift"] = bf16_drift(params, check, cache, logits.argmax(-1))
    del params, cache, logits, want
    gc.collect()
    torch.cuda.empty_cache()

    params = T.init_params(gen, cfg, dtype=torch.bfloat16, device="cuda")
    lens = torch.randint(5, 33, (8,), generator=gen, device="cuda").tolist()
    requests = [torch.randint(1, cfg.vocab, (n,), generator=gen, device="cuda") for n in lens]
    prompt = serve.pad_requests(requests)
    max_new = 16
    fd.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    toks = serve.generate(params, cfg, prompt, max_new, use_flash_kernel=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    n_steps = prompt.shape[1] + max_new - 1
    gen_launches = fd.LAUNCHES["flash_decode"]
    if gen_launches != n_steps * cfg.n_layers or fd.LAUNCHES["flash_decode_tma"] != gen_launches:
        raise AssertionError(f"lm_serve generate: {gen_launches} flash launches, "
                             f"not {n_steps * cfg.n_layers}")
    S0 = prompt.shape[1]
    new = toks[:, S0:]
    if (tuple(toks.shape) != (8, S0 + max_new) or not torch.equal(toks[:, :S0], prompt)
            or int(new.min()) < 0 or int(new.max()) >= cfg.vocab):
        raise AssertionError(f"lm_serve generate: tokens {tuple(toks.shape)} out of shape "
                             "or range")
    out["generate"] = {"B": 8, "prompt_lens": lens, "padded_to": S0,
                       "max_new": max_new, "dtype": "bfloat16", "s": dt,
                       "tokens_per_s": 8 * max_new / dt, "decode_steps": n_steps,
                       "launches": gen_launches}
    out["launches"] = launches + gen_launches
    emit(out)
    return out


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
    # float32 products in full float32 (the default, set here explicitly):
    # the plain versions and the float32 model comparisons depend on it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    seconds = {}  # wall time of each phase, host clock

    def run(name, fn, *args):
        t = time.perf_counter()
        res = fn(*args)
        seconds[name] = time.perf_counter() - t
        return res

    t_start = time.perf_counter()
    run("env", phase_env, smi)
    run("kernels", phase_kernels)
    run("decode_kernels", phase_decode_kernels)
    stream_launches, plain_stream = run("stream", phase_stream)
    host_launches = run("host_decode", phase_host_decode, plain_stream)
    g, aux, scale_launches = run("scale", phase_scale)
    cases = run("scale_kernels", phase_scale_kernels, g, aux)
    padded = run("scale_decode", phase_scale_decode, g)
    plain_raises = plain_scale_graph_raises(g)
    del g, aux  # the 2^22 flat scale graph leaves the card here
    gc.collect()
    torch.cuda.empty_cache()
    run("compressed_kernels", phase_compressed_kernels)
    cstream_launches = run("compressed_stream", phase_compressed_stream, plain_stream)
    del plain_stream
    cscale_launches, ccases = run("compressed_scale", phase_compressed_scale, plain_raises)
    gc.collect()  # the compressed scale pools leave the card here
    torch.cuda.empty_cache()
    run("gnn_kernels", phase_gnn_kernels)
    sampled = run("gnn_sampled", phase_gnn_sampled)
    gc.collect()
    torch.cuda.empty_cache()
    full = run("gnn_full", phase_gnn_full)
    gc.collect()  # the GNN graphs and features leave the card here
    torch.cuda.empty_cache()
    run("flash_kernels", phase_flash_kernels)
    long = run("lm_decode_long", phase_lm_decode_long)
    gc.collect()  # the 21.5 GB long_500k cache leaves the card here
    torch.cuda.empty_cache()
    d32k = run("lm_decode_32k", phase_lm_decode_32k)
    gc.collect()
    torch.cuda.empty_cache()
    lm_serve = run("lm_serve", phase_lm_serve)
    emit({"phase_seconds": seconds, "total_s": time.perf_counter() - t_start})

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
    replaces = dict(zip(CHUNKED_KERNELS, ("229", "271", "410", "454")))
    for name in CHUNKED_KERNELS:
        c = next(c for c in ccases if c["name"] == name and c["D"] == 1)
        summary.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/segment_reduce.cu",
            "replaces": "src/repro/kernels/segment_reduce.py:" + replaces[name],
            "launches": cstream_launches[name] + cscale_launches[name],
            "max_abs_err": c["max_abs_err"],
            "ms": c["ms"],
            "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"],
            "library_ms": None,
            "raw_kernel_ms": c["raw_kernel_ms"],
        })
    replaces = dict(zip(DECODE_KERNELS, ("83", "162", "210")))
    for name in DECODE_KERNELS:
        if name == "delta_decode_padded":
            c, launches = padded, host_launches[name]
        else:
            c = next(c for c in ccases if c["name"] == name)
            launches = cstream_launches[name] + cscale_launches[name]
        summary.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/delta_decode.cu",
            "replaces": "src/repro/kernels/delta_decode.py:" + replaces[name],
            "launches": launches,
            "max_abs_err": c["max_abs_err"],
            "ms": c["ms"],
            "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"],
            "library_ms": c["library_ms"],
        })
    row = sampled["fanout_row"]
    summary.append({
        "name": "fanout_aggregate",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fanout.cu",
        "replaces": "src/repro/kernels/segment_reduce.py:522",
        "launches": sampled["launches"]["fanout_aggregate"],
        "max_abs_err": row["max_abs_err"],
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
    })
    c = next(c for c in full["spmm"] if c["D"] == 1433)
    c16 = next(c for c in full["spmm"] if c["D"] == 16)
    summary.append({
        "name": "block_spmm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/block_spmm.cu",
        "replaces": "src/repro/kernels/csr_spmm.py:47",
        "launches": full["launches"]["block_spmm"],
        "max_abs_err": c["max_abs_err"],
        "ms": c["ms"],
        "plain_ms": c["plain_ms"],
        "bound_ms": c["bound_ms"],
        "bound_by": c["bound_by"],
        "library_ms": c["library_ms"],
        "d16": {key: c16[key] for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "workspace_bytes": c["workspace_bytes"],
    })
    k = long["kernel"]
    summary.append({
        "name": "flash_decode",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode.py:73",
        "launches": (long["launches"]["flash_decode"] + d32k["launches"]["flash_decode"]
                     + lm_serve["launches"]),
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"],
        "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"],
        "library_ms": k["library_ms"],
        "pipelined_ms": k["pipelined_ms"],
        "route": k["route"],
        "workspace_bytes": k["workspace_bytes"],
        "decode_32k": {key: d32k["kernel"][key]
                       for key in ("ms", "pipelined_ms", "bound_ms", "library_ms", "route")},
    })
    print(smi, flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
