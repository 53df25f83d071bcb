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
          after every publish, held against the numpy engine on the same
          version after each of its 9 publishes (in a forked child, on
          the version's tree decoded once, ``DecodedSnapshot``), then
          ``run_concurrent``;
  scale   the device engine at soc-LiveJournal scale (2^22 vertices,
          ~66 M directed rMAT edges, drawn on the card) built straight
          into the device pool:
          engine_aux, PageRank, PageRank x8, BFS x16 (depths held against
          scipy), and each kernel against its plain version at these shapes
          (scale_kernels: rows 1-2 on the dst-major lane at D = 1 and 8,
          each candidate tile of the autotuner first, then the consult's
          winner);
  compressed_kernels
          each chunked kernel against its plain version on ragged chunk
          counts: fixed int8 / int16 lanes with escapes, adaptive lanes
          mixing narrow and wide chunks (escapes in both, spare hi rows),
          and a narrow adaptive lane with an empty hi plane;
  compressed_stream
          ``AspenStream(compressed=True)`` at 2^18 vertices on 8 disjoint
          rMAT communities of 2^15 vertices (first showing that the stream
          phase's plain rMAT tree raises, as the reference's layout does),
          two of its 9 publishes (``COMPRESSED_CHECKED_PUBLISHES``)
          held against the host tree, decoded
          once, and the numpy engine on that decode, and both adaptive
          kernels held against their plain versions on the
          last version's own lane (D = 1 and 8);
  graph_serve
          ``GraphQueryService`` (max_batch 16, 0.25 s deadlines, tenants
          alice 3 : bob 1, work-conserving, 10,000-update writer batches)
          over the stream phase's stream: 24 closed-loop clients (bfs 50%,
          sssp 20%, pagerank 20%, cc 10%; sources live vertices by a
          zipf(2.0) rank, examples/serve_graph.py's replay skew), 5 s
          alone, then 10 s while a writer feeds update batches; per window qps, p50/p99 per kind, batch per flush,
          deadline misses, writer updates/s; cache hits and promotions;
          every session answer and
          one quiet query per kind held against the torch engine on its
          version; the reference's replay with the cache on and off
          across a publish, bit-identical; one subscription per kind over
          two 1% insert publishes, each refresh incremental and equal to
          a full recompute, timed against it (time-to-fresh);
  compressed_scale
          with the flat scale graph freed, 128 disjoint rMAT
          communities of 2^15 vertices (2^22 vertices,
          ~63 M edges, drawn on the card) in the adaptive and the int16
          layout, plain and weighted: ``CompressedEngine`` held against the
          raw engine on the same edges, each chunked kernel timed against
          its plain version and the raw kernel on the decoded lane (every
          candidate tile first, on the adaptive and int16 lanes; first
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
          shape; then the paper's host algorithms on that version
          (``core/algorithms``: MIS checked by ``verify_mis`` on its edges
          made undirected, 2-hop held against the snapshot, Local-Cluster)
          and ``flat_ctree``'s host set API on a card tree of 1 M keys
          (``multi_insert`` / ``multi_delete`` against numpy's ``union1d``
          / ``setdiff1d``, the given tree left as it was);
  scale_decode
          the padded kernel on the scale phase's pool dst lane cut into
          128-slot rows (67 M real ids), against its plain version and
          ``torch.cumsum``;
  sharded_scale
          the scale pool split into 8 range-sharded rows on the card
          (``sharded_graph_of_flat``): ``ShardedEngine`` plain and with
          integer weights, BFS x16 parents and depths, CC labels and SSSP
          x4 bit-identical to the flat ``TorchEngine``, PageRank (plain,
          x8 lanes, weighted) within atol 1e-6 and BC x4 within rtol
          1e-4, the float reduces in both launch shapes (per shard, the
          default, and one launch over shard-offset keys), each
          collective's operand held below a quarter of the pool, and rows
          1-2 at both shapes against their plain versions (every candidate
          tile at shard row 0's per-shard launch);
  sharded_stream
          ``AspenStream(mirror="sharded", n_shards=8)`` from the stream
          phase's current tree; four publishes applied to it and to the
          flat stream (a 10,000-pair insert, a delete, 0.56 M out-edges of
          64 vertices that overflow a shard's slack so the capacity
          policy rebalances, and a delete of every 64th of them), each
          followed by the shard lanes against the flat mirror's edges and
          weights and ``query_batch`` (bfs, sssp) against the flat engine;
          then ``shard_stats()``;
  sharded_compressed
          the compressed_scale communities drawn again, split into 8 rows
          and compressed per row (adaptive and int16 layouts, plain and
          weighted): ``CompressedShardedEngine`` held against the raw
          sharded engine with the same checks, then rows 3-6 at both
          launch shapes (every candidate tile at shard row 0's per-shard
          launch) and rows 8-9 on the source lane against their plain
          versions.

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
          plain SpMM, both candidate tiles (128 and 256) held to it and
          timed, two kernel calls at the winner held to the same bits,
          timed beside CSR ``torch.sparse.mm``.

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
          to 2 layers for time), the bf16 model's drift from float32 on
          one step, then ``generate`` on the kernel in bf16 with all 32
          layers for 8 left-padded prompts of 5-32 tokens, 16 new tokens;
  train   training through ``launch.train``: smollm-360m FULL in float32
          (TF32 off) at B = 8, S = 512 through ``make_lm_run``, 6 steps
          with a ``ResumableRun`` checkpoint after step 3, then a fresh
          state restored from it re-running steps 4-6 (losses equal to
          the uninterrupted run's); s/step, tokens/s and peak memory
          with remat "none", "full" and "dots" (full must be lower than
          none); the checkpoint's bytes, save and restore seconds;
          dcn-v2 FULL (26 x 10^6 x 16 float32 tables) at B = 65,536
          through ``make_dcn_run``, 4 steps; and two steps of REDUCED
          smollm and REDUCED dcn-v2 on the card and on the CPU from the
          same parameters and batches, loss, grad norm and every
          parameter and moment held together.  No kernel runs here.
  moe_serve
          qwen3-moe-30b-a3b FULL (48 layers, 128 experts top-8, 59.5 GB)
          and deepseek-moe-16b FULL (28 layers, 64 experts top-6 and 2
          shared, 33.3 GB) in bf16, initialised on the card (the peak held
          to the weights plus one layer): ``make_prefill`` at B = 1, S =
          2048 with the share of (token, slot) pairs dropped at capacity
          1.25; ``generate`` on the kernel at B = 8, prompts of 5-32 tokens,
          on a 4096-position cache; decode steps over a drawn 4096-position
          history with row 12 held to its plain version at each config's
          cache shape (Q = 8, d = 64; Q = 1, d = 128) and timed beside its
          bound and SDPA; two full-width layers in float32, the flash step
          against the plain one, and the MoE layer at a capacity that drops
          nothing against a dense per-token top-k; the REDUCED configs'
          ``route``, ``moe_apply`` and decode on the card against the CPU;
  gnn_molecule
          SchNet FULL steps through ``make_train_step(schnet_loss)`` on the
          ``molecule`` shape (128 molecules of 30 atoms and 64 edges);
          GraphCast FULL's forward on ``build_multimesh(6)`` (40,962 nodes,
          327,660 edges) and three training steps at full width and depth
          on ``build_multimesh(5)`` (refinement cut: the reference has no
          GNN remat); both REDUCED models on the card against the CPU.  No
          kernel runs here.
  train_gnn
          (after gnn_sampled, on its card graph) graphsage-reddit FULL
          trained through ``launch.train_gnn``'s loop: B = 1024 at fanout
          (15, 10), 512 edges streamed in every 10 steps, 40 steps with
          checkpoints after steps 20 and 40; the step-40 one removed, a
          fresh restore re-runs steps 21-40 bit for bit; s/step, seeds/s,
          peak bytes, final accuracy; 3 REDUCED steps on the card against
          the CPU.  No kernel runs here.
  dryrun  (last) the dry run (``launch.dryrun``) of the reference's nine
          representative cells at full width on the 16x16 fake mesh, in a
          child process started after the build (``--dryrun-cells``; host
          work beside the card's phases), one line each (per-device FLOPs, bytes, collective bytes by kind,
          H100 roofline terms, memory model); then gcn-cora
          full_graph_sm, dcn-v2 serve_p99 and schnet molecule run on the
          card at 1x1 with arguments drawn from the seed, their ms and
          peak bytes beside the 1x1 dry run's figures.

The compressed layout (128-slot chunks, int8/int16 deltas, 8 escapes per
chunk) holds only graphs whose ids have community locality: on plain
rMAT beyond 2^15 vertices some chunk needs more than 8 int16 escapes and
``compress_host`` raises, in the reference as in the port (PERF.md §7).

The compressed engine decodes its lanes through the chunked decode
kernels (``core/compressed.decode_rows`` on the card), so the compressed
phases count their launches too.

The kernel autotuner (``kernels/autotune.py``) sweeps each tuned
kernel's candidate tiles the first time a shape bucket is consulted on
the card, on the live path too (a sweep may land inside a timed query);
every check above that sweeps the tiles holds each candidate against
the plain version (rtol 1e-5, atol 1e-6 * max|out|; the SpMM atol
1e-4), shows it gives the same bits twice, times it, and records the
winner, its time beside the old fixed tile's (4096 slots; 128 x 128),
and the sweep's own timings and seconds.  The disk table
(``REPRO_TORCH_AUTOTUNE_CACHE``) is ``build/autotune_table.json``,
removed at the start so each run sweeps anew.  After the phases: each
phase's consults, sweeps and sweep seconds, then the table, the card's
name and power limit, the kernel summary line (each tuned row with its
tile and every candidate's time) and, last,
``{"ok": true, "device": ...}``.
Any mismatch or exception ends the run with a nonzero exit and no ``ok``
line.  Without a GPU, or outside a checkout of the repo, it exits nonzero
before printing any result.  It imports nothing of JAX.
"""
from __future__ import annotations

import atexit
import dataclasses
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
# The autotuner's disk table (REPRO_TORCH_AUTOTUNE_CACHE), under build/.
TUNE_TABLE = ROOT / "build" / "autotune_table.json"
# Stream-phase PageRank (float32, 10 rounds) against the numpy engine's
# float64, relative to each entry.
PR_RTOL = 1e-5
# The compressed_stream publishes (of 9: four insert / delete pairs, then a
# weighted insert) whose versions are held against the host: the first
# insert and the last, weighted one, whose version holds every earlier
# insert and delete.  Each check costs 20-35 s of host Python (a decode of
# the lane and the numpy engine); more no longer fit the time limit beside
# the stream phase's nine checks and the later phases.
COMPRESSED_CHECKED_PUBLISHES = (0, 8)

# Where the stream phase's forked numpy checks leave their answers.
STREAM_CHECK_DIR = ROOT / "build" / "stream_checks"

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


def same_bits(fn, what: str) -> bool:
    """Two calls of a kernel give the same bits (its float32 sums run in
    a fixed order); raises if they do not."""
    import torch

    if not torch.equal(fn(), fn()):
        raise AssertionError(f"{what}: two calls gave different bits")
    return True


def tune_totals() -> dict:
    """The autotuner's counts so far: cold consults, sweeps, the seconds
    the sweeps took and their (uncounted) launches."""
    from repro_torch.kernels import autotune

    return {"consults": sum(autotune.CONSULTS.values()), "sweeps": sum(autotune.SWEEPS.values()),
            "sweep_s": sum(autotune.SWEEP_SECONDS.values()),
            "sweep_launches": sum(autotune.SWEEP_LAUNCHES.values())}


def tune_since(before: dict) -> dict:
    """``tune_totals`` since ``before`` (a phase's own consults and sweeps)."""
    return {k: v - before[k] for k, v in tune_totals().items()}


def tile_sweep(kern_at, want, what: str, kernel: str, shape: dict, consult, rtol: float = 1e-5,
               atol: float | None = None) -> dict:
    """Every candidate tile of a tuned kernel at one main-path shape:
    ``kern_at(tile)`` held against the plain version's ``want`` (rtol,
    atol as ``check_close``), the same bits twice, and timed; then
    ``consult()`` (the ``ops`` call without a tile, which sweeps this
    shape's key if no earlier call has) held against ``want``, and its
    winner read back.  Raises on any mismatch."""
    from repro_torch.kernels import autotune

    tiles = [next(iter(c.values())) for c in autotune.CANDIDATES[kernel]]
    default = next(iter(autotune.DEFAULTS[kernel].values()))
    key = autotune.cache_key(kernel, "cuda", shape)
    swept_before = autotune.SWEEPS[key]
    ms = {}
    for t in tiles:
        f = lambda t=t: kern_at(t)  # noqa: E731
        check_close(f(), want, f"{what} tile {t}", rtol, atol)
        same_bits(f, f"{what} tile {t}")
        ms[t] = time_ms(f)
    check_close(consult(), want, f"{what} tuned", rtol, atol)
    tile = next(iter(autotune.get_params(kernel, shape, backend="cuda").values()))
    if tile not in tiles:
        raise AssertionError(f"{what}: the sweep chose {tile}, not a candidate of {tiles}")
    return {
        "key": autotune._key_str(key), "tile": tile, "tile_ms": ms[tile],
        "old_tile": default, "old_tile_ms": ms[default], "candidates_ms": ms,
        "winner_over_old": ms[tile] / ms[default],
        "swept_on_live_path": swept_before > 0, "sweeps": autotune.SWEEPS[key],
        "sweep_s": autotune.SWEEP_SECONDS.get(key),
        "sweep_candidates_ms": {next(iter(c.values())): 1e3 * sec
                                for c, sec in autotune.TIMINGS.get(key, [])},
    }


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
        "delta_decode_ptxas": ptxas_summary(_build.BUILD_INFO.get("delta_decode", {})),
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
            short = re.search(r"(chunked_decode_kernel)ILi(\d)ELb([01])E", name)
            if short:  # e.g. chunked_decode_kernel<1, adaptive>
                kern, width, adaptive = short.groups()
                name = f"{kern}<{width}{', adaptive' if adaptive == '1' else ''}>"
            for kern in ("tile_prefix_kernel", "padded_decode_kernel", "adaptive_decode_kernel",
                         "prepass_kernel"):
                if f"{len(kern)}{kern}" in name:
                    name = kern
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
                row[f"{name}_same_bits"] = same_bits(kern, f"{name} E={E} D={D}")
                if E > 100_000:
                    row[f"{name}_ms"] = time_ms(kern)
                    row[f"{name}_pipelined_ms"] = time_ms_pipelined(kern)
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
    pending = []  # (child pid, its answers' file, the card's answers) per publish
    pr_rel_err = [0.0]
    shutil.rmtree(STREAM_CHECK_DIR, ignore_errors=True)
    STREAM_CHECK_DIR.mkdir(parents=True)

    def timed(kind, **kw):
        t = time.perf_counter()
        out = stream.query_batch(kind=kind, **kw)
        lat[kind].append(time.perf_counter() - t)
        return out

    def check_version(weighted: bool) -> None:
        """The card's answers on the current version now; the numpy
        engine's on the same version in a forked child (``fork_check``),
        held against them once every publish is made (``settle``)."""
        deg = stream.engine("torch").degrees.cpu().numpy()
        srcs = rng.choice(np.flatnonzero(deg > 0), 16, replace=False)
        resets = rng.random((8, n))
        resets /= resets.sum(1, keepdims=True)
        got = {"bfs": timed("bfs", sources=srcs), "pagerank": timed("pagerank", resets=resets)}
        if weighted:
            got["sssp"] = timed("sssp", sources=srcs[:4])
        path = STREAM_CHECK_DIR / f"publish_{len(pending)}.npz"
        pending.append((fork_check(stream, srcs, resets, weighted, path), path, got))

    def settle() -> dict:
        """Each publish's card answers against its child's: BFS parents and
        SSSP distances equal, PageRank within ``PR_RTOL``."""
        t = time.perf_counter()
        out = {"decode_s": [], "numpy_s": []}
        for i, (pid, path, got) in enumerate(pending):
            want = wait_check(pid, path, f"stream publish {i}")
            out["decode_s"].append(float(want["decode_s"]))
            out["numpy_s"].append(float(want["numpy_s"]))
            if not np.array_equal(got["bfs"], want["bfs"]):
                raise AssertionError(f"stream: publish {i}: bfs parents differ from the numpy "
                                     "engine")
            # float32 on the card against the numpy engine's float64: relative
            # to each entry (they average 1/n), with a floor for the smallest.
            g, w = got["pagerank"], want["pagerank"]
            atol = 1e-6 * float(np.abs(w).max())
            err = np.abs(g - w)
            pr_rel_err[0] = max(pr_rel_err[0], float((err / np.maximum(np.abs(w), atol)).max()))
            if not (np.all(np.isfinite(g)) and np.allclose(g, w, rtol=PR_RTOL, atol=atol)):
                raise AssertionError(f"stream: publish {i}: pagerank off by {err.max()} "
                                     f"(rel {pr_rel_err[0]})")
            if "sssp" in got and not np.array_equal(got["sssp"], want["sssp"]):
                raise AssertionError(f"stream: publish {i}: sssp distances differ from the "
                                     "numpy engine")
        out["wait_s"] = time.perf_counter() - t
        return out

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
    checks = settle()

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
        "versions_checked_vs_numpy": len(checks["decode_s"]),
        "checks": checks,
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


def fork_check(stream, srcs, resets, weighted: bool, path: Path) -> int:
    """Fork a child that answers the stream's current version on the numpy
    engine (the version's host tree decoded once, ``DecodedSnapshot``):
    BFS from ``srcs``, PageRank from ``resets`` and, on a weighted
    version, SSSP from ``srcs[:4]``, into ``path``.  The child holds its
    own copy of the tree (copy on write), runs numpy only (no CUDA, no
    torch op) and leaves with ``os._exit``; the parent goes on to the next
    publish at once.  Returns the child's pid (``wait_check``)."""
    from repro_torch.core import graph as G
    from repro_torch.core.traversal.numpy_backend import NumpyEngine

    v = stream.acquire()
    try:
        sys.stdout.flush()
        sys.stderr.flush()
        pid = os.fork()
        if pid == 0:
            code = 1
            try:
                t = time.perf_counter()
                eng = NumpyEngine(DecodedSnapshot(G.flat_snapshot(v.graph)))
                t1 = time.perf_counter()
                out = {"bfs": stream._serve_kind(eng, "bfs", srcs, {}),
                       "pagerank": stream._serve_kind(eng, "pagerank", None, {"resets": resets})}
                if weighted:
                    out["sssp"] = stream._serve_kind(eng, "sssp", srcs[:4], {})
                tmp = path.with_name(path.stem + ".tmp.npz")
                np.savez(tmp, decode_s=t1 - t, numpy_s=time.perf_counter() - t1, **out)
                os.replace(tmp, path)
                code = 0
            except BaseException:  # noqa: BLE001 - reported through the exit code
                import traceback

                traceback.print_exc()
            finally:
                os._exit(code)
    finally:
        stream.release(v)
    return pid


def wait_check(pid: int, path: Path, what: str, timeout_s: float = 300.0):
    """A ``fork_check`` child's answers, once it has exited 0; a child that
    fails, or runs past ``timeout_s`` (then killed), fails the phase."""
    t = time.perf_counter()
    while True:
        done, status = os.waitpid(pid, os.WNOHANG)
        if done:
            break
        if time.perf_counter() - t > timeout_s:
            os.kill(pid, 9)
            os.waitpid(pid, 0)
            raise AssertionError(f"{what}: the numpy check ran past {timeout_s} s")
        time.sleep(0.05)
    code = os.waitstatus_to_exitcode(status)
    if code != 0:
        raise AssertionError(f"{what}: the numpy check exited {code}")
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def stream_kernel_check(eng, widths=(1, 8), what: str = "stream") -> dict:
    """The stream's own kernel shapes on its last (weighted) version: the
    engine's ``edge_map_reduce`` (D = 1) and ``edge_map_reduce_batch``
    (D > 1, the PageRank reset lanes), and the unweighted kernel on the
    same pool, each held against the plain version of the same reduce."""
    import torch

    from repro_torch.core.traversal import torch_backend as tb
    from repro_torch.kernels import segment_reduce as sr

    a, n = eng.aux, eng.g.n
    if a.w_by_dst is None:
        raise AssertionError(f"{what}: the weighted batch left the mirror unweighted")
    dev = a.dst_sorted.device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    vals = torch.rand((max(widths), n), generator=gen, device=dev)
    msg = tb._reduce_msgs_batch(vals, a.src_by_dst, a.valid_by_dst)
    dst = a.dst_sorted.to(torch.int32).contiguous()
    errs = {}
    for D in widths:
        got = eng.edge_map_reduce(vals[0]) if D == 1 else eng.edge_map_reduce_batch(vals[:D])
        want = sr.segment_sum_weighted_sorted_plain(dst, a.w_by_dst, msg[:, :D].contiguous(), n)
        errs[f"segment_sum_weighted_D{D}"] = check_close(
            got.reshape(-1, n).T, want, f"{what} edge_map_reduce D={D}")
        m = msg[:, :D].contiguous()
        errs[f"segment_sum_D{D}"] = check_close(
            sr.segment_sum_sorted(dst, m, n), sr.segment_sum_sorted_plain(dst, m, n),
            f"{what} segment_sum D={D}")
        errs[f"same_bits_D{D}"] = (
            same_bits(lambda: sr.segment_sum_sorted(dst, m, n), f"{what} segment_sum D={D}")
            and same_bits(lambda: sr.segment_sum_weighted_sorted(dst, a.w_by_dst, m, n),
                          f"{what} segment_sum_weighted D={D}"))
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
    against its plain version, per synchronised call and back to back,
    with two calls giving the same bits.  Every candidate tile first
    (``tile_sweep``); the rest at the autotuner's winner, the tile the
    main path launches with.  Yardsticks: a sparse CSR product
    on the same row pointer (weighted), and for the unweighted kernel the
    fastest of ``index_add_``, the CSR product with unit values and
    ``torch.segment_reduce`` over the row offsets (``library``)."""
    import torch

    from repro_torch.core.traversal import torch_backend as tb
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_reduce as sr

    n = g.n
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dst = aux.dst_sorted
    e_valid = int((dst < n).sum())
    idx = dst.long()
    w = torch.rand(dst.shape, generator=gen, device="cuda")
    wv = torch.where(dst < n, w, 0.0)
    offs = aux.dst_offsets.long()
    cols = torch.arange(e_valid, device="cuda")
    csr_w = torch.sparse_csr_tensor(offs, cols, wv[:e_valid], size=(n, dst.shape[0]))
    csr_1 = torch.sparse_csr_tensor(offs, cols, torch.ones(e_valid, device="cuda"),
                                    size=(n, dst.shape[0]))
    summary = []
    for D in (1, 8):
        vals = torch.rand((D, n), generator=gen, device="cuda")
        msg = tb._reduce_msgs_batch(vals, aux.src_by_dst, aux.valid_by_dst)
        ext = torch.zeros((n + 1, msg.shape[1]), device="cuda")
        for name, weighted in (("segment_sum", False), ("segment_sum_weighted", True)):
            if weighted:
                kern_at = lambda t: sr.segment_sum_weighted_sorted(dst, w, msg, n, t)  # noqa: E731
                consult = lambda: ops.segment_sum_weighted(dst, w, msg, n)  # noqa: E731
                plain = lambda: sr.segment_sum_weighted_sorted_plain(dst, w, msg, n)  # noqa: E731
                libs = {"csr_sparse_mm": lambda: torch.sparse.mm(csr_w, msg)}
            else:
                kern_at = lambda t: sr.segment_sum_sorted(dst, msg, n, t)  # noqa: E731
                consult = lambda: ops.segment_sum(dst, msg, n)  # noqa: E731
                plain = lambda: sr.segment_sum_sorted_plain(dst, msg, n)  # noqa: E731
                libs = {"index_add_": lambda: ext.zero_().index_add_(0, idx, msg),
                        "csr_sparse_mm_unit": lambda: torch.sparse.mm(csr_1, msg),
                        "segment_reduce_offsets": lambda: torch.segment_reduce(
                            msg[:e_valid], "sum", offsets=offs, axis=0)}
            tune = tile_sweep(kern_at, plain(), f"scale {name} D={D}", name,
                              {"E": int(dst.shape[0]), "n": n, "D": D}, consult)
            kern = lambda: kern_at(tune["tile"])  # noqa: E731
            err = check_close(kern(), plain(), f"scale {name} D={D}")
            for lib_name, lib in libs.items():  # the yardsticks compute the same function
                check_close(lib()[:n], plain(), f"scale {name} D={D} {lib_name}")
            lib_ms = {k: time_ms(f) for k, f in libs.items()}
            best = min(lib_ms, key=lib_ms.get)
            bound_ms, bound_by = bound(e_valid, n, D, weighted)
            summary.append({
                "name": name, "D": D, "E": int(dst.shape[0]), "E_valid": e_valid, "n_out": n,
                "max_abs_err": err, "same_bits": same_bits(kern, f"scale {name} D={D}"),
                "ms": time_ms(kern), "pipelined_ms": time_ms_pipelined(kern),
                "plain_ms": time_ms(plain), "library_ms": lib_ms[best], "library": best,
                "libraries_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "tune": tune,
            })
    emit({"phase": "scale_kernels", "cases": summary, "autotune": tune_totals()})
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
    (adaptive: the wide tag too; the kernel finds each hi row from the
    tags, so no index is read), and 4 B per id written; one add per id and
    per escape over the f32 peak."""
    R, K = s.ovf_pos.shape
    L = s.deltas.shape[1]
    per_row = 4 + 8 * K + (1 if s.hi is not None else 0)
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


def device_us(ev) -> float:
    """Device time (us) of a ``torch.profiler`` key average, under either
    name PyTorch has given it."""
    return float(getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0) or 0)


def launch_split(fn, reps: int = 20) -> dict:
    """One call of a kernel wrapper split into its host and device parts:
    ``host_us`` is the wrapper's own time per call on the host clock (calls
    issued back to back, no sync between, no profiler); ``device`` names
    each device activity that ``torch.profiler`` saw in ``reps`` calls
    with its us and count per call, so a wrapper that launches anything
    besides its kernel shows it.  Empty ``device`` means the profiler saw
    no device time here."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    host_us = 1e6 * (time.perf_counter() - t) / reps
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    device = {ev.key[:80]: {"us": device_us(ev) / reps, "count": ev.count / reps}
              for ev in prof.key_averages()
              if device_us(ev) > 0 and str(getattr(ev, "device_type", "")).endswith("CUDA")}
    return {"host_us": host_us, "device": device}


def step_profile(fn) -> tuple:
    """(fn(), where one call's time goes): its wall ms under
    ``torch.profiler`` (synchronized), the card's kernel ms and kernel
    count (the CUDA-typed key averages, one stream: no overlap), the host's
    launch calls, and the card's busy share of the wall time."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    avgs = prof.key_averages()
    cuda = [ev for ev in avgs if str(getattr(ev, "device_type", "")).endswith("CUDA")]
    kernel_ms = sum(device_us(ev) for ev in cuda) / 1e3
    launches = sum(ev.count for ev in avgs if ev.key in ("cudaLaunchKernel", "cuLaunchKernelEx",
                                                          "cuLaunchKernel"))
    return out, {"wall_ms": wall_ms, "kernel_ms": kernel_ms,
                 "kernels": sum(ev.count for ev in cuda), "launch_calls": launches,
                 "busy_share": kernel_ms / wall_ms if wall_ms else None}


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


def hand_chunk_rows(R: int, n_slots: int, seed: int, width: int = 1, table: str = "mixed"):
    """Chunk rows built by hand, on the card: anchors and escape values
    over the whole int32 range (the decode wraps); with ``table="mixed"``
    about half the entries act, at random columns and the corners (below
    0, 0, 1, 127), the rest are padding at 128 and past it with values that
    must never act; ``table="padding"`` pads every entry."""
    import torch

    rng = np.random.default_rng(seed)
    lim = 128 if width == 1 else 1 << 15
    deltas = rng.integers(-lim, lim, (R, 128)).astype(np.int8 if width == 1 else np.int16)
    deltas[:, 0] = 0
    anchors = rng.integers(-(2**31), 2**31, R, dtype=np.int64).astype(np.int32)
    cols = rng.choice(np.array([-7, -1, 0, 1, 127, *range(2, 127)]), (R, n_slots))
    live = rng.random((R, n_slots)) < (0.5 if table == "mixed" else 0.0)
    pad = rng.choice(np.array([128, 129, 1 << 30]), (R, n_slots))
    pos = np.where(live, cols, pad).astype(np.int32)
    add = rng.integers(-(2**31), 2**31, (R, n_slots), dtype=np.int64).astype(np.int32)
    return [torch.from_numpy(np.ascontiguousarray(x)).cuda() for x in (anchors, deltas, pos, add)]


def decode_corners(rows_per_warp: int, rows_per_block: int, rows_per_prefix_block: int) -> list:
    """(name, ChunkedStream) at the chunked kernels' corners: row counts at
    the tile's edges (rows a warp and rows a block, each +-1) for the int8
    and int16 lanes and the adaptive one; 0, 1 and 32 escape slots, tables
    of padding only; adaptive tags all narrow, all wide, straddling tile
    edges, past the hi plane (the clamp), with H = 0, and at the edges of
    the pre-pass's blocks (+-1, and 3 blocks and 5 rows)."""
    import torch

    from repro_torch.core import compressed as cz

    edges = sorted({n + e for n in (rows_per_warp, rows_per_block) for e in (-1, 0, 1)})
    B = rows_per_block
    none = torch.zeros((), dtype=torch.bool, device="cuda")
    out = []
    for R in edges:
        for width in (1, 2):
            out.append((f"rows{R}_int{8 * width}",
                        cz.ChunkedStream(*hand_chunk_rows(R, 8, R, width), none)))
    for k in (0, 1, 32):
        for table in ("mixed", "padding"):
            out.append((f"slots{k}_{table}_int8",
                        cz.ChunkedStream(*hand_chunk_rows(2 * B + 5, k, k, 1, table), none)))
    tags = {  # name -> (R, wide rows, H, escape slots)
        "all_narrow": (2 * B + 5, lambda r: r < 0, 3, 8),
        "all_wide": (2 * B + 5, lambda r: r >= 0, 2 * B + 5, 8),
        "straddle": (3 * B, lambda r: (abs(r - B) <= 3) | (abs(r - 2 * B) <= 2), 12, 8),
        "past_cap": (2 * B + 5, lambda r: r % 3 != 1, 7, 8),
        "h0": (B + 1, lambda r: r % 2 == 0, 0, 8),
        **{f"slots{k}": (B + 1, lambda r: r % 4 == 0, 9, k) for k in (0, 1, 32)},
        **{f"edge{R}": (R, lambda r: r % 5 != 2, R, 8) for R in edges},
        **{f"edge{R}": (R, lambda r: r % 5 != 2, R // 2, 8)
           for R in (rows_per_prefix_block + e for e in (-1, 0, 1))},
        "prefix_blocks": (3 * rows_per_prefix_block + 5,
                          lambda r: (r % 7 < 3) | (r % rows_per_prefix_block < 3), 10_000, 8),
    }
    for name, (R, wide_of, H, k) in tags.items():
        a, d, p, v = hand_chunk_rows(R, k, R + H + k)
        hi = np.random.default_rng(R + 1).integers(-128, 128, (H, 128)).astype(np.int8)
        wide = torch.from_numpy(wide_of(np.arange(R))).cuda()
        out.append((f"adaptive_{name}", cz.ChunkedStream(a, d, p, v, none,
                                                         torch.from_numpy(hi).cuda(), wide)))
    return out


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
    plan = dd.chunked_plan()
    for name, s in decode_corners(plan["rows_per_warp"], plan["rows_per_block"],
                                  plan["rows_per_prefix_block"]):
        kern, plain = decode_calls(s)
        rows.append({"kernel": "delta_decode_chunked" + ("_adaptive" if s.hi is not None else ""),
                     "corner": name, "R": s.deltas.shape[0], "K": s.ovf_pos.shape[1],
                     "wide": None if s.wide is None else int(s.wide.sum()),
                     "hi_rows": None if s.hi is None else s.hi.shape[0],
                     "max_abs_err": check_equal(kern(), plain(), f"decode corner {name}"),
                     "same_bits": same_bits(kern, f"decode corner {name}")})
    emit({"phase": "decode_kernels", "tolerance": "exact", "plan": plan, "cases": rows,
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
               bound_ms=bound_ms, bound_by=bound_by, launches=launches)
    out["algorithms"] = host_algorithms(stream, snap, offsets, nbrs)
    out["set_api"] = card_set_api()
    out["phase_s"] = time.perf_counter() - t0
    emit(out)
    return launches


# Local-Cluster's mass cut-off on the stream graph: at the default 1e-6
# the walk's mass spreads over ~137 K of its 262 K vertices in 10 rounds of
# host Python (about a minute); 1e-4 keeps at most 10^4 a round.
LOCAL_CLUSTER_EPS = 1e-4


def host_algorithms(stream, snap, offsets, nbrs) -> dict:
    """The paper's host algorithms (``core/algorithms``) on the stream's
    final version.  MIS, checked by ``verify_mis``, on its snapshot's
    edges closed under reversal, held in ``baselines.StaticCSR`` (both
    take any store with ``n`` and ``neighbors``): MIS is defined on an
    undirected graph, and the final version is not symmetric, since the
    stream's base graph (``make_update_stream``) lacks one direction of
    each insert not yet replayed.  2-hop and Local-Cluster (at
    ``LOCAL_CLUSTER_EPS``) on its tree from a vertex of median degree,
    2-hop held against the snapshot's neighbour lists."""
    from repro_torch.core import algorithms as alg
    from repro_torch.core import baselines as bl

    src_ids = np.repeat(np.arange(snap.n, dtype=np.int64), np.diff(offsets))
    t = time.perf_counter()
    und = bl.StaticCSR(snap.n, np.concatenate([np.stack([src_ids, nbrs], 1),
                                                np.stack([nbrs, src_ids], 1)]))
    out = {"undirected_edges": int(und.m), "directed_edges": int(nbrs.size),
           "static_csr_s": time.perf_counter() - t}
    t = time.perf_counter()
    in_set = alg.mis(und, seed=SEED)
    out["mis_s"] = time.perf_counter() - t
    t = time.perf_counter()
    if not alg.verify_mis(und, in_set):
        raise AssertionError("host_decode: mis is not a maximal independent set")
    out.update(verify_mis_s=time.perf_counter() - t, mis_size=int(in_set.sum()))
    deg = np.diff(offsets)
    live = np.flatnonzero(deg > 0)
    src = int(live[np.argsort(deg[live], kind="stable")[live.size // 2]])
    v = stream.acquire()
    try:
        t = time.perf_counter()
        th = alg.two_hop(v.graph, src)
        out["two_hop_s"] = time.perf_counter() - t
        t = time.perf_counter()
        cluster = alg.local_cluster(v.graph, src, eps=LOCAL_CLUSTER_EPS)
        out["local_cluster_s"] = time.perf_counter() - t
    finally:
        stream.release(v)
    one = nbrs[offsets[src]:offsets[src + 1]]
    want = np.unique(np.concatenate([one] + [nbrs[offsets[u]:offsets[u + 1]] for u in one]))
    if not np.array_equal(th, want[want != src]):
        raise AssertionError("host_decode: two_hop differs from the snapshot's 2-hop set")
    if src not in cluster.tolist() or not np.array_equal(cluster, np.unique(cluster)):
        raise AssertionError("host_decode: local_cluster lost its source or is not sorted")
    out.update(src=src, src_degree=int(deg[src]), two_hop=int(th.size), cluster=int(cluster.size),
               local_cluster_eps=LOCAL_CLUSTER_EPS)
    return out


def card_set_api(n_keys: int = 1 << 20, batch: int = 1 << 17) -> dict:
    """``flat_ctree``'s host set API on a card tree of about n_keys keys:
    ``multi_insert`` (rank-merge and sort) and ``multi_delete`` of a batch
    that half overlaps it, held against numpy's ``union1d`` and
    ``setdiff1d``; the tree given to each call is left as it was."""
    import torch

    from repro_torch.core import flat_ctree as fct

    rng = np.random.default_rng(SEED + 8)
    keys = rng.integers(0, 1 << 30, n_keys).astype(np.int32)
    add = np.concatenate([rng.integers(0, 1 << 30, batch // 2), keys[: batch // 2]]).astype(np.int32)
    t = fct.from_array(keys, device="cuda")
    base = fct.to_array(t).copy()
    out = {"keys": int(base.size), "batch": int(add.size)}
    for optimized in (True, False):
        t0 = time.perf_counter()
        t2 = fct.multi_insert(t, add, optimized=optimized)
        torch.cuda.synchronize()
        out[f"multi_insert_{'merge' if optimized else 'sort'}_s"] = time.perf_counter() - t0
        if t2.data.device.type != "cuda" or not np.array_equal(fct.to_array(t2),
                                                               np.union1d(base, add)):
            raise AssertionError("set_api: multi_insert differs from union1d")
    t0 = time.perf_counter()
    t3 = fct.multi_delete(t2, add)
    torch.cuda.synchronize()
    out["multi_delete_s"] = time.perf_counter() - t0
    if not np.array_equal(fct.to_array(t3), np.setdiff1d(np.union1d(base, add), add)):
        raise AssertionError("set_api: multi_delete differs from setdiff1d")
    if not np.array_equal(fct.to_array(t), base) or not fct.find(t3, int(np.setdiff1d(base, add)[0])):
        raise AssertionError("set_api: a call changed the tree it was given")
    out["capacity"] = fct.capacity(t2)
    return out


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


def chunked_call(s, msg, n_out, w=None, plain=False, tile=4096):
    """The chunked kernel for stream ``s``'s layout at ``tile`` (or its
    plain version)."""
    from repro_torch.kernels import segment_reduce as sr

    args = (s.anchors, s.deltas, s.ovf_pos, s.ovf_add)
    if plain:
        if w is None:
            return sr.segment_sum_sorted_chunked_plain(*args, msg, n_out, s.hi, s.wide)
        return sr.segment_sum_weighted_chunked_plain(*args, w, msg, n_out, s.hi, s.wide)
    if s.hi is None:
        if w is None:
            return sr.segment_sum_sorted_chunked(*args, msg, n_out, tile)
        return sr.segment_sum_weighted_chunked(*args, w, msg, n_out, tile)
    a, d, p, v = args
    if w is None:
        return sr.segment_sum_sorted_chunked_adaptive(a, d, s.hi, s.wide, p, v, msg, n_out, tile)
    return sr.segment_sum_weighted_chunked_adaptive(a, d, s.hi, s.wide, p, v, w, msg, n_out,
                                                    tile)


def chunked_tile_sweep(s, msg, n_out, w, want, what: str) -> dict:
    """``tile_sweep`` of the chunked kernel for stream ``s``'s layout; the
    consult goes through ``ops``, under the fixed-width key as the
    engines' calls do."""
    from repro_torch.kernels import ops

    args = (s.anchors, s.deltas, s.ovf_pos, s.ovf_add)
    kernel = "segment_sum_chunked" if w is None else "segment_sum_weighted_chunked"
    if w is None:
        consult = lambda: ops.segment_sum_chunked(*args, msg, n_out, hi=s.hi, wide=s.wide)  # noqa: E731
    else:
        consult = lambda: ops.segment_sum_weighted_chunked(*args, w, msg, n_out, hi=s.hi,  # noqa: E731
                                                           wide=s.wide)
    return tile_sweep(lambda t: chunked_call(s, msg, n_out, w, tile=t), want, what, kernel,
                      {"R": s.deltas.shape[0], "n": n_out, "D": msg.shape[1]}, consult)


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
                row[f"{name}_same_bits"] = same_bits(lambda: chunked_call(s, msg, n_out, wt),
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
        if len(publish_s) - 1 in COMPRESSED_CHECKED_PUBLISHES:
            check_version()

    sr.reset_launches()
    dd.reset_launches()
    for b in range(n_batches):  # each batch: an insert publish, then a delete publish
        rows = updates[b * batch:(b + 1) * batch]
        publish(stream.insert_edges, rows[rows[:, 2] == 0, :2])
        publish(stream.delete_edges, rows[rows[:, 2] == 1, :2])
    wedges = updates[n_batches * batch:(n_batches + 1) * batch, :2]
    weights = rng.integers(1, 10, size=wedges.shape[0]).astype(np.float64)
    publish(stream.insert_edges, wedges, weights=weights)
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
        versions_checked=len(check_s), pagerank_max_rel_err=pr_rel[0], pagerank_rtol=PR_RTOL,
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
        out[f"same_bits_D{D}"] = (
            same_bits(lambda: chunked_call(s, m, n), f"compressed_stream chunked D={D}")
            and same_bits(lambda: chunked_call(s, m, n, a.w_by_dst),
                          f"compressed_stream weighted chunked D={D}"))
    return out


# graph_serve: the multi-tenant query service on the stream phase's stream
SERVE_CLIENTS = 24  # closed-loop client threads, split over the two tenants
SERVE_QUIET_S = 5.0  # the clients alone, before the writer starts
SERVE_LOAD_S = 10.0  # the load window: the clients and the writer
SERVE_MIX = (("bfs", 0.5), ("sssp", 0.2), ("pagerank", 0.2), ("cc", 0.1))
SERVE_TENANTS = {"alice": 3.0, "bob": 1.0}  # examples/serve_graph.py's tenants
# source skew: rank r ~ zipf(2.0) picks the r-th live vertex, the skew of
# examples/serve_graph.py's cache replay (there over all vertex ids)
SERVE_ZIPF = 2.0
SERVE_SESSIONS = 8  # sessions opened during the load, two queries each
SUB_PUBLISHES = 2  # insert publishes of 1% of the edges under the subscriptions
# the reference's cache-on/off replay (tests/test_result_cache.py REPLAY)
SERVE_REPLAY = (("bfs", 3), ("sssp", 5), ("bfs", 3), ("cc", None),
                ("pagerank", None), ("bfs", 3), ("sssp", 5), ("pagerank", None))


def answer_on(stream, v, kind: str, src):
    """What the service must answer for one query on the held version
    ``v``: ``query_batch``'s dispatch on that version's torch engine (cc:
    the global labels; pagerank: the one-hot or uniform reset row)."""
    from repro_torch.core.traversal import algorithms as talg

    eng = stream._engine_for(v, "torch")
    if kind == "cc":
        return np.asarray(talg.connected_components(eng), np.int64)
    if kind == "pagerank":
        reset = np.zeros((1, eng.n))
        if src is None:
            reset[0] = 1.0 / eng.n
        else:
            reset[0, src] = 1.0
        return stream._serve_kind(eng, "pagerank", None, {"resets": reset})[0]
    return stream._serve_kind(eng, kind, [src], {})[0]


def check_answer(got, want, kind: str, what: str) -> float:
    """bfs, sssp and cc bit-identical; PageRank within the stream phase's
    PR_RTOL (atol 1e-6 of the largest entry).  Returns max|got - want|."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise AssertionError(f"{what}: {kind} shape {got.shape}, want {want.shape}")
    if kind == "pagerank":
        atol = 1e-6 * float(np.abs(want).max())
        if not (np.all(np.isfinite(got)) and np.allclose(got, want, rtol=PR_RTOL, atol=atol)):
            raise AssertionError(f"{what}: pagerank off by {np.abs(got - want).max()}")
        return float(np.abs(got - want).max())
    if not np.array_equal(got, want):
        raise AssertionError(f"{what}: {kind} differs from the torch engine on its version")
    return 0.0


def _pct(xs, q) -> float | None:
    return float(np.percentile(xs, q)) if len(xs) else None


def phase_graph_serve(stream) -> dict:
    """``GraphQueryService`` over the stream phase's stream (2^18 vertices,
    ~3.9 M directed edges, weighted): 24 closed-loop clients of two
    tenants, alone for ``SERVE_QUIET_S`` and then for ``SERVE_LOAD_S``
    while a writer feeds update batches; then the checks, cache on
    against off, and the four subscriptions."""
    import threading

    import torch

    from repro_torch.core import streaming as st
    from repro_torch.kernels import segment_reduce as sr
    from repro_torch.serve.graph import KINDS, GraphQueryService

    t_phase = time.perf_counter()
    out = {"phase": "graph_serve", "clients": SERVE_CLIENTS, "quiet_s": SERVE_QUIET_S,
           "load_s": SERVE_LOAD_S,
           "mix": dict(SERVE_MIX), "source_zipf": SERVE_ZIPF, "tenant_weights": SERVE_TENANTS}
    rng = np.random.default_rng(SEED + 20)
    batch = 10_000  # the stream phase's update batch
    deg = stream.engine("torch").degrees.cpu().numpy()
    live = np.flatnonzero(deg > 0)
    out.update(n=int(deg.size), m=int(stream.engine("torch").m), live_vertices=int(live.size))
    # update rows by the paper's §7.3 method over a second rMAT draw at the
    # stream's size: 90% inserts, 10% deletes (rows already present, or
    # absent, are no-ops)
    E1 = rmat_symmetric_device(18, 2_000_000, SEED + 21)
    _, rows = st.make_update_stream(E1, 6 * batch, seed=SEED + 21)

    kinds = [k for k, _ in SERVE_MIX]
    probs = [p for _, p in SERVE_MIX]
    svc = GraphQueryService(stream, max_batch=16, default_deadline_s=0.25,
                            tenant_weights=SERVE_TENANTS, work_conserving=True,
                            update_batch=batch)
    records, sessions, errors = [], [], []
    rec_lock = threading.Lock()
    stop = threading.Event()

    def pick(crng, kind):
        if kind == "cc":
            return None
        return int(live[min(crng.zipf(SERVE_ZIPF) - 1, live.size - 1)])

    def client(i: int) -> None:
        crng = np.random.default_rng(SEED + 100 + i)
        tenant = "alice" if i % 2 == 0 else "bob"
        k = 0
        try:
            while not stop.is_set():
                k += 1
                if k % 8 == 2:  # now and then a pinned session of two queries
                    with rec_lock:
                        sess = svc.session(tenant) if len(sessions) < SERVE_SESSIONS else None
                        answers = []
                        if sess is not None:
                            sessions.append((sess, answers))
                    if sess is not None:
                        for kind in ("bfs", kinds[1 + crng.integers(3)]):
                            src = pick(crng, kind)
                            answers.append((kind, src, sess.query(kind, source=src)
                                            .result(timeout=120)))
                        continue
                kind = kinds[crng.choice(len(kinds), p=probs)]
                t = svc.submit(kind, source=pick(crng, kind), tenant=tenant)
                t.result(timeout=120)
                with rec_lock:
                    records.append((kind, t.latency_s, t.cached, bool(t.deadline_missed),
                                    t.t_submit))
        except Exception as e:  # noqa: BLE001 - surfaced by the main thread
            errors.append(f"client {i}: {type(e).__name__}: {e}")
            stop.set()

    def feeder() -> None:
        # a batch goes in whole, and at once (the writer drains it as one),
        # when the writer has published the last one
        try:
            for lo in range(0, rows.shape[0], batch):
                svc.flush_updates(timeout=300)
                if stop.is_set():
                    return
                svc.updates.put_many(rows[lo:lo + batch])
        except Exception as e:  # noqa: BLE001
            errors.append(f"feeder: {type(e).__name__}: {e}")
            stop.set()

    with svc:
        sr.reset_launches()
        t0 = time.perf_counter()
        svc.warmup()
        torch.cuda.synchronize()
        out["warmup_s"] = time.perf_counter() - t0
        threads = [threading.Thread(target=client, args=(i,)) for i in range(SERVE_CLIENTS)]
        st_start = svc.stats()
        t_quiet = time.perf_counter()
        for th in threads:
            th.start()
        stop.wait(SERVE_QUIET_S)  # the clients alone
        st_quiet = svc.stats()
        t_live = time.perf_counter()
        threads.append(threading.Thread(target=feeder))
        threads[-1].start()
        stop.wait(SERVE_LOAD_S)  # the clients and the writer
        stop.set()
        t_end = time.perf_counter()
        for th in threads:
            th.join(timeout=300)
        out["join_s"] = time.perf_counter() - t_end
        if errors or any(th.is_alive() for th in threads):
            raise AssertionError(f"graph_serve: load failed: {errors[:4]}")
        st_load = svc.stats()
        t0 = time.perf_counter()
        svc.flush_updates(timeout=300)
        svc.flush_promotions(timeout=300)
        torch.cuda.synchronize()
        out["flush_after_load_s"] = time.perf_counter() - t0
        launches = {k: sr.LAUNCHES[k] for k in ("segment_sum", "segment_sum_weighted")}
        if min(launches.values()) == 0:
            raise AssertionError(f"graph_serve: a kernel was never launched: {launches}")
        st_all = svc.stats()

        # sessions opened during the load: every answer from its pinned version
        t0 = time.perf_counter()
        sess_err, n_sess_answers = 0.0, 0
        for sess, answers in sessions:
            for kind, src, ans in answers:
                sess_err = max(sess_err, check_answer(
                    ans, answer_on(stream, sess.version, kind, src), kind, "graph_serve session"))
                n_sess_answers += 1
            sess.close(timeout=60)
        # quiescent: one unpinned query of each kind on the current version
        quiet_err = 0.0
        v = stream.acquire()
        try:
            for kind in KINDS:
                src = None if kind == "cc" else int(live[0])
                got = svc.query(kind, source=src, timeout=120)
                quiet_err = max(quiet_err, check_answer(
                    got, answer_on(stream, v, kind, src), kind, "graph_serve quiescent"))
        finally:
            stream.release(v)
        out["checks_s"] = time.perf_counter() - t0
        cache = st_all["cache"]
        if (cache["promoted_dropped"] != 0 or cache["promote_errors"] != 0
                or cache["promoted_incremental"] == 0):
            raise AssertionError(f"graph_serve: promotions {cache}")

    # latency and throughput of each window, from the tickets submitted in it
    def window(lo: float, hi: float, st0: dict, st1: dict) -> dict:
        recs = [r for r in records if lo <= r[4] < hi]
        span = hi - lo
        lat = {k: [r[1] for r in recs if r[0] == k] for k in kinds}
        miss = {k: [r[1] for r in recs if r[0] == k and not r[2]] for k in kinds}
        lanes = {k: {f: st1["lanes"][k][f] - st0["lanes"][k][f]
                     for f in ("flushed_requests", "flushed_batches", "full_flushes",
                               "deadline_flushes", "idle_flushes")} for k in kinds}
        drained = st1["updates"]["drained"] - st0["updates"]["drained"]
        return {
            "at_s": lo - t_phase, "s": span, "answers": len(recs), "qps": len(recs) / span,
            "qps_by_kind": {k: len(v) / span for k, v in lat.items()},
            "p50_s": {k: _pct(v, 50) for k, v in lat.items()},
            "p99_s": {k: _pct(v, 99) for k, v in lat.items()},
            "miss_p50_s": {k: _pct(v, 50) for k, v in miss.items()},
            "miss_p99_s": {k: _pct(v, 99) for k, v in miss.items()},
            "mean_batch_per_flush": {k: v["flushed_requests"] / max(v["flushed_batches"], 1)
                                     for k, v in lanes.items()},
            "flushes": {k: {f: v[f] for f in ("full_flushes", "deadline_flushes",
                                              "idle_flushes")} for k, v in lanes.items()},
            "deadline_miss_pct": 100.0 * sum(r[3] for r in recs) / max(len(recs), 1),
            "cache_hit_answers": sum(r[2] for r in recs),
            "publishes": st1["publishes"] - st0["publishes"],
            "updates_drained": drained, "writer_updates_per_s": drained / span,
        }

    out.update(
        quiet=window(t_quiet, t_live, st_start, st_quiet),
        live=window(t_live, t_end, st_quiet, st_load),
        tenants={t: {k: st_all["tenants"][t][k] for k in ("completed", "cached")}
                 for t in SERVE_TENANTS},
        cache={k: cache[k] for k in ("hits", "misses", "hit_rate", "evictions",
                                     "promoted_incremental", "promoted_full", "promoted_dropped",
                                     "promote_errors")},
        publishes=st_all["publishes"],
        live_versions=st_all["live_versions"],
        sessions=len(sessions), session_answers=n_sess_answers,
        session_pagerank_max_abs_err=sess_err, quiescent_pagerank_max_abs_err=quiet_err,
        launches=launches,
    )
    if out["live"]["publishes"] == 0:
        raise AssertionError("graph_serve: the writer published nothing under load")
    out["cache_on_off"] = serve_cache_on_off(stream)
    out["subscriptions"] = serve_subscriptions(stream, E1, live, rng)
    out["kernel_check"] = stream_kernel_check(stream.engine("torch"), (1, 16), "graph_serve")
    out["launches_phase"] = {k: sr.LAUNCHES[k] for k in launches}
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return launches


def serve_cache_on_off(stream) -> dict:
    """The reference's replay through a cache-off and a cache-on service on
    the same stream, one publish between two rounds: the answers must be
    bit-identical."""
    from repro_torch.serve.graph import GraphQueryService

    t0 = time.perf_counter()
    off = GraphQueryService(stream, max_batch=16, result_cache=False)
    on = GraphQueryService(stream, max_batch=16, result_cache=True, fastpath=True)
    got = {False: [], True: []}
    with off, on:
        for rnd in range(2):
            if rnd:
                on.insert_edges(np.array([[3, 200], [200, 210]]))
                on.flush_updates(timeout=120)
                on.flush_promotions(timeout=120)
            for cache_on, svc in ((False, off), (True, on)):
                got[cache_on] += [np.asarray(svc.query(kind, source=src, timeout=120))
                                  for kind, src in SERVE_REPLAY]
        cache = on.stats()["cache"]
    for (kind, _), a, b in zip(SERVE_REPLAY * 2, got[False], got[True]):
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"graph_serve: {kind} with the cache on differs from off")
    if cache["hits"] == 0 or cache["promoted_dropped"] != 0 or cache["promote_errors"] != 0:
        raise AssertionError(f"graph_serve: cache on/off {cache}")
    return {"answers": len(got[True]), "hits": cache["hits"],
            "promoted_incremental": cache["promoted_incremental"],
            "promoted_full": cache["promoted_full"], "s": time.perf_counter() - t0}


def serve_subscriptions(stream, E1, live, rng) -> dict:
    """One subscription per kind, refreshed after each of ``SUB_PUBLISHES``
    insert publishes of 1% of the edges (new rMAT pairs): each refresh
    incremental and equal to a full recompute on the same version (a new
    subscription, whose time is the cold time-to-fresh).  The version's
    engine is built before both are timed (``engine_s``)."""
    import torch

    from repro_torch.core.traversal import algorithms as talg

    srcs = rng.choice(live, 4, replace=False)
    subs = {k: stream.subscribe(k, sources=srcs if k in ("bfs", "sssp") else None)
            for k in ("bfs", "sssp", "cc", "pagerank")}
    pairs = E1[E1[:, 0] < E1[:, 1]]
    k = stream.engine("torch").m // 200  # pairs: 1% of the directed edges
    fresh = {kind: {"incremental_s": [], "cold_s": []} for kind in subs}
    pr_rounds = {"incremental": [], "cold": []}
    publish_s, engine_s, pr_err = [], [], 0.0
    try:
        for _ in range(SUB_PUBLISHES):
            # held until both paths are timed, so that no refresh pays for
            # collecting the old version (the last one to move would)
            v_old = stream.acquire()
            t0 = time.perf_counter()
            stream.insert_edges(pairs[rng.choice(pairs.shape[0], k, replace=False)])
            torch.cuda.synchronize()
            publish_s.append(time.perf_counter() - t0)
            # the new version's engine and weighted degrees, which both
            # paths below need, are built outside their timings
            t0 = time.perf_counter()
            v = stream.acquire()
            try:
                stream._engine_for(v, "torch").weighted_degrees
            finally:
                stream.release(v)
            torch.cuda.synchronize()
            engine_s.append(time.perf_counter() - t0)
            for kind, sub in subs.items():
                r0 = talg.PAGERANK_ROUNDS.count
                t0 = time.perf_counter()
                value = sub.refresh()
                fresh[kind]["incremental_s"].append(time.perf_counter() - t0)
                r1 = talg.PAGERANK_ROUNDS.count
                t0 = time.perf_counter()
                with stream.subscribe(kind, sources=srcs if kind in ("bfs", "sssp") else None) \
                        as cold:
                    fresh[kind]["cold_s"].append(time.perf_counter() - t0)
                    if kind == "pagerank":
                        pr_rounds["incremental"].append(r1 - r0)
                        pr_rounds["cold"].append(talg.PAGERANK_ROUNDS.count - r1)
                    if cold.stamp != sub.stamp:
                        raise AssertionError("graph_serve: a publish raced the subscriptions")
                    if kind == "pagerank":
                        err = float(np.abs(value - cold.value).max())
                        pr_err = max(pr_err, err)
                        if not err <= 1e-6:  # DESIGN.md §5
                            raise AssertionError(f"graph_serve: warm pagerank off by {err}")
                    elif kind == "bfs":
                        if not all(np.array_equal(a, b) for a, b in zip(value, cold.value)):
                            raise AssertionError("graph_serve: incremental bfs differs")
                    elif not np.array_equal(value, cold.value):
                        raise AssertionError(f"graph_serve: incremental {kind} differs")
            stream.release(v_old)
        counts = {kind: (sub.n_full, sub.n_incremental) for kind, sub in subs.items()}
    finally:
        for sub in subs.values():
            sub.close()
    if any(n_incr < SUB_PUBLISHES for _, n_incr in counts.values()):
        raise AssertionError(f"graph_serve: a subscription left the incremental path: {counts}")
    return {
        "publish_pairs": int(k), "publish_s": publish_s, "engine_s": engine_s,
        "n_full_incremental": counts, "pagerank_max_abs_err": pr_err,
        "pagerank_rounds": pr_rounds,
        "time_to_fresh_s": {kind: {"incremental": float(np.median(f["incremental_s"])),
                                   "cold": float(np.median(f["cold_s"]))}
                            for kind, f in fresh.items()},
    }


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
    tuned = tune_totals()
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
            plain = lambda: chunked_call(s, msg, n, w, plain=True)  # noqa: E731
            tune = chunked_tile_sweep(s, msg, n, w, plain(), f"compressed_scale {name} D={D}")
            kern = lambda: chunked_call(s, msg, n, w, tile=tune["tile"])  # noqa: E731
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
                "max_abs_err": err, "same_bits": same_bits(kern, f"compressed_scale {name} D={D}"),
                "ms": time_ms(kern), "pipelined_ms": time_ms_pipelined(kern),
                "plain_ms": time_ms(plain), "raw_kernel_ms": time_ms(raw_k),
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None, "tune": tune,
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
            "max_abs_err": err, "same_bits": same_bits(kern, f"compressed_scale {name} decode"),
            "ms": time_ms(kern), "pipelined_ms": time_ms_pipelined(kern),
            "plain_ms": time_ms(plain), "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
            # the wrapper's host time against the device's, per call
            "split": launch_split(kern) if s.hi is not None else None,
        })
    out.update(kernels=cases, decode_kernels=decode_cases, autotune=tune_since(tuned),
               phase_s=time.perf_counter() - t_phase)
    emit(out)
    return launches, cases + decode_cases


# ---------------------------------------------------------------------------
# sharded phases: the range-sharded pool and its engines (8 shard rows on
# the card), held against the flat engines on the same edges
# ---------------------------------------------------------------------------

SHARDS = 8
SHARD_STREAM_BATCH = 10_000  # pairs per symmetric insert publish of the sharded stream


def int_weights(g):
    """Integer weights in 1..7, equal on (u, v) and (v, u), 0 on pad
    slots: SSSP over them is exact in float32 on every engine."""
    import torch

    src, dst = g.keys >> 32, g.keys & 0xFFFFFFFF
    w = ((torch.minimum(src, dst) * 1000003 + torch.maximum(src, dst)) % 7 + 1).float()
    return w * (torch.arange(g.edge_capacity, device=g.device) < g.m)


def offset_keys(seg, n: int):
    """A per-row ascending int32[S, cap] segment key as the one-launch
    shape's shard-offset keys ``s * (n + 1) + key``, flattened."""
    import torch

    S = seg.shape[0]
    shift = torch.arange(S, device=seg.device, dtype=torch.int32) * (n + 1)
    return (seg + shift[:, None]).reshape(-1).contiguous()


def timed_s(fn):
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t


# PageRank's largest error relative to each entry: at 2^22 vertices a
# mean entry is 1/n ~ 2.4e-7, so atol 1e-6 alone checks only the hubs;
# the sharded engines measured 3.5e-7 to 4.9e-7 (H100 80GB HBM3, 700 W)
PAGERANK_RTOL = 1e-4


def check_pagerank(got, want, what: str) -> float:
    """PageRank against the flat engine: atol 1e-6 (DESIGN.md §5) and, per
    entry, ``PAGERANK_RTOL`` of the entry (floored at 1e-6 of the largest);
    returns that largest relative error."""
    if not (np.all(np.isfinite(got)) and np.allclose(got, want, rtol=0, atol=1e-6)):
        raise AssertionError(f"{what}: off by {np.abs(got - want).max()}")
    floor = 1e-6 * float(np.abs(want).max())
    rel = float((np.abs(got - want) / np.maximum(np.abs(want), floor)).max())
    if rel > PAGERANK_RTOL:
        raise AssertionError(f"{what}: an entry is off by {rel} of itself")
    return rel


def check_bc(got, want, what: str) -> float:
    """BC dependencies against the flat engine: float32 sums in another
    order, so rtol 1e-4 with atol 1e-4 * max|want| (the scores reach 1e6
    here; the port's BC tolerance)."""
    atol = 1e-4 * max(float(np.abs(want).max()), 1.0)
    if not (np.all(np.isfinite(got)) and np.allclose(got, want, rtol=1e-4, atol=atol)):
        raise AssertionError(f"{what}: off by {np.abs(got - want).max()}")
    return float(np.abs(got - want).max())


def sharded_queries(eng, eng_w, srcs, resets, ref, tag: str):
    """The phase's queries on one pair of sharded engines (plain,
    weighted), each answer held against ``ref`` (the flat engines' or the
    raw sharded engines')."""
    import torch

    from repro_torch.core.traversal import algorithms as talg

    res = {}
    (par, dep), res["bfs_batch16_s"] = timed_s(lambda: eng.bfs_batch(srcs))
    if not (torch.equal(par, ref["bfs"][0]) and torch.equal(dep, ref["bfs"][1])):
        raise AssertionError(f"{tag}: bfs parents or depths differ")
    res["max_depth"] = int(dep.max())
    cc, res["cc_s"] = timed_s(lambda: talg.connected_components(eng))
    if not np.array_equal(cc, ref["cc"]):
        raise AssertionError(f"{tag}: cc labels differ")
    dist, res["sssp_batch4_s"] = timed_s(lambda: eng_w.sssp_batch(srcs[:4]))
    if not torch.equal(dist, ref["sssp"]):
        raise AssertionError(f"{tag}: integer-weight sssp differs")
    pr, res["pagerank10_s"] = timed_s(lambda: talg.pagerank(eng, iters=10))
    res["pagerank_max_rel_err"] = check_pagerank(pr, ref["pr"], f"{tag} pagerank")
    prm, res["pagerank_multi8_s"] = timed_s(lambda: talg.pagerank_multi(eng, resets, iters=10))
    res["pagerank_multi_max_rel_err"] = check_pagerank(prm, ref["prm"], f"{tag} multi")
    wpr, res["weighted_pagerank10_s"] = timed_s(lambda: talg.weighted_pagerank(eng_w, iters=10))
    res["weighted_pagerank_max_rel_err"] = check_pagerank(wpr, ref["wpr"],
                                                          f"{tag} weighted pagerank")
    bc, res["bc_batch4_s"] = timed_s(lambda: eng.bc_batch(srcs[:4]).cpu().numpy())
    res["bc_max_abs_err"] = check_bc(bc, ref["bc"], f"{tag} bc")
    return res


def offset_reduce(eng, values_b):
    """A raw ``ShardedEngine``'s ``edge_map_reduce_batch`` in the launch
    shape the engine does not take: ONE segment-sum call over every row
    under shard-offset keys ``s * (n + 1) + v``, then the sum over the
    shard axis.  Timed beside the engine's per-shard launches."""
    import torch

    from repro_torch.kernels import ops as kops

    a, n, S = eng.aux, eng.n, eng.n_shards
    sbd = a.src_by_dst.reshape(-1).long()
    msg = torch.where(a.valid_by_dst.reshape(-1)[None, :], values_b[:, sbd], 0)
    msg = msg.T.float().contiguous()
    key = offset_keys(a.dst_sorted, n)
    if a.w_by_dst is None:
        out = kops.segment_sum(key, msg, S * (n + 1))
    else:
        out = kops.segment_sum_weighted(key, a.w_by_dst.reshape(-1).contiguous(), msg,
                                        S * (n + 1))
    return out.view(S, n + 1, -1)[:, :n].sum(0).T


def reduce_ms(eng, eng_w, resets, offset: bool) -> dict:
    """``edge_map_reduce_batch`` (plain and weighted) at D = 1 and 8,
    CUDA-event timed and uncounted: the reduce alone, without PageRank's
    host loop.  With ``offset`` (raw engines), also ``offset_reduce``,
    held to the engine's answer first."""
    import torch

    out = {}
    for D in (1, 8):
        vals = torch.as_tensor(resets[:D], dtype=torch.float32, device="cuda")
        for tag, e in (("plain", eng), ("weighted", eng_w)):
            out[f"{tag}_D{D}_per_shard"] = time_uncounted(
                lambda: e.edge_map_reduce_batch(vals), lambda f: time_ms(f, reps=10))
            if offset:
                check_close(offset_reduce(e, vals), e.edge_map_reduce_batch(vals),
                            f"offset-shape reduce {tag} D={D}")
                out[f"{tag}_D{D}_offset"] = time_uncounted(
                    lambda: offset_reduce(e, vals), lambda f: time_ms(f, reps=10))
    return out


def reference_answers(eng, eng_w, srcs, resets) -> dict:
    """The answers ``sharded_queries`` holds an engine pair to."""
    from repro_torch.core.traversal import algorithms as talg

    return {
        "bfs": eng.bfs_batch(srcs),
        "cc": talg.connected_components(eng),
        "sssp": eng_w.sssp_batch(srcs[:4]),
        "pr": talg.pagerank(eng, iters=10),
        "prm": talg.pagerank_multi(eng, resets, iters=10),
        "wpr": talg.weighted_pagerank(eng_w, iters=10),
        "bc": eng.bc_batch(srcs[:4]).cpu().numpy(),
    }


def sharded_kernel_cases(eng, eng_w, gen, what: str) -> list:
    """Rows 1-2 at the sharded reduce's two launch shapes: the per-shard
    launch of row 0 (its live dst-major lanes, keys relative to its range,
    the engine's) and the one launch over all rows under shard-offset keys
    (n_out = S * (n + 1)); D = 1 and 8, against the plain version, twice
    to the same bits, timed beside ``torch.segment_reduce`` over the key's
    offsets (row 1) and a CSR product (row 2).  At the per-shard launch,
    the engine's, every candidate tile first (``tile_sweep``), then the
    rest at the winner."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_reduce as sr

    a, n = eng.aux, eng.n
    L, lo, hi = eng._rows["dst"][0]
    shapes = {  # key, n_out, weights, live lanes (the engine's messages are 0 elsewhere)
        "per_shard": ((a.dst_sorted[0, :L] - lo).contiguous(), hi - lo + 1,
                      eng_w.aux.w_by_dst[0, :L].contiguous(), a.valid_by_dst[0, :L]),
        "offset": (offset_keys(a.dst_sorted, n), eng.n_shards * (n + 1),
                   eng_w.aux.w_by_dst.reshape(-1).contiguous(), a.valid_by_dst.reshape(-1)),
    }
    cases = []
    for shape, (key, n_out, w, live) in shapes.items():
        e_valid = int(live.sum())
        offs = torch.searchsorted(key, torch.arange(n_out + 1, device="cuda", dtype=torch.int32))
        cols = torch.arange(key.shape[0], device="cuda")
        csr_w = torch.sparse_csr_tensor(offs, cols, w, size=(n_out, key.shape[0]))
        for D in (1, 8):
            msg = torch.rand((key.shape[0], D), generator=gen, device="cuda") * live[:, None]
            for name, weighted in (("segment_sum", False), ("segment_sum_weighted", True)):
                if weighted:
                    kern_at = lambda t: sr.segment_sum_weighted_sorted(key, w, msg, n_out, t)  # noqa: E731
                    consult = lambda: ops.segment_sum_weighted(key, w, msg, n_out)  # noqa: E731
                    plain = lambda: sr.segment_sum_weighted_sorted_plain(key, w, msg, n_out)  # noqa: E731
                    lib = lambda: torch.sparse.mm(csr_w, msg)  # noqa: E731
                else:
                    kern_at = lambda t: sr.segment_sum_sorted(key, msg, n_out, t)  # noqa: E731
                    consult = lambda: ops.segment_sum(key, msg, n_out)  # noqa: E731
                    plain = lambda: sr.segment_sum_sorted_plain(key, msg, n_out)  # noqa: E731
                    lib = lambda: torch.segment_reduce(msg, "sum", offsets=offs.long(),  # noqa: E731
                                                       axis=0)
                tune = None
                if shape == "per_shard":
                    tune = tile_sweep(kern_at, plain(), f"{what} {shape} {name} D={D}", name,
                                      {"E": int(key.shape[0]), "n": n_out, "D": D}, consult)
                kern = lambda: kern_at(tune["tile"] if tune else 4096)  # noqa: E731
                err = check_close(kern(), plain(), f"{what} {shape} {name} D={D}")
                check_close(lib(), plain(), f"{what} {shape} {name} D={D} library")
                bound_ms, bound_by = bound(e_valid, n_out, D, weighted)
                cases.append({
                    "name": name, "shape": shape, "D": D, "E": int(key.shape[0]),
                    "E_valid": e_valid, "n_out": n_out, "max_abs_err": err,
                    "same_bits": same_bits(kern, f"{what} {shape} {name} D={D}"),
                    "ms": time_ms(kern), "pipelined_ms": time_ms_pipelined(kern),
                    "plain_ms": time_ms(plain, reps=3), "library_ms": time_ms(lib, reps=3),
                    "bound_ms": bound_ms, "bound_by": bound_by, "tune": tune,
                })
    return cases


def phase_sharded_scale(g, aux) -> tuple:
    """The raw sharded engine at the scale phase's size (2^22 vertices,
    66 M directed edges), ``SHARDS`` rows made from the flat pool on the
    card, held against the flat ``TorchEngine`` on the same pool."""
    import torch

    from repro_torch.core.traversal import ShardedEngine, sharded_graph_of_flat
    from repro_torch.core.traversal import algorithms as talg
    from repro_torch.core.traversal import sharded_backend as sb
    from repro_torch.core.traversal import torch_backend as tb
    from repro_torch.kernels import segment_reduce as sr

    t_phase = time.perf_counter()
    n, m = g.n, int(g.m)
    out = {"phase": "sharded_scale", "n": n, "m": m, "n_shards": SHARDS,
           "flat_edge_capacity": g.edge_capacity}
    rng = np.random.default_rng(SEED + 21)
    srcs = rng.choice(np.flatnonzero(aux.degrees.cpu().numpy() > 0), 16, replace=False)
    resets = rng.random((8, n))
    resets /= resets.sum(1, keepdims=True)
    gw = g._replace(weights=int_weights(g))
    flat, flat_w = tb.TorchEngine(g, aux=aux), tb.TorchEngine(gw)
    ref, out["flat_answers_s"] = timed_s(lambda: reference_answers(flat, flat_w, srcs, resets))
    out["flat_resident_bytes_per_edge"] = flat.resident_nbytes / m
    del flat_w
    # the flat engine's answers the ``ranks`` phase's engines are held to
    RANKS_DIR.mkdir(parents=True, exist_ok=True)
    np.savez(RANKS_DIR / "scale_ref.npz", srcs=srcs, pr=np.asarray(ref["pr"], np.float32),
             bfs_parents=digest(ref["bfs"][0]), bfs_depths=digest(ref["bfs"][1]),
             bfs=digest(talg.bfs(flat, int(srcs[0]))), cc=digest(ref["cc"]),
             sssp=digest(ref["sssp"]))

    sr.reset_launches()
    sg, out["sharded_graph_of_flat_s"] = timed_s(lambda: sharded_graph_of_flat(g, SHARDS))
    sgw = sg._replace(pool=sg.pool._replace(vals=sharded_graph_of_flat(gw, SHARDS).pool.vals))
    del gw
    eng, out["shard_aux_s"] = timed_s(lambda: ShardedEngine(sg))
    eng_w = ShardedEngine(sgw)
    out["cap_per"] = sg.pool.cap_per
    out["shard_counts"] = sg.pool.n.tolist()
    out["resident_bytes_per_edge"] = eng.resident_nbytes / m
    with sb.collective_log() as log:
        out.update(sharded_queries(eng, eng_w, srcs, resets, ref, "sharded_scale"))
    launches = dict(sr.LAUNCHES)
    for k in ("segment_sum", "segment_sum_weighted"):
        if launches[k] == 0:
            raise AssertionError(f"sharded_scale: {k} was never launched: {launches}")
    out["launches"] = launches
    out["collectives"] = {"count": len(log), "max_operand_bytes": max(b for _, b in log),
                          "pool_bytes": sg.pool.data.numel() * 8}
    if out["collectives"]["max_operand_bytes"] * 4 > out["collectives"]["pool_bytes"]:
        raise AssertionError("sharded_scale: a collective moved a pool-sized operand")
    out["reduce_ms"] = reduce_ms(eng, eng_w, resets, offset=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    out["kernels"], out["kernel_checks_s"] = timed_s(
        lambda: sharded_kernel_cases(eng, eng_w, gen, "sharded_scale"))
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return launches, out["kernels"]


def phase_sharded_compressed() -> tuple:
    """``CompressedShardedEngine`` on the compressed_scale phase's rMAT
    communities (2^22 vertices, ~63 M edges, drawn again on the card) in
    the adaptive and the int16 layout, plain and weighted, held against
    the raw sharded engines on the same edges; then rows 3-6 on the
    one-launch shape of each layout's dst lane and rows 8-9 on its source
    lane, against their plain versions."""
    import torch

    from repro_torch.core import compressed as cz
    from repro_torch.core import flat_graph as fg
    from repro_torch.core import sharded_pool as sp
    from repro_torch.core.traversal import (CompressedShardedEngine, ShardedEngine,
                                            sharded_graph_of_flat)
    from repro_torch.kernels import delta_decode as dd
    from repro_torch.kernels import segment_reduce as sr

    t_phase = time.perf_counter()
    log_c, n_comm = 15, 128
    n = n_comm << log_c
    edges = rmat_symmetric_device(log_c, 2**25, seed=4, communities=n_comm)
    g = fg.from_edges(n, edges, device="cuda")
    del edges
    m = int(g.m)
    out = {"phase": "sharded_compressed", "n": n, "m": m, "n_shards": SHARDS}
    rng = np.random.default_rng(SEED + 22)
    srcs = rng.choice(np.flatnonzero(torch.diff(g.offsets).cpu().numpy() > 0), 16, replace=False)
    resets = rng.random((8, n))
    resets /= resets.sum(1, keepdims=True)
    sg = sharded_graph_of_flat(g, SHARDS)
    sgw = sharded_graph_of_flat(g._replace(weights=int_weights(g)), SHARDS)
    del g
    raw, raw_w = ShardedEngine(sg), ShardedEngine(sgw)
    ref, out["raw_answers_s"] = timed_s(lambda: reference_answers(raw, raw_w, srcs, resets))
    out["raw_resident_bytes_per_edge"] = raw.resident_nbytes / m
    del raw, raw_w
    torch.cuda.empty_cache()

    sr.reset_launches()
    dd.reset_launches()
    layouts, lanes = {}, {}
    for name, kw in (("adaptive", {}), ("fixed2", {"width": 2})):
        res = {}
        (csg, csgw), res["compress_s"] = timed_s(
            lambda: (sp.compress_sharded(sg, **kw), sp.compress_sharded(sgw, **kw)))
        res["dst_bytes_per_edge"] = cz.stream_nbytes(csg.pool.dst) / m
        (eng, eng_w), res["engine_s"] = timed_s(
            lambda: (CompressedShardedEngine(csg), CompressedShardedEngine(csgw)))
        res["resident_bytes_per_edge"] = eng.resident_nbytes / m
        res.update(sharded_queries(eng, eng_w, srcs, resets, ref, f"sharded_compressed {name}"))
        res["reduce_ms"] = reduce_ms(eng, eng_w, resets, offset=False)
        layouts[name] = res
        lanes[name] = (eng.caux, eng_w.caux.w_by_dst, eng._rows["dst"][0], eng._width)
        del eng, eng_w, csg, csgw
        torch.cuda.empty_cache()
    launches = {**sr.LAUNCHES, **dd.LAUNCHES}
    for k in CHUNKED_KERNELS + DECODE_KERNELS[:2]:
        if launches[k] == 0:
            raise AssertionError(f"sharded_compressed: {k} was never launched: {launches}")
    out.update(layouts=layouts, launches=launches)

    # the kernels at these shapes, uncounted: rows 3-6 on the dst lane in
    # both launch shapes (row 0's live chunks keyed from its range, the
    # engine's; all rows under shard-offset anchors), rows 8-9 on the
    # source lane
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    shift = torch.arange(SHARDS, device="cuda", dtype=torch.int32) * (n + 1)
    cases, decode_cases = [], []
    for name, (caux, w_rows, (L, lo, hi), width) in lanes.items():
        f = caux.dst_sorted_c
        R = -(-L // cz.CHUNK)
        cap = width  # the engine's live width: the fullest row's chunks
        pre = cz.row_prefix(f, cap // cz.CHUNK)
        shapes = {  # stream, n_out, weights, live lanes
            "per_shard": (cz.ChunkedStream(f.anchors[0, :R] - lo, f.deltas[0, :R],
                                           f.ovf_pos[0, :R], f.ovf_add[0, :R], f.spill[0],
                                           None if f.hi is None else f.hi[0],
                                           None if f.wide is None else f.wide[0, :R]),
                          hi - lo + 1, w_rows[0, :R * cz.CHUNK].contiguous(),
                          torch.arange(R * cz.CHUNK, device="cuda") < L),
            "offset": (cz.flatten_rows(pre._replace(anchors=pre.anchors + shift[:, None])),
                       SHARDS * (n + 1), w_rows[:, :cap].reshape(-1).contiguous(),
                       (torch.arange(cap, device="cuda")[None, :] < caux.m_valid[:, None])
                       .reshape(-1)),
        }
        for shape, (s, n_out, w_all, live) in shapes.items():
            e_valid = int(live.sum())
            for weighted in (False, True):
                w = w_all if weighted else None
                for D in (1, 8):
                    # pad lanes carry 0, as the engine's masked messages do
                    msg = torch.rand((s.length, D), generator=gen, device="cuda") * live[:, None]
                    plain = lambda: chunked_call(s, msg, n_out, w, plain=True)  # noqa: E731
                    what = f"sharded_compressed {name} {shape} D={D}"
                    tune = (chunked_tile_sweep(s, msg, n_out, w, plain(), what)
                            if shape == "per_shard" else None)
                    kern = lambda: chunked_call(s, msg, n_out, w,  # noqa: E731
                                                tile=tune["tile"] if tune else 4096)
                    err = check_close(kern(), plain(), what)
                    bound_ms, bound_by = chunked_bound(s, e_valid, n_out, D, weighted)
                    cases.append({
                        "name": chunked_name(s, weighted), "layout": name, "shape": shape,
                        "D": D, "R": s.deltas.shape[0], "E_valid": e_valid, "n_out": n_out,
                        "max_abs_err": err, "same_bits": same_bits(kern, what),
                        "ms": time_ms(kern), "pipelined_ms": time_ms_pipelined(kern),
                        "plain_ms": time_ms(plain, reps=3), "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": None, "tune": tune,
                    })
        s = cz.flatten_rows(cz.row_prefix(caux.srcbd_c, cap // cz.CHUNK))  # as the reduce reads it
        kern, plain = decode_calls(s)
        err = check_equal(kern(), plain(), f"sharded_compressed {name} srcbd_c decode")
        bound_ms, bound_by = chunked_decode_bound(s)
        decode_cases.append({
            "name": "delta_decode_chunked" + ("_adaptive" if s.hi is not None else ""),
            "layout": name, "lane": "srcbd_c", "R": s.deltas.shape[0],
            "max_abs_err": err, "same_bits": same_bits(kern, f"sharded_compressed {name} decode"),
            "ms": time_ms(kern), "pipelined_ms": time_ms_pipelined(kern),
            "plain_ms": time_ms(plain, reps=3), "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
        })
    out.update(kernels=cases, decode_kernels=decode_cases, phase_s=time.perf_counter() - t_phase)
    emit(out)
    return launches, cases + decode_cases


def phase_sharded_stream(plain_stream) -> dict:
    """``AspenStream(mirror="sharded")`` from the stream phase's current
    tree (2^18 vertices): each publish is applied to it and to the flat
    stream, and after each the shard lanes are held against the flat
    mirror's edges and ``query_batch`` against the flat engine.  The
    third publish is an out-edge batch from 64 vertices sized past the
    fullest shard's slack, so the capacity policy rebalances; the fourth
    deletes every 64th row of it."""
    import torch

    from repro_torch.core import flat_graph as fg
    from repro_torch.core import sharded_pool as sp
    from repro_torch.core import streaming as st
    from repro_torch.kernels import segment_reduce as sr

    t_phase = time.perf_counter()
    v = plain_stream.acquire()
    try:
        tree = v.graph
        t = time.perf_counter()
        sst = st.AspenStream(tree, mirror="sharded", n_shards=SHARDS, device="cuda")
        build_s = time.perf_counter() - t
    finally:
        plain_stream.release(v)
    flat0 = plain_stream.flat_graph()
    n = flat0.n
    live = np.flatnonzero(torch.diff(flat0.offsets).cpu().numpy() > 0)
    rng = np.random.default_rng(SEED + 23)
    out = {"phase": "sharded_stream", "n": n, "m0": int(flat0.m), "n_shards": SHARDS,
           "mirror_build_s": build_s}
    del flat0
    publish_s = {"sharded": [], "flat": []}
    checks = []

    def publish(method, *args, **kw):
        for tag, s in (("sharded", sst), ("flat", plain_stream)):
            t = time.perf_counter()
            getattr(s, method)(*args, **kw)
            torch.cuda.synchronize()
            publish_s[tag].append(time.perf_counter() - t)
        t = time.perf_counter()
        sg = sst.sharded_graph()
        flat = plain_stream.flat_graph()
        if not np.array_equal(sp.graph_to_edge_array(sg), fg.to_edge_array(flat)):
            raise AssertionError(f"sharded_stream: shard lanes differ from the flat mirror "
                                 f"after {method}")
        if sg.weighted and not np.array_equal(sp.graph_to_weight_array(sg),
                                              fg.to_weight_array(flat)):
            raise AssertionError("sharded_stream: value lanes differ from the flat mirror")
        srcs = rng.choice(live, 16, replace=False)
        got = sst.query_batch(srcs, kind="bfs")
        if not np.array_equal(got, plain_stream.query_batch(srcs, kind="bfs", backend="torch")):
            raise AssertionError(f"sharded_stream: bfs differs from the flat engine after {method}")
        if sg.weighted:
            got = sst.query_batch(srcs[:4], kind="sssp")
            want = plain_stream.query_batch(srcs[:4], kind="sssp", backend="torch")
            if not np.array_equal(got, want):
                raise AssertionError("sharded_stream: sssp differs from the flat engine")
        checks.append({"publish": method, "m": int(flat.m), "weighted": sg.weighted,
                       "counts": sg.pool.n.tolist(), "cap_per": sg.pool.cap_per,
                       "rebalances": sst.rebalances, "check_s": time.perf_counter() - t})

    sr.reset_launches()
    pairs = rng.choice(live, (SHARD_STREAM_BATCH, 2))
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    publish("insert_edges", pairs)
    publish("delete_edges", pairs[: pairs.shape[0] // 2])
    # past the slack of the fullest shard: the capacity policy rebalances
    counts = sst.sharded_graph().pool.n.cpu().numpy()
    k = int(sst.sharded_graph().pool.cap_per - counts.max()) + 1
    heads = live[-64:]
    per = -(-k // heads.size) + 1  # one row a head may be a self loop, dropped
    big = np.stack([np.repeat(heads, per),
                    np.concatenate([rng.choice(n, per, replace=False) for _ in heads])], 1)
    big = big[big[:, 0] != big[:, 1]]
    publish("insert_edges", big, symmetric=False)
    if sst.rebalances < 1:
        raise AssertionError("sharded_stream: the capacity policy did not rebalance")
    publish("delete_edges", big[::64], symmetric=False)
    out.update(
        launches=dict(sr.LAUNCHES), publishes=len(checks), big_batch_rows=int(big.shape[0]),
        rebalances=sst.rebalances, mean_publish_s={k: float(np.mean(v)) for k, v in publish_s.items()},
        publish_s=publish_s, checks=checks, shard_stats=sst.shard_stats(),
        phase_s=time.perf_counter() - t_phase)
    emit(out)
    return out


# ---------------------------------------------------------------------------
# ranks and moe_shardmap: the sharded engines, the sharded stream and the
# shard_map MoE across torch.distributed ranks.  Each rank is a child
# process (``chip_smoke.py --rank-job JOB RANK``) that meets its peers
# under a FileStore in build/ranks/ and writes its answers there; this
# process holds no process group.
# ---------------------------------------------------------------------------

RANKS_DIR = ROOT / "build" / "ranks"
RANK_TIMEOUT_S = 480
# job -> (world size, backend); None: one rank and no process group
RANK_JOBS = {
    "engines_nccl": (1, "nccl"),  # (a) every collective through NCCL
    "engines_gloo": (2, "gloo"),  # (b) two ranks sharing the card
    "stream_one": (1, None),  # (c) the one-rank stream the ranks are held to
    "stream_gloo": (2, "gloo"),  # (c) two ranks
    "moe_nccl": (1, "nccl"),  # moe_shardmap on a 1x1 mesh, FULL width
    "moe_gloo": (2, "gloo"),  # moe_shardmap on a 2x1 mesh, REDUCED width
    "train_one": (1, "nccl"),  # ranks_train: the one-rank step at n_micro=2
    "train_gloo": (2, "gloo"),  # ranks_train: ZeRO-1 on a (2, 1) mesh
}
TRAIN_JOBS = ("train_one", "train_gloo")  # started after the others end
# engines_gloo (15.3 GB a rank) starts when engines_nccl (23.2 GB) ends:
# beside the stream and MoE children and the parent, both at once came
# within 0.4 GB of the card's 80 GB
LATE_JOBS = {"engines_gloo": "engines_nccl"}
# ranks_serve: the service on the stream children's sharded stream
RANK_SERVE_REQUESTS = 64  # the fixed replay, graph_serve's mix
RANK_SERVE_WINDOW_S = 5.0  # each load window on rank 0
RANK_SERVE_UPDATE_BATCH = 4096  # update rows a writer batch in the second window
# ranks_train: smollm-360m FULL float32 at a global B 4 x S 512, 3 steps
TRAIN_RANK_BATCH, TRAIN_RANK_SEQ, TRAIN_RANK_STEPS = 4, 512, 3
TRAIN_RANK_CKPT = RANKS_DIR / "train_ckpt"  # the two ranks' checkpoint after step 2
# the ranks against the one-rank child on the card: cuBLAS and the
# attention's backward need not add in the CPU's order (bits reported)
TRAIN_RANK_LOSS_RTOL, TRAIN_RANK_ATOL = 1e-5, 1e-5
RANK_STREAM_LOG_N = 16  # cut from sharded_stream's 2^18: each rank builds its own tree
RANK_STREAM_DRAWS = 2**19
RANK_COMM = (15, 32)  # the compressed engines' rMAT communities: 32 of 2^15 vertices
MOE_RANK_TOL = {"bfloat16": 1e-2, "float32": 1e-5}  # of max|moe.py|


def digest(x) -> str:
    """sha1 of an array's bytes, with its dtype and shape."""
    import hashlib

    import torch

    a = np.ascontiguousarray(x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x))
    return f"{hashlib.sha1(a.tobytes()).hexdigest()}:{a.dtype}:{a.shape}"


def rank_launches() -> dict:
    from repro_torch.kernels import delta_decode as dd
    from repro_torch.kernels import segment_reduce as sr

    return {**{k: v for k, v in sr.LAUNCHES.items() if v},
            **{k: v for k, v in dd.LAUNCHES.items() if v}}


def rank_engine_answers(eng, eng_w, srcs) -> dict:
    """The digests (and PageRank) a rank's engines give."""
    import torch

    from repro_torch.core.traversal import algorithms as talg

    t = time.perf_counter()
    par, dep = eng.bfs_batch(srcs)
    out = {"bfs_batch": [digest(par), digest(dep)],
           "bfs": digest(talg.bfs(eng, int(srcs[0]))),
           "cc": digest(talg.connected_components(eng)),
           "sssp": digest(eng_w.sssp_batch(srcs[:4]))}
    pr = np.asarray(talg.pagerank(eng, iters=10), np.float32)
    torch.cuda.synchronize()
    out["queries_s"] = time.perf_counter() - t
    return out, pr


def rank_engines(tag: str) -> dict:
    """(a) / (b): ``ShardedEngine`` on sharded_scale's graph (2^22
    vertices, ~66 M edges, drawn again on the card from its seed), this
    rank's block of the 8 shard rows; its answers for the flat engine's
    (the parent's ``scale_ref.npz``).  Then ``CompressedShardedEngine``
    beside a raw one on rMAT communities (the compressed layout raises on
    plain rMAT past 2^15, as the reference's does)."""
    import torch

    from repro_torch.core import sharded_pool as sp
    from repro_torch.core.traversal import CompressedShardedEngine, ShardedEngine
    from repro_torch.core.traversal import sharded_backend as sb
    from repro_torch.kernels import delta_decode as dd
    from repro_torch.kernels import segment_reduce as sr

    ref = np.load(RANKS_DIR / "scale_ref.npz")
    srcs = ref["srcs"]
    mesh = sp.pool_mesh(SHARDS, "cuda")
    out = {"mesh_size": mesh.size}

    def build(log_n, draws, seed, communities=1):
        keys = rmat_keys_device(log_n, draws, seed, communities)
        src, dst = keys >> 32, keys & 0xFFFFFFFF
        w = ((torch.minimum(src, dst) * 1000003 + torch.maximum(src, dst)) % 7 + 1).float()
        n, m = communities << log_n, keys.numel()
        sg = sp.ShardedGraph(sp.from_sorted_device(keys, m, SHARDS, mesh=mesh), n)
        sgw = sp.ShardedGraph(sp.from_sorted_device(keys, m, SHARDS, w, mesh=mesh), n)
        return sg, sgw, m

    sg, sgw, out["m"] = build(22, 2**25, 2)
    sr.reset_launches()
    dd.reset_launches()
    with sb.collective_log() as log:
        eng, eng_w = ShardedEngine(sg), ShardedEngine(sgw)
        out["scale"], pr = rank_engine_answers(eng, eng_w, srcs)
    out["scale"]["pagerank_max_rel_err"] = check_pagerank(pr, ref["pr"], f"ranks {tag}")
    out["rows"] = sg.pool.rows
    out["resident_bytes"] = eng.resident_nbytes
    out["collectives"] = len(log)
    out["bytes_sent"] = sum(b for _, b in log)
    out["max_operand_bytes"] = max(b for _, b in log)
    del eng, eng_w, sg, sgw
    gc.collect()
    torch.cuda.empty_cache()

    log_c, n_comm = RANK_COMM
    cg, cgw, out["comm_m"] = build(log_c, 2**23, 4, n_comm)
    rng = np.random.default_rng(SEED + 24)
    csrcs = rng.choice(n_comm << log_c, 16, replace=False)
    raw, _ = rank_engine_answers(ShardedEngine(cg), ShardedEngine(cgw), csrcs)
    with sb.collective_log() as log:
        ce = CompressedShardedEngine(sp.compress_sharded(cg, mesh=mesh))
        cew = CompressedShardedEngine(sp.compress_sharded(cgw, mesh=mesh))
        comp, _ = rank_engine_answers(ce, cew, csrcs)
    for k in ("bfs_batch", "bfs", "cc", "sssp"):
        if comp[k] != raw[k]:
            raise AssertionError(f"ranks {tag}: compressed {k} differs from the raw engine")
    out["compressed"] = {"queries_s": comp["queries_s"], "raw_queries_s": raw["queries_s"],
                         "resident_bytes": ce.resident_nbytes, "bytes_sent": sum(b for _, b in log)}
    out["launches"] = rank_launches()
    for k in ("segment_sum", "segment_sum_chunked_adaptive", "delta_decode_chunked_adaptive"):
        if not out["launches"].get(k):
            raise AssertionError(f"ranks {tag}: {k} never launched on rank: {out['launches']}")
    out["host_copied"] = sorted(sb.HOST_COPIED)
    return out


def rank_stream(tag: str) -> dict:
    """(c): ``AspenStream(mirror="sharded", n_shards=8)`` on a tree built
    here (2^16 vertices), sharded_stream's four publishes (an insert, a
    delete of half of it, an out-edge batch past the fullest row's slack
    that makes the capacity policy rebalance, a delete of every 64th row
    of it); after each, the lanes of all 8 rows gathered here, BFS and
    PageRank from ``query_batch``."""
    import torch

    from repro_torch.core import graph as G
    from repro_torch.core import sharded_pool as sp
    from repro_torch.core import streaming as st
    from repro_torch.data.rmat import rmat_edges, symmetrize
    from repro_torch.kernels import segment_reduce as sr

    n = 2**RANK_STREAM_LOG_N
    edges = symmetrize(rmat_edges(RANK_STREAM_LOG_N, RANK_STREAM_DRAWS, seed=1))
    t = time.perf_counter()
    sst = st.AspenStream(G.build_graph(n, edges), mirror="sharded", n_shards=SHARDS,
                         device="cuda")
    out = {"n": n, "m0": int(edges.shape[0]), "tree_and_mirror_s": time.perf_counter() - t}
    mesh = sp.pool_mesh(SHARDS, "cuda")
    live = np.flatnonzero(np.bincount(edges[:, 0], minlength=n) > 0)
    rng = np.random.default_rng(SEED + 23)
    resets = rng.random((2, n))
    resets /= resets.sum(1, keepdims=True)
    checks, prs = [], []

    def publish(method, *args, **kw):
        t = time.perf_counter()
        getattr(sst, method)(*args, **kw)
        torch.cuda.synchronize()
        publish_s = time.perf_counter() - t
        p = sp.gather_pool(sst.sharded_graph().pool, mesh)
        srcs = rng.choice(live, 16, replace=False)
        checks.append({"publish": method, "publish_s": publish_s,
                       "keys": digest(sp.to_array(p)), "n": p.n.tolist(), "cap": p.cap_per,
                       "lo": digest(p.lo), "rows": sst.sharded_graph().pool.rows,
                       "rebalances": sst.rebalances,
                       "bfs": digest(sst.query_batch(srcs, kind="bfs"))})
        prs.append(np.asarray(sst.query_batch(kind="pagerank", resets=resets), np.float32))

    sr.reset_launches()
    pairs = rng.choice(live, (SHARD_STREAM_BATCH, 2))
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    publish("insert_edges", pairs)
    publish("delete_edges", pairs[: pairs.shape[0] // 2])
    counts = sp.shard_counts(sst.sharded_graph().pool, mesh)
    k = int(sst.sharded_graph().pool.cap_per - counts.max()) + 1
    heads = live[-64:]
    per = -(-k // heads.size) + 1
    big = np.stack([np.repeat(heads, per),
                    np.concatenate([rng.choice(n, per, replace=False) for _ in heads])], 1)
    big = big[big[:, 0] != big[:, 1]]
    publish("insert_edges", big, symmetric=False)
    if sst.rebalances < 1:
        raise AssertionError(f"ranks {tag}: the capacity policy did not rebalance")
    publish("delete_edges", big[::64], symmetric=False)
    np.save(RANKS_DIR / f"{tag}_pagerank.npy", np.stack(prs))
    out.update(checks=checks, launches=rank_launches(), rebalances=sst.rebalances,
               resident_bytes=sst.engine("sharded").resident_nbytes)
    if not out["launches"].get("segment_sum"):
        raise AssertionError(f"ranks {tag}: segment_sum never launched: {out['launches']}")
    out["serve"] = rank_serve(sst, edges, live, tag)
    return out


def rank_serve(sst, edges, live, tag: str) -> dict:
    """ranks_serve: ``GraphQueryService(backend="sharded")`` on the stream
    child's sharded stream, every rank building it; rank 0 serves and the
    other ranks follow its collective lane.  (1) a fixed replay of
    ``RANK_SERVE_REQUESTS`` (graph_serve's mix, zipf(2.0) sources over the
    live vertices) with the cache off: the replay, a session's BFS and
    SSSP across one publish, the replay again; then with the cache on: the
    replay, the same publish again (a new version of the same graph), the
    replay; (2) rank 0's closed-loop windows, 24 clients alone and beside a
    writer fed with ``UpdateQueue.put_many``.  Answers go to
    ``{tag}_serve.npz``; each service's lane log is hashed."""
    import hashlib
    import threading

    import torch
    import torch.distributed as dist

    from repro_torch.core import streaming as st
    from repro_torch.kernels import segment_reduce as sr
    from repro_torch.serve.graph import GraphQueryService

    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    rng = np.random.default_rng(SEED + 40)
    kinds = [k for k, _ in SERVE_MIX]
    probs = [p for _, p in SERVE_MIX]

    def src_of(crng, kind):
        return None if kind == "cc" else int(live[min(crng.zipf(SERVE_ZIPF) - 1,
                                                      live.size - 1)])

    replay = [(kinds[i], None) for i in rng.choice(len(kinds), RANK_SERVE_REQUESTS, p=probs)]
    replay = [(k, src_of(rng, k)) for k, _ in replay]
    pub = rng.choice(live, (32, 2))
    pub = pub[pub[:, 0] != pub[:, 1]]
    out = {"requests": len(replay), "n": int(2**RANK_STREAM_LOG_N)}
    logs = {}

    def serve(name, svc, body):
        t = time.perf_counter()
        if rank0:
            with svc:
                res = body(svc)
        else:
            svc.start()
            res = None
        log = svc.op_log
        logs[name] = {"ops": len(log), "sha1": hashlib.sha1(repr(log).encode()).hexdigest(),
                      "s": time.perf_counter() - t}
        return res

    def ask(svc, reqs):
        tickets = [svc.submit(k, source=s) for k, s in reqs]
        return [np.asarray(t.result(timeout=300)) for t in tickets]

    def publish(svc):
        svc.insert_edges(pub)
        svc.flush_updates(timeout=300)
        svc.flush_promotions(timeout=300)

    def cache_off(svc):
        with svc.session("t") as sess:
            q = [("bfs", replay[0][1] or int(live[0])), ("sssp", int(live[0]))]
            before = [np.asarray(sess.query(k, source=x).result(timeout=300)) for k, x in q]
            a = ask(svc, replay)
            publish(svc)
            after = [np.asarray(sess.query(k, source=x).result(timeout=300)) for k, x in q]
        if not all(np.array_equal(x, y) for x, y in zip(before, after)):
            raise AssertionError(f"ranks_serve {tag}: a session saw a publish")
        return a, ask(svc, replay)

    def cache_on(svc):
        a = ask(svc, replay)
        publish(svc)
        b = ask(svc, replay)
        return a, b, svc.stats()["cache"]

    sr.reset_launches()
    t0 = time.perf_counter()
    off = serve("cache_off", GraphQueryService(sst, backend="sharded", max_batch=16,
                                               result_cache=False), cache_off)
    on = serve("cache_on", GraphQueryService(sst, backend="sharded", max_batch=16,
                                             fastpath=True), cache_on)
    out["replay_s"] = time.perf_counter() - t0
    if rank0:
        answers = {}
        for name, rows in (("off_a", off[0]), ("off_b", off[1]), ("on_a", on[0]),
                           ("on_b", on[1])):
            for i, a in enumerate(rows):
                answers[f"{name}_{i}"] = a
        np.savez(RANKS_DIR / f"{tag}_serve.npz", **answers)
        out["kinds"] = [k for k, _ in replay]
        out["replay_cache"] = on[2]
        # cached against uncached, on the same graph (the second publish
        # re-inserts the first's pairs)
        for name in ("on_a", "on_b"):
            for i, (k, _) in enumerate(replay):
                a, b = answers[f"{name}_{i}"], answers[f"off_b_{i}"]
                same = np.array_equal(a, b)
                if not same and (k != "pagerank" or np.abs(a - b).max() > 1e-6):
                    raise AssertionError(f"ranks_serve {tag}: cached {k} differs from uncached")

    def windows(svc):
        import torch

        stop = threading.Event()
        records, errors = [], []
        lock = threading.Lock()
        _, rows = st.make_update_stream(edges, 4 * RANK_SERVE_UPDATE_BATCH, seed=SEED + 41)

        def client(i):
            crng = np.random.default_rng(SEED + 200 + i)
            try:
                while not stop.is_set():
                    kind = kinds[crng.choice(len(kinds), p=probs)]
                    t = svc.submit(kind, source=src_of(crng, kind),
                                   tenant="alice" if i % 2 == 0 else "bob")
                    t.result(timeout=300)
                    with lock:
                        records.append((t.t_submit, t.latency_s, t.cached))
            except Exception as e:  # noqa: BLE001 - surfaced below
                errors.append(f"client {i}: {type(e).__name__}: {e}")
                stop.set()

        def feeder():
            try:
                for lo in range(0, rows.shape[0], RANK_SERVE_UPDATE_BATCH):
                    svc.flush_updates(timeout=300)
                    if stop.is_set():
                        return
                    svc.updates.put_many(rows[lo:lo + RANK_SERVE_UPDATE_BATCH])
            except Exception as e:  # noqa: BLE001
                errors.append(f"feeder: {type(e).__name__}: {e}")
                stop.set()

        t = time.perf_counter()
        svc.warmup()
        torch.cuda.synchronize()
        res = {"warmup_s": time.perf_counter() - t}
        threads = [threading.Thread(target=client, args=(i,)) for i in range(SERVE_CLIENTS)]
        lane0 = svc.stats()["ranks"]
        t_quiet = time.perf_counter()
        for th in threads:
            th.start()
        stop.wait(RANK_SERVE_WINDOW_S)
        t_live = time.perf_counter()
        lane1 = svc.stats()["ranks"]
        threads.append(threading.Thread(target=feeder))
        threads[-1].start()
        stop.wait(RANK_SERVE_WINDOW_S)
        stop.set()
        t_end = time.perf_counter()
        lane2 = svc.stats()["ranks"]
        for th in threads:
            th.join(timeout=300)
        if errors or any(th.is_alive() for th in threads):
            raise AssertionError(f"ranks_serve {tag}: load failed: {errors[:4]}")
        svc.flush_updates(timeout=300)
        svc.flush_promotions(timeout=300)
        for name, lo, hi, a, b in (("quiet", t_quiet, t_live, lane0, lane1),
                                   ("live", t_live, t_end, lane1, lane2)):
            lat = sorted(r[1] for r in records if lo <= r[0] < hi)
            w = {"answers": len(lat), "qps": len(lat) / (hi - lo),
                 "p50_s": lat[len(lat) // 2] if lat else None,
                 "p99_s": lat[min(len(lat) - 1, int(0.99 * len(lat)))] if lat else None,
                 "cached": sum(1 for r in records if lo <= r[0] < hi and r[2])}
            if a is not None:
                w["lane_ops_per_s"] = (b["ops"] - a["ops"]) / (hi - lo)
                w["lane_busy_share"] = (b["op_s"] - a["op_s"]) / (hi - lo)
            res[name] = w
        st_ = svc.stats()
        res.update(publishes=st_["publishes"], cache=st_["cache"], ranks=st_["ranks"],
                   updates=st_["updates"])
        return res

    t0 = time.perf_counter()
    win = serve("windows", GraphQueryService(
        sst, backend="sharded", max_batch=16, default_deadline_s=0.25,
        tenant_weights=SERVE_TENANTS, work_conserving=True,
        update_batch=RANK_SERVE_UPDATE_BATCH), windows)
    out["windows_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    out["logs"] = logs
    out["launches"] = {k: sr.LAUNCHES[k] for k in ("segment_sum", "segment_sum_weighted")}
    if not out["launches"]["segment_sum"]:
        raise AssertionError(f"ranks_serve {tag}: row 1 never launched: {out['launches']}")
    if rank0:
        out["windows"] = win
        for c in (on[2], win["cache"]):
            if c["promote_errors"] or c["promoted_dropped"]:
                raise AssertionError(f"ranks_serve {tag}: promotion failed: {c}")
    return out


def rank_train(tag: str) -> dict:
    """ranks_train: smollm-360m FULL float32 at a global B 4 x S 512
    through ``launch.train`` (``data_mesh``, ``make_lm_run``,
    ``train_specs``).  ``train_gloo``: two gloo ranks sharing the card,
    ZeRO-1 on a (2, 1) mesh, 2 of the 4 rows each; ``train_one``: one
    NCCL rank at ``n_micro=2``, the step the ranks are held to.  Three
    steps; the ranks save their state with its specs after step 2; each
    child then restores that checkpoint onto its own world (the one-rank
    child waits for it) and takes step 3 again.  The final state goes to
    ``build/ranks/{job}_final`` (gathered, with its specs) for the parent
    to compare."""
    import torch
    import torch.distributed as dist

    from repro_torch._tree import leaves
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import smollm_360m
    from repro_torch.dist import shardings as SH
    from repro_torch.launch import train as launch
    from repro_torch.train import train_step as TS

    job = tag.rsplit("_", 1)[0]
    cfg = smollm_360m.FULL
    args = launch.parser().parse_args([
        "--arch", "smollm-360m", "--steps", str(TRAIN_RANK_STEPS),
        "--batch", str(TRAIN_RANK_BATCH), "--seq", str(TRAIN_RANK_SEQ), "--n-micro", "2",
        "--device", "cuda", "--seed", str(SEED)])
    mesh = launch.data_mesh("cuda")
    params, step_fn, batch_fn = launch.make_lm_run(cfg, args, mesh)
    specs = None if mesh is None else launch.train_specs("lm", cfg, params, mesh)
    state = TS.init_state(params)
    if mesh is not None:
        state = SH.place(state, specs, mesh)
    del params
    out = {"world": 1 if mesh is None else mesh.size(), "config": cfg.name,
           "batch": TRAIN_RANK_BATCH, "seq": TRAIN_RANK_SEQ,
           "opt_bytes": sum(t.numel() * t.element_size()
                            for t in leaves(state.opt.m) + leaves(state.opt.v))}
    gc.collect()
    torch.cuda.empty_cache()
    # the peaks of the set-up, each step and the save: the child's whole
    # peak is the largest of them and of what follows
    times, hist, peaks = [], [], []
    set_up_peak = torch.cuda.max_memory_allocated()
    for step in range(TRAIN_RANK_STEPS):
        if step == 2 and mesh is not None:
            # the save's peak on the card, and its bytes above the state
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            ckpt.save(str(TRAIN_RANK_CKPT), 2, state, specs, mesh=mesh)
            out["save_s"] = time.perf_counter() - t
            out["save_peak_bytes"] = torch.cuda.max_memory_allocated()
            out["save_extra_bytes"] = out["save_peak_bytes"] - held
            peaks.append(out["save_peak_bytes"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        state, m = step_fn(state, batch_fn(step))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        peaks.append(torch.cuda.max_memory_allocated())
        hist.append({k: float(v) for k, v in m.items()})
    out.update(step_s=times, s_per_step=steady(times), steps=hist, peak_bytes=max(peaks))
    # the ranks' step-2 checkpoint onto this world, and step 3 from it
    marker = TRAIN_RANK_CKPT / "step_000000002" / "COMMITTED"
    t = time.perf_counter()
    while not marker.exists():
        if time.perf_counter() - t > RANK_TIMEOUT_S:
            raise AssertionError(f"ranks_train {tag}: no step-2 checkpoint")
        time.sleep(0.5)
    out["ckpt_wait_s"] = time.perf_counter() - t
    t = time.perf_counter()
    s2, restored = ckpt.restore(str(TRAIN_RANK_CKPT), 2, device="cuda", template=state,
                                mesh=mesh, target_specs=specs)
    torch.cuda.synchronize()
    out["restore_s"] = time.perf_counter() - t
    restored, m = step_fn(restored, batch_fn(2))
    again = {k: float(v) for k, v in m.items()}
    out["resumed_step3"] = again
    out["resume_bits_equal"] = again == hist[2]
    if not np.isclose(again["loss"], hist[2]["loss"], rtol=TRAIN_RANK_LOSS_RTOL, atol=0):
        raise AssertionError(f"ranks_train {tag}: resumed step 3 {again} against {hist[2]}")
    del restored
    ckpt.save(str(RANKS_DIR / f"{job}_final"), TRAIN_RANK_STEPS, state, specs, mesh=mesh)
    if not all(np.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"ranks_train {tag}: a non-finite loss {hist}")
    if mesh is not None:
        dist.barrier()
    out["child_peak_bytes"] = max(peaks + [set_up_peak, torch.cuda.max_memory_allocated()])
    return out




def rank_moe(tag: str) -> dict:
    """``moe_apply_shardmap`` over a (ranks, 1) ("data", "model") mesh:
    this rank's rows of x against ``moe.moe_apply`` on the whole batch,
    both on the card from the same seeded weights.  On one NCCL rank
    qwen3-moe-30b-a3b FULL in bf16 at B 1 x 2048 (one layer's MoE block);
    on two gloo ranks its REDUCED width in float32 at B 2 x 1024 with
    capacity 16, so no expert overflows a rank's local slots."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import qwen3_moe_30b_a3b as qm
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import moe as M
    from repro_torch.models import moe_shardmap as MS

    world = dist.get_world_size()
    mesh = mesh_lib.rank_mesh((world, 1), ("data", "model"), device="cuda")
    if world == 1:
        cfg, dtype, B, S = qm.FULL, torch.bfloat16, 1, MOE_PREFILL_S
    else:
        cfg, dtype, B, S = qm.REDUCED, torch.float32, 2, 1024
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    p = M.moe_init(gen, cfg, dtype, device="cuda")
    x = torch.randn((B, S, cfg.d_model), generator=gen, device="cuda").to(dtype)
    b = B // world
    di = mesh.get_coordinate()[0]
    want = M.moe_apply(p, cfg, x)[di * b:(di + 1) * b]
    got = MS.moe_apply_shardmap(p, cfg, x[di * b:(di + 1) * b], mesh)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"moe_shardmap {tag}: a non-finite output")
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    tol = MOE_RANK_TOL[str(dtype).split(".")[1]]
    if err > tol * scale:
        raise AssertionError(f"moe_shardmap {tag}: off by {err} (max|want| {scale})")
    xl = x[di * b:(di + 1) * b].contiguous()
    return {"config": cfg.name, "dtype": str(dtype).split(".")[1], "B": B, "S": S,
            "mesh": [world, 1], "max_abs_err": err, "max_abs_want": scale,
            "shardmap_ms": time_ms(lambda: MS.moe_apply_shardmap(p, cfg, xl, mesh), reps=5),
            "moe_ms": time_ms(lambda: M.moe_apply(p, cfg, xl), reps=5)}



RANK_FNS = {"engines": rank_engines, "stream": rank_stream, "moe": rank_moe,
            "train": rank_train}


def rank_job(job: str, rank: int) -> int:
    """``chip_smoke.py --rank-job JOB RANK``: one rank of ``RANK_JOBS[job]``
    on the card, its answers to build/ranks/JOB_RANK.json."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world, backend = RANK_JOBS[job]
    tag = f"{job}_{rank}"
    t = time.perf_counter()
    if backend is not None:
        mesh_lib.init_ranks(backend, "cuda", init_method=f"file://{RANKS_DIR / job}.store",
                            rank=rank, world_size=world)
    try:
        res = RANK_FNS[job.split("_")[0]](tag)
    finally:
        if backend is not None:
            dist.destroy_process_group()
    res.update(job=job, rank=rank, world=world, backend=backend,
               device=torch.cuda.get_device_name(0), wall_s=time.perf_counter() - t,
               child_peak_bytes=max(res.get("child_peak_bytes", 0),
                                    torch.cuda.max_memory_allocated()))
    (RANKS_DIR / f"{tag}.json").write_text(json.dumps(res))
    return 0


def start_rank_jobs(jobs=None) -> dict:
    """Every rank of ``jobs`` (default: ``RANK_JOBS`` but ``TRAIN_JOBS`` and
    ``LATE_JOBS``), started at once, each a process that is stopped when
    this one exits; each reads a copy of the autotuner's table."""
    if jobs is None:
        jobs = [j for j in RANK_JOBS if j not in TRAIN_JOBS and j not in LATE_JOBS]
    jobs = list(jobs)
    for f in RANKS_DIR.glob("*"):
        if any(f.name.startswith(p) for j in jobs for p in (f"{j}_", f"{j}.", f"tune_{j}_")):
            shutil.rmtree(f) if f.is_dir() else f.unlink()
    if "train_gloo" in jobs:
        shutil.rmtree(TRAIN_RANK_CKPT, ignore_errors=True)
    procs = {}
    for job in jobs:
        world = RANK_JOBS[job][0]
        for r in range(world):
            tune = RANKS_DIR / f"tune_{job}_{r}.json"
            if TUNE_TABLE.exists():
                shutil.copy(TUNE_TABLE, tune)
            env = dict(os.environ, OMP_NUM_THREADS="2", REPRO_TORCH_AUTOTUNE_CACHE=str(tune))
            err = open(RANKS_DIR / f"{job}_{r}.err", "w")
            p = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--rank-job",
                                  job, str(r)], env=env, stdout=err, stderr=subprocess.STDOUT)
            err.close()
            atexit.register(lambda p=p: p.poll() is None and p.kill())
            procs[(job, r)] = p
    return procs


def wait_rank_jobs(procs: dict, jobs, t0: float) -> dict:
    """The jobs' results by job, each a list by rank; every rank must exit
    0 within ``RANK_TIMEOUT_S`` of ``t0``.  The first rank to exit
    otherwise, or the deadline, stops all of them, with the ranks' error
    output in the message."""
    keys = [(job, r) for job in jobs for r in range(RANK_JOBS[job][0])]

    def fail(what: str):
        for q in procs.values():
            q.poll() is None and q.kill()
        errs = "".join(f"\n--- {j}_{r}:\n" + (RANKS_DIR / f"{j}_{r}.err").read_text()[-2000:]
                       for j, r in keys)
        raise AssertionError(f"ranks: {what}{errs}")

    while True:
        running = [k for k in keys if procs[k].poll() is None]
        for job, r in keys:
            rc = procs[(job, r)].returncode
            if rc not in (None, 0):
                fail(f"{job} rank {r} exited {rc}")
        if not running:
            break
        if time.perf_counter() - t0 > RANK_TIMEOUT_S:
            fail(f"{running} still running after {RANK_TIMEOUT_S} s")
        time.sleep(0.2)
    out = {}
    for job, r in keys:
        out.setdefault(job, []).append(json.loads((RANKS_DIR / f"{job}_{r}.json").read_text()))
    return out


def phase_ranks(procs: dict, t0: float) -> dict:
    """(a) ``ShardedEngine`` / ``CompressedShardedEngine`` on one NCCL rank
    and (b) on two gloo ranks sharing the card (4 of 8 rows each): the
    flat engine's BFS, ``bfs_batch`` x16, CC and integer SSSP bit for bit,
    PageRank within atol 1e-6; (c) the sharded stream on two gloo ranks:
    after each publish the lanes of all rows and BFS equal the one-rank
    stream's, PageRank within atol 1e-6.  The segment-sum (and, for the
    compressed engine, decode) kernels launch on every rank."""
    import torch

    ref = np.load(RANKS_DIR / "scale_ref.npz")
    parent = {"allocated_bytes": torch.cuda.memory_allocated(),
              "reserved_bytes": torch.cuda.memory_reserved()}
    for late, after in LATE_JOBS.items():
        wait_rank_jobs(procs, (after,), t0)
        procs.update(start_rank_jobs((late,)))
    res = wait_rank_jobs(procs, ("engines_nccl", "engines_gloo", "stream_one", "stream_gloo"),
                         t0)
    out = {"phase": "ranks", "wait_s": time.perf_counter() - t0, "parent": parent,
           "engines": {}, "stream": {}}
    for job in ("engines_nccl", "engines_gloo"):
        world = RANK_JOBS[job][0]
        for r in res[job]:
            if r["rows"] != SHARDS // world or r["mesh_size"] != world:
                raise AssertionError(f"ranks {job}: rank {r['rank']} holds {r['rows']} rows")
            for k in ("bfs", "cc", "sssp"):
                if r["scale"][k] != str(ref[k]):
                    raise AssertionError(f"ranks {job}: rank {r['rank']} {k} differs from the "
                                         "flat engine")
            if r["scale"]["bfs_batch"] != [str(ref["bfs_parents"]), str(ref["bfs_depths"])]:
                raise AssertionError(f"ranks {job}: rank {r['rank']} bfs_batch differs")
        out["engines"][job] = [{k: r[k] for k in ("rank", "backend", "rows", "resident_bytes",
                                                  "collectives", "bytes_sent",
                                                  "max_operand_bytes", "launches", "host_copied",
                                                  "compressed", "wall_s")}
                               | {"queries_s": r["scale"]["queries_s"],
                                  "pagerank_max_rel_err": r["scale"]["pagerank_max_rel_err"]}
                               for r in res[job]]
    one = res["stream_one"][0]
    pr_one = np.load(RANKS_DIR / "stream_one_0_pagerank.npy")
    for r in res["stream_gloo"]:
        if len(r["checks"]) != len(one["checks"]) or r["rebalances"] != one["rebalances"]:
            raise AssertionError(f"ranks stream: rank {r['rank']} published otherwise")
        for i, (a, b) in enumerate(zip(r["checks"], one["checks"])):
            for k in ("keys", "n", "cap", "lo", "bfs"):
                if a[k] != b[k]:
                    raise AssertionError(f"ranks stream: rank {r['rank']} publish {i} {k} "
                                         "differs from one rank")
            if a["rows"] != SHARDS // 2:
                raise AssertionError(f"ranks stream: rank {r['rank']} holds {a['rows']} rows")
        pr = np.load(RANKS_DIR / f"stream_gloo_{r['rank']}_pagerank.npy")
        if not np.allclose(pr, pr_one, rtol=0, atol=1e-6):
            raise AssertionError(f"ranks stream: rank {r['rank']} pagerank off by "
                                 f"{np.abs(pr - pr_one).max()}")
    out["stream"] = {"n": one["n"], "m0": one["m0"], "rebalances": one["rebalances"],
                     "one_rank": {k: one[k] for k in ("tree_and_mirror_s", "launches",
                                                      "resident_bytes", "wall_s")}
                     | {"publish_s": [c["publish_s"] for c in one["checks"]]},
                     "ranks": [{k: r[k] for k in ("rank", "tree_and_mirror_s", "launches",
                                                  "resident_bytes", "wall_s")}
                               | {"publish_s": [c["publish_s"] for c in r["checks"]]}
                               for r in res["stream_gloo"]]}
    out["child_peak_bytes"] = {f"{job}_{r['rank']}": r["child_peak_bytes"]
                               for job, rs in res.items() for r in rs}
    emit(out)
    return res


def phase_ranks_serve(res: dict) -> dict:
    """ranks_serve, read from the stream children (``rank_serve``): rank
    0's replay answers against the one-rank service's (BFS, CC, SSSP bit
    for bit; PageRank within atol 1e-6), every follower's lane log equal
    to rank 0's, row 1 launched on every rank, no promotion error or
    drop; the windows' qps, p50 and p99, lane ops per second and the
    median broadcast."""
    one = res["stream_one"][0]["serve"]
    ranks = [r["serve"] for r in res["stream_gloo"]]
    got = np.load(RANKS_DIR / "stream_gloo_0_serve.npz")
    want = np.load(RANKS_DIR / "stream_one_0_serve.npz")
    pr_err, n = 0.0, 0
    for key in want.files:
        a, b = got[key], want[key]
        kind = one["kinds"][int(key.rsplit("_", 1)[1])]
        if kind == "pagerank":
            pr_err = max(pr_err, float(np.abs(a - b).max()))
        elif not np.array_equal(a, b):
            raise AssertionError(f"ranks_serve: {key} ({kind}) differs from one rank")
        n += 1
    if pr_err > 1e-6:
        raise AssertionError(f"ranks_serve: pagerank off by {pr_err}")
    def ops(s):
        return {k: (v["ops"], v["sha1"]) for k, v in s["logs"].items()}

    for r, s in enumerate(ranks[1:], 1):
        if ops(s) != ops(ranks[0]):
            raise AssertionError(f"ranks_serve: rank {r}'s op log differs from rank 0's")
    for r, s in enumerate(ranks):
        if not s["launches"]["segment_sum"]:
            raise AssertionError(f"ranks_serve: row 1 never launched on rank {r}")
    win, win1 = ranks[0]["windows"], one["windows"]
    out = {"phase": "ranks_serve", "n": one["n"], "requests": one["requests"],
           "answers_compared": n, "pagerank_max_abs_err": pr_err,
           "launches": [s["launches"] for s in ranks], "one_rank_launches": one["launches"],
           "ops": {k: v["ops"] for k, v in ranks[0]["logs"].items()},
           "replay_s": [s["replay_s"] for s in ranks], "one_rank_replay_s": one["replay_s"],
           "windows_s": [s["windows_s"] for s in ranks],
           "two_ranks": {w: win[w] for w in ("quiet", "live")}
           | {"warmup_s": win["warmup_s"], "publishes": win["publishes"],
              "broadcast_us_p50": win["ranks"]["broadcast_us_p50"],
              "lane_ops": win["ranks"]["ops"], "lane_s_by_op": win["ranks"]["op_s_by_op"],
              "cache": win["cache"]},
           "one_rank": {w: win1[w] for w in ("quiet", "live")}
           | {"warmup_s": win1["warmup_s"], "publishes": win1["publishes"]}}
    emit(out)
    return out


def phase_ranks_train(procs: dict, t0: float) -> dict:
    """ranks_train (``rank_train``): the two ZeRO-1 ranks against the
    one-rank child at ``n_micro=2``, losses within rtol
    ``TRAIN_RANK_LOSS_RTOL`` and every final leaf within
    ``TRAIN_RANK_ATOL`` (bits reported); each rank's optimizer bytes about
    half the one-rank child's; the resumed step 3 on each world."""
    res = wait_rank_jobs(procs, TRAIN_JOBS, t0)
    one, ranks = res["train_one"][0], res["train_gloo"]
    loss_err = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                   for r in ranks for a, b in zip(r["steps"], one["steps"]))
    if loss_err > TRAIN_RANK_LOSS_RTOL:
        raise AssertionError(f"ranks_train: losses off by {loss_err} of one rank's")
    with open(RANKS_DIR / "train_one_final" / f"step_{TRAIN_RANK_STEPS:09d}" /
              "manifest.json") as f:
        manifest = json.load(f)
    leaf_err, equal = 0.0, True
    for leaf in manifest["leaves"]:
        a = np.load(RANKS_DIR / "train_gloo_final" / f"step_{TRAIN_RANK_STEPS:09d}" /
                    leaf["file"])
        b = np.load(RANKS_DIR / "train_one_final" / f"step_{TRAIN_RANK_STEPS:09d}" /
                    leaf["file"])
        if not np.array_equal(a, b):  # the differences only where the bits differ
            equal = False
            leaf_err = max(leaf_err, float(np.abs(a.astype(np.float64) - b).max()))
    if leaf_err > TRAIN_RANK_ATOL:
        raise AssertionError(f"ranks_train: a leaf off by {leaf_err}")
    opt_share = [r["opt_bytes"] / one["opt_bytes"] for r in ranks]
    if max(opt_share) > 0.55:
        raise AssertionError(f"ranks_train: optimizer bytes {opt_share} of one rank's")
    for d in (TRAIN_RANK_CKPT, RANKS_DIR / "train_one_final", RANKS_DIR / "train_gloo_final"):
        shutil.rmtree(d, ignore_errors=True)
    keys = ("s_per_step", "step_s", "peak_bytes", "child_peak_bytes", "opt_bytes", "restore_s",
            "resume_bits_equal", "ckpt_wait_s", "wall_s")
    out = {"phase": "ranks_train", "config": one["config"], "batch": one["batch"],
           "seq": one["seq"], "steps": TRAIN_RANK_STEPS, "loss_max_rel_err": loss_err,
           "leaf_max_abs_err": leaf_err, "bits_equal": equal,
           "losses_equal": all(a["loss"] == b["loss"] for r in ranks
                               for a, b in zip(r["steps"], one["steps"])),
           "opt_share": opt_share, "save_s": ranks[0]["save_s"],
           "save_peak_bytes": [r["save_peak_bytes"] for r in ranks],
           "save_extra_bytes": [r["save_extra_bytes"] for r in ranks],
           "one_rank": {k: one[k] for k in keys} | {"steps": one["steps"]},
           "ranks": [{k: r[k] for k in keys} | {"steps": r["steps"]} for r in ranks]}
    emit(out)
    return out


def phase_moe_shardmap(procs: dict, t0: float) -> dict:
    """The shard_map MoE's ranks (started with the ``ranks`` phase's):
    qwen3-moe-30b-a3b FULL bf16 on a 1x1 NCCL mesh and REDUCED float32 on
    a 2x1 gloo mesh, each against ``moe.py`` on the same input."""
    res = wait_rank_jobs(procs, ("moe_nccl", "moe_gloo"), t0)
    out = {"phase": "moe_shardmap", "runs": [r for job in ("moe_nccl", "moe_gloo")
                                             for r in res[job]]}
    emit(out)
    return out


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
    """``time_ms`` (or ``timer``) of a kernel called only to be timed: every
    launch count is put back afterwards, so each keeps the main path's
    launches."""
    from repro_torch.kernels import csr_spmm
    from repro_torch.kernels import delta_decode as dd
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import segment_reduce as sr

    saved = [(d, dict(d)) for d in (sr.LAUNCHES, dd.LAUNCHES, csr_spmm.LAUNCHES, fd.LAUNCHES)]
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


def phase_gnn_sampled() -> tuple:
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
    return out, g, feats


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
                      common.GraphBatch(*(None if v is None else v.cpu() for v in batch)))
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
    built = {}  # tile -> (mask, tiles) on the card, host arrays
    for t in csr_spmm.TILES:
        m_np, t_np, _ = csr_spmm.tiles_from_edges(n, src_h, dst_h, vals_h, t, t)
        built[t] = (torch.from_numpy(m_np).cuda(), torch.from_numpy(t_np).cuda(), m_np, t_np)
    cases = []
    for D, xd, got, secs in runs:
        res = {"D": D, "spmm_from_edges_s": secs}
        agg = common.aggregate(xd[src.long()] * coeff[:, None], dst, n, "sum")
        res["vs_segment_sum_max_abs_err"] = check_close(got, agg, f"gnn_full spmm D={D} vs segsum",
                                                     1e-5, 1e-4)
        want = csr_spmm.block_spmm_plain(*built[csr_spmm.TILE][:2], xd)[:n]
        res["tune"] = tile_sweep(lambda t: csr_spmm.block_spmm(*built[t][:2], xd)[:n], want,
                                 f"gnn_full block_spmm D={D}", "spmm", {"n": n, "m": m},
                                 lambda: ops.spmm_from_edges(n, src_h, dst_h, xd, vals_h)[:n],
                                 1e-5, 1e-4)
        mask, tiles, mask_np, tiles_np = built[res["tune"]["tile"]]
        first = csr_spmm.block_spmm(mask, tiles, xd)
        if not torch.equal(first, csr_spmm.block_spmm(mask, tiles, xd)):
            raise AssertionError(f"gnn_full block_spmm D={D}: two calls differ in their bits")
        res["max_abs_err"] = check_close(first, csr_spmm.block_spmm_plain(mask, tiles, xd),
                                      f"gnn_full block_spmm D={D}", 1e-5, 1e-4)
        res["same_bits_twice"] = True
        res["bound_ms"], res["bound_by"], res["live_tiles"], res["nnz"] = spmm_bound(
            mask_np, tiles_np, n, D)
        res["tiles"] = int(mask_np.size)
        res["workspace_bytes"] = csr_spmm.workspace_bytes(*mask_np.shape, res["tune"]["tile"])
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
# the 3072-step check's depth: an eager step costs 1-2 ms of host time a
# layer, and the script's 1200 s no longer held 8 layers beside the rank
# phases on a slower host (1234 s)
SERVE_CHECK_LAYERS = 2


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
    out["kernel"] = flash_kernel_row(name, params, cfg, cache, tokens[-1])
    return out


def flash_kernel_row(name: str, params, cfg, cache, last_tok) -> dict:
    """Layer 0's kernel call of the last decode step (``last_tok`` at the
    cache's lengths less one) against its plain version, timed per call
    and back to back beside its bound, the plain version and SDPA; its
    plan, route, workspace, tensor-map cost and the per-call argtypes
    cost.  Every call here is a comparison: no count changes."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_decode as fd

    saved = dict(fd.LAUNCHES)
    B = last_tok.shape[0]
    q0 = _layer0_query(params, cfg, {"len": cache["len"] - 1}, last_tok)
    lens = cache["len"]  # the last step's lengths, its own token included
    kc, vc = cache["k"][0], cache["v"][0]
    want = fd.flash_decode_cache_plain(q0, kc, vc, lens)
    got = fd.flash_decode_cache(q0, kc, vc, lens)
    keys = int(torch.clamp(lens, max=kc.shape[1]).sum()) * cfg.n_kv_heads
    bound_ms, bound_by = flash_bound(keys, B * cfg.n_kv_heads, q0.shape[2], cfg.head_dim,
                                     kc.element_size(), q0.element_size())
    sdpa_q = q0.reshape(B, cfg.n_heads, 1, cfg.head_dim)
    k = {
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
    fd.LAUNCHES.update(saved)
    return k


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
    # the 3072-step check at smollm's width and SERVE_CHECK_LAYERS of its
    # 32 layers (with all 32 it took 172 s of this script's 1200 s)
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


TRAIN_STEPS = 6
TRAIN_CKPT_AT = 3  # the checkpoint holds the state after this many steps
TRAIN_LM_BATCH, TRAIN_LM_SEQ = 8, 512
TRAIN_REMAT_STEPS = 2  # per remat setting, for its peak memory and s/step
TRAIN_DCN_STEPS = 4
TRAIN_LONG_SEQ = 4096  # one step past CHUNKED_ATTN_THRESHOLD: the blockwise attention
# the resumed run's losses against the uninterrupted run's: the same
# float32 work on restored bits, so any difference is the card's own
# run-to-run order (reported as bit_identical)
TRAIN_RESUME_RTOL = 1e-5
# card against CPU (DESIGN.md §5's float32 class): loss rtol 1e-5; grad
# norm, parameters and moments rtol 1e-4, atol 1e-4 * max|CPU leaf|
TRAIN_LOSS_RTOL, TRAIN_STATE_RTOL = 1e-5, 1e-4
TRAIN_CKPT_DIR = ROOT / "build" / "train_ckpt"


def all_launches() -> int:
    from repro_torch.kernels import csr_spmm, delta_decode, flash_decode, segment_reduce

    return sum(sum(m.LAUNCHES.values())
               for m in (csr_spmm, delta_decode, flash_decode, segment_reduce))


def train_args(arch: str, steps: int, batch: int, device: str, reduced=False, seq=None):
    from repro_torch.launch import train as launch

    argv = ["--arch", arch, "--steps", str(steps), "--batch", str(batch), "--device", device,
            "--seed", str(SEED), "--log-every", "1"]
    return launch.parser().parse_args(argv + (["--reduced"] if reduced else [])
                                      + (["--seq", str(seq)] if seq else []))


def timed_steps(step_fn, times: list):
    """``step_fn`` with each call's wall time, synchronized, in ``times``."""
    import torch

    def step(state, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step_fn(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return out

    return step


def steady(times: list) -> float:
    """Median step time after the first (which pays the warm-up)."""
    return statistics.median(times[1:]) if len(times) > 1 else times[0]


def lm_train_run(cfg, args, lines: list) -> dict:
    """The uninterrupted 6 steps with the step-3 checkpoint, then the
    restore into a fresh state and steps 4-6 again."""
    import torch

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.dist.fault_tolerance import ResumableRun
    from repro_torch.launch import train as launch
    from repro_torch.train import train_step as TS

    class Run(ResumableRun):
        """Times its save; saves once (a second save at step 6 would only
        cost time)."""

        save_s = None

        def maybe_save(self, step, state):
            if self.save_s is not None:
                return False
            torch.cuda.synchronize()
            t = time.perf_counter()
            if super().maybe_save(step, state):
                self.save_s = time.perf_counter() - t
                return True
            return False

    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    params, step_fn, batch_fn = launch.make_lm_run(cfg, args)
    run = Run(str(TRAIN_CKPT_DIR), lambda: TS.init_state(params), save_every=TRAIN_CKPT_AT,
              device="cuda")
    start, state = run.restore_or_init()
    if start != 0:
        raise AssertionError(f"train: a fresh checkpoint directory restored step {start}")
    times = []
    torch.cuda.reset_peak_memory_stats()
    state, whole = launch.train_loop(timed_steps(step_fn, times), batch_fn, state, 0,
                                     TRAIN_STEPS, run, log=lines.append)
    peak = torch.cuda.max_memory_allocated()
    if ckpt.list_steps(str(TRAIN_CKPT_DIR)) != [TRAIN_CKPT_AT]:
        raise AssertionError(f"train: checkpoints {ckpt.list_steps(str(TRAIN_CKPT_DIR))}")
    step_dir = TRAIN_CKPT_DIR / f"step_{TRAIN_CKPT_AT:09d}"
    ckpt_bytes = sum(f.stat().st_size for f in step_dir.iterdir())
    final = state
    del state
    gc.collect()

    run2 = ResumableRun(str(TRAIN_CKPT_DIR), lambda: TS.init_state(params),
                        save_every=TRAIN_CKPT_AT, device="cuda")
    torch.cuda.synchronize()
    t = time.perf_counter()
    start, fresh = run2.restore_or_init()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    if start != TRAIN_CKPT_AT or int(fresh.opt.step) != TRAIN_CKPT_AT:
        raise AssertionError(f"train: restored step {start}, opt.step {int(fresh.opt.step)}")
    fresh, resumed = launch.train_loop(step_fn, batch_fn, fresh, start, TRAIN_STEPS, None,
                                       log=lines.append)
    tail = whole[TRAIN_CKPT_AT:]
    if [h["step"] for h in resumed] != [h["step"] for h in tail]:
        raise AssertionError("train: the resumed run took other steps")
    for a, b in zip(resumed, tail):
        for k in ("loss", "grad_norm", "lr"):
            if not np.isfinite(a[k]) or abs(a[k] - b[k]) > TRAIN_RESUME_RTOL * abs(b[k]):
                raise AssertionError(f"train: resumed step {a['step']} {k} {a[k]} != {b[k]}")
    same = all(a == b for a, b in zip(resumed, tail))
    same_state = all(torch.equal(x, y) for x, y in zip(_leaves(fresh), _leaves(final)))
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    first_loss(whole, np.log(cfg.vocab), 0.5, "smollm-360m")
    s = steady(times)
    return {"steps": whole, "resumed": resumed, "step_s": times,
            "s_per_step": s, "tokens_per_s": TRAIN_LM_BATCH * TRAIN_LM_SEQ / s,
            "max_memory_allocated": peak,
            "checkpoint": {"at_step": TRAIN_CKPT_AT, "bytes": ckpt_bytes, "save_s": run.save_s,
                           "restore_s": restore_s, "leaves": len(_leaves(final))},
            "resume": {"rtol": TRAIN_RESUME_RTOL, "bit_identical_metrics": same,
                       "bit_identical_state": same_state}}


def first_loss(hist: list, want: float, tol: float, what: str) -> None:
    """Every metric finite, and the first loss within ``tol`` of ``want``
    (a random model's: ln V for the LM, ln 2 for the CTR head)."""
    if not all(np.isfinite(h[k]) for h in hist for k in ("loss", "grad_norm", "lr")):
        raise AssertionError(f"train: {what} metrics not finite: {hist}")
    if abs(hist[0]["loss"] - want) > tol:
        raise AssertionError(f"train: {what} first loss {hist[0]['loss']}, not near {want}")


def _leaves(tree):
    from repro_torch import _tree

    return _tree.leaves(tree)


def remat_run(cfg, args) -> dict:
    """TRAIN_REMAT_STEPS steps at ``cfg.remat`` from a fresh state (the
    state alone held before the peak counter is reset): peak memory and
    s/step."""
    import torch

    from repro_torch.launch import train as launch
    from repro_torch.train import train_step as TS

    params, step_fn, batch_fn = launch.make_lm_run(cfg, args)
    state = TS.init_state(params)
    del params
    times = []
    torch.cuda.reset_peak_memory_stats()
    state, hist = launch.train_loop(timed_steps(step_fn, times), batch_fn, state, 0,
                                    TRAIN_REMAT_STEPS, log=lambda line: None)
    out = {"max_memory_allocated": torch.cuda.max_memory_allocated(),
           "s_per_step": steady(times), "step_s": times, "loss": [h["loss"] for h in hist]}
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def card_against_cpu(arch: str, batch: int, seq=None) -> dict:
    """Two steps (the first at lr 0, the WSD warm-up's first value) of a
    REDUCED config on the card and on the CPU from the same parameters
    and batches: loss, grad norm, lr and every leaf of the state."""
    import torch

    from repro_torch import _tree
    from repro_torch.configs import registry
    from repro_torch.launch import train as launch
    from repro_torch.train import train_step as TS

    make = launch.make_lm_run if arch == "smollm-360m" else launch.make_dcn_run
    cfg = registry.get(arch).reduced
    cpu_params, cpu_step, cpu_batch = make(cfg, train_args(arch, 2, batch, "cpu", True, seq))
    _, gpu_step, gpu_batch = make(cfg, train_args(arch, 2, batch, "cuda", True, seq))
    cpu = TS.init_state(cpu_params)
    gpu = TS.init_state(_tree.tree_map(lambda p: p.to("cuda"), cpu_params))
    worst = {"loss": 0.0, "grad_norm": 0.0, "state": 0.0}
    for step in range(2):
        cpu, cm = cpu_step(cpu, cpu_batch(step))
        gpu, gm = gpu_step(gpu, gpu_batch(step))
        for k, rtol in (("loss", TRAIN_LOSS_RTOL), ("grad_norm", TRAIN_STATE_RTOL),
                        ("lr", TRAIN_STATE_RTOL)):
            err = check_close(gm[k].cpu(), cm[k], f"train {arch} step {step} {k}", rtol,
                              rtol * abs(float(cm[k])))
            if k in worst:
                worst[k] = max(worst[k], err / max(abs(float(cm[k])), 1e-30))
        for (path, g), c in zip(_tree.flatten_with_paths(gpu), _tree.leaves(cpu)):
            if c.is_floating_point():
                scale = max(float(c.abs().max()), 1e-30)
                err = check_close(g.cpu(), c, f"train {arch} step {step} {path}",
                                  TRAIN_STATE_RTOL, TRAIN_STATE_RTOL * scale)
                worst["state"] = max(worst["state"], err / scale)
            elif not torch.equal(g.cpu(), c):
                raise AssertionError(f"train {arch} step {step} {path}: {g} != {c}")
    return {"config": cfg.name, "steps": 2, "max_rel_err": worst,
            "loss": [float(cm["loss"]), float(gm["loss"])]}


def attention_saved_bytes(acfg, S: int, device: str = "cuda") -> int:
    """Bytes autograd keeps for the backward of one layer's blockwise
    attention at B 1 x ``S`` in float32 (``saved_tensors_hooks`` over the
    block loop; each saved tensor counted once per save)."""
    import torch

    from repro_torch.models import layers as L

    gen = torch.Generator(device=device).manual_seed(SEED + 41)
    q, k, v = (torch.randn((1, S, h, acfg.d_head), generator=gen, device=device)
               .requires_grad_() for h in (acfg.n_heads, acfg.n_kv_heads, acfg.n_kv_heads))
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        o = L._blockwise_attention(q, k, v, acfg, acfg.d_head ** -0.5, False)
    del o
    return sum(saved)


def long_seq_run(cfg) -> dict:
    """smollm-360m FULL float32 at B 1 x S ``TRAIN_LONG_SEQ``: the blockwise
    attention (S > ``CHUNKED_ATTN_THRESHOLD``), each kv step checkpointed.
    Two steps (the first pays the warm-up), peak bytes, and one layer's
    attention's saved bytes."""
    import torch

    from repro_torch.models import layers as L

    if TRAIN_LONG_SEQ <= L.CHUNKED_ATTN_THRESHOLD:
        raise AssertionError("train: the long step would not reach the blockwise attention")
    out = remat_run(cfg, train_args("smollm-360m", 2, 1, "cuda", seq=TRAIN_LONG_SEQ))
    if not all(np.isfinite(out["loss"])):
        raise AssertionError(f"train: the S {TRAIN_LONG_SEQ} step's loss {out['loss']}")
    out.update(batch=1, seq=TRAIN_LONG_SEQ, tokens_per_s=TRAIN_LONG_SEQ / out["s_per_step"],
               attention_saved_bytes=attention_saved_bytes(cfg.attn_config, TRAIN_LONG_SEQ))
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_train() -> dict:
    """Training on the card through ``repro_torch.launch.train``: the LM and
    recsys runs at full width, the checkpoint resume, remat's memory, and
    the card held to the CPU.  No hand kernel is on this path (the
    reference's trainers reach no Pallas kernel): the phase asserts that
    no kernel launched."""
    import torch

    from repro_torch.configs import dcn_v2, smollm_360m
    from repro_torch.configs.registry import RECSYS_SHAPES
    from repro_torch.launch import train as launch
    from repro_torch.train import train_step as TS

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("train: TF32 is on; training runs in full float32")
    launches = all_launches()
    cfg = smollm_360m.FULL
    out = {"phase": "train", "config": cfg.name, "dtype": "float32",
           "batch": TRAIN_LM_BATCH, "seq": TRAIN_LM_SEQ, "param_count": cfg.param_count()}
    lines = []
    args = train_args("smollm-360m", TRAIN_STEPS, TRAIN_LM_BATCH, "cuda", seq=TRAIN_LM_SEQ)
    out["lm"] = lm_train_run(cfg, args, lines)
    out["lm"]["log"] = lines
    gc.collect()
    torch.cuda.empty_cache()
    remat = {}
    for mode in ("none", "full", "dots"):
        remat[mode] = remat_run(dataclasses.replace(cfg, remat=mode),
                                train_args("smollm-360m", TRAIN_REMAT_STEPS, TRAIN_LM_BATCH,
                                           "cuda", seq=TRAIN_LM_SEQ))
        remat[mode]["tokens_per_s"] = TRAIN_LM_BATCH * TRAIN_LM_SEQ / remat[mode]["s_per_step"]
    if not remat["full"]["max_memory_allocated"] < remat["none"]["max_memory_allocated"]:
        raise AssertionError(f"train: remat full peak {remat['full']['max_memory_allocated']} "
                             f"not below none {remat['none']['max_memory_allocated']}")
    out["remat"] = remat

    dcfg = dcn_v2.FULL
    B = RECSYS_SHAPES["train_batch"]["batch"]
    params, step_fn, batch_fn = launch.make_dcn_run(
        dcfg, train_args("dcn-v2", TRAIN_DCN_STEPS, B, "cuda"))
    state = TS.init_state(params)
    del params
    times = []
    torch.cuda.reset_peak_memory_stats()
    state, hist = launch.train_loop(timed_steps(step_fn, times), batch_fn, state, 0,
                                    TRAIN_DCN_STEPS, log=lambda line: None)
    first_loss(hist, np.log(2.0), 0.1, "dcn-v2")
    table = state.params["embed"]["tables"]
    s = steady(times)
    out["dcn"] = {"config": dcfg.name, "batch": B, "steps": hist, "step_s": times,
                  "s_per_step": s, "samples_per_s": B / s,
                  "table_bytes": table.numel() * table.element_size(),
                  "max_memory_allocated": torch.cuda.max_memory_allocated()}
    del state, table
    gc.collect()
    torch.cuda.empty_cache()

    out["long"] = long_seq_run(cfg)
    out["card_vs_cpu"] = [card_against_cpu("smollm-360m", 4, 64), card_against_cpu("dcn-v2", 64)]
    out["kernel_launches"] = all_launches() - launches
    if out["kernel_launches"]:
        raise AssertionError(f"train: {out['kernel_launches']} hand-kernel launches on a path "
                             "that has none")
    emit(out)
    return out


# moe_serve: per arch, generate's new tokens and the long-context decode
# steps (deepseek-moe "the same way, with fewer steps")
MOE_SERVE = (("qwen3-moe-30b-a3b", 16, 3), ("deepseek-moe-16b", 8, 3))
MOE_PREFILL_S = 2048  # cut from prefill_32k's 32 x 32,768 (the logits alone: 637 GB)
MOE_GEN_B, MOE_CACHE = 8, 4096  # cut from decode_32k's B 128 at 32,768
MOE_CHECK_LAYERS = 2  # the float32 full-width check's depth
# float32 decode through the kernel against the same step without it at
# full width: two float32 orders of the attention sums, then the experts'
# products (as PREFILL_RTOL)
MOE_F32_RTOL = 1e-4
MOE_DENSE_TOKENS = 32  # the no-drop layer held against a per-token top-k
# card against CPU at the REDUCED configs (float32, TF32 off)
MOE_CARD_RTOL = 1e-5


def routed(fn):
    """(fn(), kept pairs, all pairs, each call's dropped share) over every
    ``models.moe.route`` call that ``fn`` makes (the MoE layers' own)."""
    import torch

    from repro_torch.models import moe as M

    calls = []
    orig = M.route

    def counting(params, cfg, xt):
        r = orig(params, cfg, xt)
        calls.append((r.keep.sum(), r.keep.numel()))
        return r

    M.route = counting
    try:
        out = fn()
    finally:
        M.route = orig
    kept = [int(k) for k, _ in calls]
    return out, sum(kept), sum(n for _, n in calls), [1 - k / n for k, (_, n) in zip(kept, calls)]


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def moe_init_on_card(cfg, dtype, gen) -> tuple:
    """``init_params`` on the card, its seconds, and its peak held to one
    copy of the stack plus one layer (and the largest leaf's float32 draw
    and scaled copy)."""
    import torch

    from repro_torch.models import transformer as T

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    params = T.init_params(gen, cfg, dtype=dtype, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() - base
    layer = tree_bytes(T._layer(params["layers"], 0))
    draw = 8 * max(p[0].numel() for p in _leaves(params["layers"]))
    limit = tree_bytes(params) + layer + draw + (64 << 20)
    if peak > limit:
        raise AssertionError(f"init_params {cfg.name}: peak {peak} over the stack, one layer "
                             f"and a draw ({limit})")
    return params, {"s": secs, "param_bytes": tree_bytes(params), "layer_bytes": layer,
                    "peak_bytes": peak, "peak_limit_bytes": limit}


def moe_generate(name: str, params, cfg, max_new: int, gen) -> dict:
    """``generate`` on the kernel in bf16 at B = MOE_GEN_B, prompts of 5-32
    tokens left-padded, on a MOE_CACHE-position cache: ms per step, new
    tokens / s, peak bytes; one TMA launch a layer and step."""
    import torch

    from repro_torch.kernels import flash_decode as fd
    from repro_torch.serve import decode as serve

    lens = torch.randint(5, 33, (MOE_GEN_B,), generator=gen, device="cuda").tolist()
    prompt = serve.pad_requests([torch.randint(1, cfg.vocab, (n,), generator=gen, device="cuda")
                                 for n in lens])
    S0 = prompt.shape[1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fd.reset_launches()
    t = time.perf_counter()
    toks = serve.generate(params, cfg, prompt, max_new, max_len=MOE_CACHE, use_flash_kernel=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    n_steps = S0 + max_new - 1
    launches = fd.LAUNCHES["flash_decode"]
    if launches != n_steps * cfg.n_layers or fd.LAUNCHES["flash_decode_tma"] != launches:
        raise AssertionError(f"{name} generate: {fd.LAUNCHES}, not {n_steps * cfg.n_layers} "
                             "flash launches on the TMA route")
    new = toks[:, S0:]
    if (tuple(toks.shape) != (MOE_GEN_B, S0 + max_new) or not torch.equal(toks[:, :S0], prompt)
            or int(new.min()) < 0 or int(new.max()) >= cfg.vocab):
        raise AssertionError(f"{name} generate: tokens {tuple(toks.shape)} out of shape or range")
    return {"B": MOE_GEN_B, "prompt_lens": lens, "padded_to": S0, "max_new": max_new,
            "max_len": MOE_CACHE, "decode_steps": n_steps, "s": dt,
            "ms_per_step": 1e3 * dt / n_steps, "tokens_per_s": MOE_GEN_B * max_new / dt,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "cache_bytes": 2 * cfg.n_layers * MOE_GEN_B * MOE_CACHE * cfg.n_kv_heads
            * cfg.head_dim * 2, "launches": launches}


def moe_decode_long(name: str, params, cfg, n_steps: int, gen) -> dict:
    """``decode_step`` on the kernel at B = MOE_GEN_B over a MOE_CACHE
    bf16 cache drawn on the card as a prefilled history (lengths in
    [MOE_CACHE / 2, MOE_CACHE - n_steps]): ms per step, the last step
    under the profiler (``step_profile``), launches, and layer 0's kernel
    call at this config's cache shape (``flash_kernel_row``)."""
    import torch

    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models import transformer as T

    cache = T.init_kv_cache(cfg, MOE_GEN_B, MOE_CACHE, dtype=torch.bfloat16, device="cuda")
    for i in range(cfg.n_layers):
        cache["k"][i].normal_(generator=gen)
        cache["v"][i].normal_(generator=gen)
    cache["len"] = torch.randint(MOE_CACHE // 2, MOE_CACHE - n_steps + 1, (MOE_GEN_B,),
                                 generator=gen, device="cuda", dtype=torch.int32)
    tokens = torch.randint(0, cfg.vocab, (n_steps, MOE_GEN_B), generator=gen, device="cuda")
    out = {"B": MOE_GEN_B, "S_max": MOE_CACHE,
           "start_len_min_max": [int(cache["len"].min()), int(cache["len"].max())],
           "step_ms": []}
    fd.reset_launches()
    for i, tok in enumerate(tokens):
        if i == len(tokens) - 1:  # the last step under the profiler
            (logits, cache), out["profiled_step"] = step_profile(
                lambda: T.decode_step(params, cfg, cache, tok, use_flash_kernel=True))
            break
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = T.decode_step(params, cfg, cache, tok, use_flash_kernel=True)
        torch.cuda.synchronize()
        out["step_ms"].append(1e3 * (time.perf_counter() - t))
        if tuple(logits.shape) != (MOE_GEN_B, cfg.vocab) or not bool(logits.isfinite().all()):
            raise AssertionError(f"{name} decode: logits {tuple(logits.shape)} not finite")
    out["launches"] = fd.LAUNCHES["flash_decode"]
    if out["launches"] != n_steps * cfg.n_layers or fd.LAUNCHES["flash_decode_tma"] != \
            out["launches"]:
        raise AssertionError(f"{name} decode: {fd.LAUNCHES}, not {n_steps * cfg.n_layers} "
                             "flash launches on the TMA route")
    out["kernel"] = flash_kernel_row(name, params, cfg, cache, tokens[-1])
    return out


def moe_f32_check(name: str, cfg, gen) -> dict:
    """MOE_CHECK_LAYERS full-width layers in float32: two decode steps
    through the kernel, each against the same step without it from the
    same cache state (rtol MOE_F32_RTOL); then layer 0's MoE block at a
    capacity that drops nothing against a dense per-token top-k compute
    (rtol 1e-5).  A comparison: the kernel's counts are put back."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T

    saved = dict(fd.LAUNCHES)
    check = dataclasses.replace(cfg, n_layers=MOE_CHECK_LAYERS)
    params = T.init_params(gen, check, dtype=torch.float32, device="cuda")
    cache = T.init_kv_cache(check, MOE_GEN_B, MOE_CACHE, dtype=torch.float32, device="cuda")
    cache["k"].normal_(generator=gen)
    cache["v"].normal_(generator=gen)
    cache["len"] = torch.randint(MOE_CACHE // 2, MOE_CACHE - 2, (MOE_GEN_B,), generator=gen,
                                 device="cuda", dtype=torch.int32)
    rows = torch.arange(MOE_GEN_B, device="cuda")
    errs = []
    for step in range(2):
        tok = torch.randint(0, cfg.vocab, (MOE_GEN_B,), generator=gen, device="cuda")
        slot = cache["len"].long()
        pre = (cache["k"][:, rows, slot].clone(), cache["v"][:, rows, slot].clone())
        logits, new = T.decode_step(params, check, cache, tok, use_flash_kernel=True)
        post = (cache["k"][:, rows, slot].clone(), cache["v"][:, rows, slot].clone())
        cache["k"][:, rows, slot], cache["v"][:, rows, slot] = pre
        plain, _ = T.decode_step(params, check, cache, tok, use_flash_kernel=False)
        cache["k"][:, rows, slot], cache["v"][:, rows, slot] = post
        errs.append(check_close(logits, plain, f"{name} float32 step {step}", MOE_F32_RTOL,
                                MOE_F32_RTOL * float(plain.abs().max())))
        cache = new
    # the no-drop layer: capacity_factor E / k gives every expert T slots
    m = dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k)
    nd = dataclasses.replace(check, moe=m)
    mp = T._layer(params["layers"], 0)["mlp"]
    x = torch.randn((1, MOE_DENSE_TOKENS, cfg.d_model), generator=gen, device="cuda")
    got = M.moe_apply(mp, nd, x)[0]
    r = M.route(mp, nd, x[0])
    if not bool(r.keep.all()):
        raise AssertionError(f"{name}: a pair dropped at capacity {r.capacity}")
    want = torch.zeros_like(x[0])
    for j in range(cfg.moe.top_k):  # token t's j-th expert, as one batched product
        e = r.top_e[:, j]
        h = torch.bmm(x[0][:, None], mp["w_gate"][e])
        u = torch.bmm(x[0][:, None], mp["w_up"][e])
        want += r.top_p[:, j, None] * torch.bmm(F.silu(h) * u, mp["w_down"][e])[:, 0]
    if "shared" in mp:
        want += L.swiglu(mp["shared"], x[0])
    dense_err = check_close(got, want, f"{name} no-drop MoE layer vs dense top-k", 1e-5,
                            1e-5 * float(want.abs().max()))
    fd.LAUNCHES.update(saved)
    return {"layers": MOE_CHECK_LAYERS, "dtype": "float32", "rtol": MOE_F32_RTOL,
            "flash_vs_plain_max_abs_err": errs,
            "no_drop": {"tokens": MOE_DENSE_TOKENS, "capacity": r.capacity,
                        "vs_dense_topk_max_abs_err": dense_err}}


def moe_card_vs_cpu(arch: str) -> dict:
    """The REDUCED config on the card and on the CPU from the same float32
    parameters: ``route`` exactly equal and ``moe_apply`` within
    MOE_CARD_RTOL on 256 tokens at capacity 1.25 (the pairs it drops
    reported), then three
    ``decode_step``s, the card's through the kernel (launches put back),
    the CPU's on the plain version."""
    import torch

    from repro_torch import _tree
    from repro_torch.configs import registry
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T

    saved = dict(fd.LAUNCHES)
    cfg = registry.get(arch).reduced
    cpu = T.init_params(torch.Generator().manual_seed(SEED + 31), cfg, dtype=torch.float32,
                        device="cpu")
    gpu = _tree.tree_map(lambda p: p.to("cuda"), cpu)
    x = torch.randn((16, 16, cfg.d_model), generator=torch.Generator().manual_seed(SEED + 32))
    mp_c, mp_g = T._layer(cpu["layers"], 0)["mlp"], T._layer(gpu["layers"], 0)["mlp"]
    rc, rg = M.route(mp_c, cfg, x.reshape(-1, cfg.d_model)), \
        M.route(mp_g, cfg, x.reshape(-1, cfg.d_model).to("cuda"))
    for f in ("top_e", "order", "keep", "src_tok"):
        if not torch.equal(getattr(rg, f).cpu(), getattr(rc, f)):
            raise AssertionError(f"{arch} REDUCED: route {f} differs between card and CPU")
    if not torch.equal(rg.slot.cpu()[rc.keep], rc.slot[rc.keep]):
        raise AssertionError(f"{arch} REDUCED: route slots differ between card and CPU")
    want = M.moe_apply(mp_c, cfg, x)
    moe_err = check_close(M.moe_apply(mp_g, cfg, x.to("cuda")).cpu(), want, f"{arch} moe_apply",
                          MOE_CARD_RTOL, MOE_CARD_RTOL * float(want.abs().max()))
    errs = []
    runs = []  # (params, cache): the CPU's, then the card's
    for dev, p in (("cpu", cpu), ("cuda", gpu)):
        c = T.init_kv_cache(cfg, 3, 40, dtype=torch.float32, device=dev)
        c["len"] = torch.tensor([0, 17, 39], dtype=torch.int32, device=dev)
        runs.append((p, c))
    for t in range(3):
        tok = torch.tensor([t, 2 * t + 1, 3 * t + 2])
        lc, runs[0] = _decode_on(runs[0], cfg, tok)
        lg, runs[1] = _decode_on(runs[1], cfg, tok.to("cuda"))
        errs.append(check_close(lg.cpu(), lc, f"{arch} REDUCED decode step {t}", MOE_CARD_RTOL,
                                MOE_CARD_RTOL * float(lc.abs().max())))
    fd.LAUNCHES.update(saved)
    return {"config": cfg.name, "dropped_pairs": int((~rc.keep).sum()),
            "moe_apply_max_abs_err": moe_err, "decode_max_abs_err": errs}


def _decode_on(pc, cfg, tok):
    from repro_torch.models import transformer as T

    params, cache = pc
    logits, cache = T.decode_step(params, cfg, cache, tok, use_flash_kernel=True)
    return logits, (params, cache)


def phase_moe_serve(smi: str) -> dict:
    """The MoE LMs served at full width and depth in bf16 (``MOE_SERVE``):
    parameters initialised on the card, ``make_prefill`` at B = 1, S =
    MOE_PREFILL_S with the share of (token, slot) pairs dropped at
    capacity 1.25, ``generate`` on the kernel, long-context decode steps
    with row 12 held to its plain version at the config's cache shape;
    then each config's float32 check at MOE_CHECK_LAYERS layers and the
    REDUCED configs on the card against the CPU."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models import moe as M
    from repro_torch.serve import decode as serve

    out = {"phase": "moe_serve", "card": smi, "archs": {},
           "allocated_at_start": torch.cuda.memory_allocated()}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    launches = 0
    for arch, max_new, long_steps in MOE_SERVE:
        cfg = registry.get(arch).full
        res = {"config": cfg.name, "dtype": "bfloat16", "n_layers": cfg.n_layers,
               "param_count": cfg.param_count(), "active_param_count": cfg.active_param_count()}
        params, res["init"] = moe_init_on_card(cfg, torch.bfloat16, gen)
        prompt = torch.randint(0, cfg.vocab, (1, MOE_PREFILL_S), generator=gen, device="cuda")
        prefill_s = []
        for _ in range(2):  # the first call pays the CUDA and cuBLAS warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fd.reset_launches()
            t = time.perf_counter()
            logits, kept, pairs, shares = routed(lambda: serve.make_prefill(cfg)(params, prompt))
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t)
        if (tuple(logits.shape) != (1, cfg.vocab) or not bool(logits.isfinite().all())
                or len(shares) != cfg.n_layers or fd.LAUNCHES["flash_decode"]):
            raise AssertionError(f"{arch} prefill: logits {tuple(logits.shape)}, {len(shares)} "
                                 f"MoE layers, {fd.LAUNCHES['flash_decode']} flash launches")
        res["prefill"] = {"B": 1, "S": MOE_PREFILL_S, "first_s": prefill_s[0], "s": prefill_s[1],
                          "tokens_per_s": MOE_PREFILL_S / prefill_s[1],
                          "peak_bytes": torch.cuda.max_memory_allocated(),
                          "capacity": M._capacity(MOE_PREFILL_S, cfg.moe),
                          "capacity_factor": cfg.moe.capacity_factor, "pairs": pairs,
                          "dropped": pairs - kept, "dropped_share": (pairs - kept) / pairs,
                          "dropped_share_by_layer": shares}
        del logits
        res["generate"] = moe_generate(arch, params, cfg, max_new, gen)
        res["decode_long"] = moe_decode_long(arch, params, cfg, long_steps, gen)
        launches += res["generate"]["launches"] + res["decode_long"]["launches"]
        del params
        gc.collect()
        torch.cuda.empty_cache()
        res["float32_check"] = moe_f32_check(arch, cfg, gen)
        gc.collect()
        torch.cuda.empty_cache()
        res["card_vs_cpu"] = moe_card_vs_cpu(arch)
        out["archs"][arch] = res
    out["launches"] = launches
    emit(out)
    return out


GNN_SCHNET_STEPS = 6
GNN_GC_TRAIN_STEPS = 3
GNN_GC_TRAIN_REFINEMENT = 5  # cut from 6: no remat in the reference, ~118 GB of activations


def gnn_steps(step_fn, state, batch_fn, n: int) -> tuple:
    """``n`` timed steps; (state, history of float metrics, step seconds)."""
    times, hist = [], []
    step = timed_steps(step_fn, times)
    for i in range(n):
        state, m = step(state, batch_fn(i))
        hist.append({k: float(v) for k, v in m.items()})
    if not all(np.isfinite(h[k]) for h in hist for k in h):
        raise AssertionError(f"gnn_molecule: metrics not finite: {hist}")
    return state, hist, times


def molecule_graph(mb, device):
    """A ``molecule_batch`` as a GraphBatch with distances and graph ids."""
    import torch

    from repro_torch.models.gnn import common

    edges = np.stack([mb["src"], mb["dst"]], 1)
    g = common.batch_from_edges(mb["x"].shape[0], edges, mb["x"], edge_attr=mb["dist"][:, None],
                                device=device)
    return g._replace(graph_ids=torch.from_numpy(mb["graph_ids"]).to(device))


def gnn_card_vs_cpu(name: str, params, loss, batch_fn) -> dict:
    """Two steps of a REDUCED model on the card and on the CPU from the same
    parameters and batches (``batch_fn(step, device)``): loss, grad norm
    and every leaf of the state (TRAIN_LOSS_RTOL, TRAIN_STATE_RTOL)."""
    from repro_torch import _tree
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as TS

    step_fn = TS.make_train_step(loss, adamw.wsd_schedule(1, 10, 2, 3e-3))
    cpu = TS.init_state(params)
    gpu = TS.init_state(_tree.tree_map(lambda p: p.to("cuda"), params))
    worst = 0.0
    for step in range(2):
        cpu, cm = step_fn(cpu, batch_fn(step, "cpu"))
        gpu, gm = step_fn(gpu, batch_fn(step, "cuda"))
        check_close(gm["loss"].cpu(), cm["loss"], f"{name} step {step} loss", TRAIN_LOSS_RTOL,
                    TRAIN_LOSS_RTOL * abs(float(cm["loss"])))
        check_close(gm["grad_norm"].cpu(), cm["grad_norm"], f"{name} step {step} grad norm",
                    TRAIN_STATE_RTOL, TRAIN_STATE_RTOL * abs(float(cm["grad_norm"])))
        for (path, g), c in zip(_tree.flatten_with_paths(gpu), _tree.leaves(cpu)):
            if c.is_floating_point():
                scale = max(float(c.abs().max()), 1e-30)
                worst = max(worst, check_close(g.cpu(), c, f"{name} step {step} {path}",
                                               TRAIN_STATE_RTOL, TRAIN_STATE_RTOL * scale) / scale)
    return {"steps": 2, "state_max_rel_err": worst}


def phase_gnn_molecule(smi: str) -> dict:
    """SchNet FULL training steps on the ``molecule`` shape, GraphCast FULL's
    forward on its refinement-6 multimesh and its training steps at full
    width and depth on refinement GNN_GC_TRAIN_REFINEMENT, and both REDUCED
    models on the card against the CPU.  No hand kernel is on this path
    (the reference's ``aggregate`` is ``segment_sum``, here ``index_add_``):
    the phase asserts that none launched."""
    import torch

    from repro_torch.configs import graphcast as gc_cfg
    from repro_torch.configs import schnet as sch_cfg
    from repro_torch.configs.registry import GNN_SHAPES
    from repro_torch.data.pipeline import molecule_batch
    from repro_torch.models.gnn import common
    from repro_torch.models.gnn import graphcast as gcast
    from repro_torch.models.gnn import schnet
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as TS

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("gnn_molecule: TF32 is on; the models run in full float32")
    launches = all_launches()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    out = {"phase": "gnn_molecule", "card": smi, "dtype": "float32"}

    shape = GNN_SHAPES["molecule"]
    B, atoms, edges, d_feat = shape["batch"], shape["n_nodes"], shape["n_edges"], shape["d_feat"]
    cfg = sch_cfg.FULL
    params = schnet.init(gen, d_feat, cfg.d_hidden, cfg.n_layers, cfg.n_rbf, cfg.n_classes,
                         device="cuda")

    def mol_batch(step, device="cuda"):
        mb = molecule_batch(SEED, step, B, atoms, edges, d_feat)
        return {"graph": molecule_graph(mb, device),
                "targets": torch.from_numpy(mb["targets"]).to(device)}

    torch.cuda.reset_peak_memory_stats()
    step_fn = TS.make_train_step(TS.schnet_loss(B), adamw.wsd_schedule(1, 100, 10, 1e-3))
    _, hist, times = gnn_steps(step_fn, TS.init_state(params), mol_batch, GNN_SCHNET_STEPS)
    s = steady(times)
    out["schnet"] = {"config": cfg.name, "molecules": B, "atoms": B * atoms, "edges": B * edges,
                     "steps": hist, "step_s": times, "s_per_step": s,
                     "molecules_per_s": B / s, "peak_bytes": torch.cuda.max_memory_allocated()}

    gcfg = gc_cfg.FULL
    t = time.perf_counter()
    mesh = gcast.build_multimesh(gcfg.mesh_refinement)
    mesh_s = time.perf_counter() - t
    n = int(mesh.max()) + 1
    x = torch.randn((n, gcfg.n_vars), generator=gen, device="cuda")
    graph = common.batch_from_edges(n, mesh, x.cpu().numpy(), device="cuda")
    gparams = gcast.init(gen, gcfg.n_vars, gcfg.d_hidden, gcfg.n_layers, gcfg.n_classes,
                         device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fwd_s = []
    with torch.no_grad():
        for _ in range(2):  # the first pays cuBLAS's warm-up
            t = time.perf_counter()
            pred = gcast.forward(gparams, graph)
            torch.cuda.synchronize()
            fwd_s.append(time.perf_counter() - t)
    if tuple(pred.shape) != (n, gcfg.n_classes) or not bool(pred.isfinite().all()):
        raise AssertionError(f"graphcast forward: {tuple(pred.shape)} not finite")
    out["graphcast_forward"] = {"config": gcfg.name, "refinement": gcfg.mesh_refinement,
                                "nodes": n, "edges": int(mesh.shape[0]), "mesh_build_s": mesh_s,
                                "forward_s": fwd_s, "ms": 1e3 * fwd_s[-1],
                                "peak_bytes": torch.cuda.max_memory_allocated()}
    del pred, graph, x
    gc.collect()
    torch.cuda.empty_cache()

    mesh = gcast.build_multimesh(GNN_GC_TRAIN_REFINEMENT)
    n = int(mesh.max()) + 1
    x = torch.randn((n, gcfg.n_vars), generator=gen, device="cuda")
    graph = common.batch_from_edges(n, mesh, x.cpu().numpy(), device="cuda")

    def gc_batch(step, device="cuda"):
        g = torch.Generator(device="cuda").manual_seed(SEED + 50 + step)
        return {"graph": graph, "targets": torch.randn((n, gcfg.n_classes), generator=g,
                                                       device="cuda")}

    torch.cuda.reset_peak_memory_stats()
    step_fn = TS.make_train_step(TS.graphcast_loss(), adamw.wsd_schedule(1, 100, 10, 1e-3))
    _, hist, times = gnn_steps(step_fn, TS.init_state(gparams), gc_batch, GNN_GC_TRAIN_STEPS)
    out["graphcast_train"] = {"config": gcfg.name, "refinement": GNN_GC_TRAIN_REFINEMENT,
                              "nodes": n, "edges": int(mesh.shape[0]), "steps": hist,
                              "step_s": times, "s_per_step": steady(times),
                              "peak_bytes": torch.cuda.max_memory_allocated()}
    del gparams, graph, x
    gc.collect()
    torch.cuda.empty_cache()

    rs = sch_cfg.REDUCED
    cpu_gen = torch.Generator().manual_seed(SEED + 41)
    sp = schnet.init(cpu_gen, d_feat, rs.d_hidden, rs.n_layers, rs.n_rbf, rs.n_classes,
                     device="cpu")
    small = 8

    def small_mols(step, device):
        mb = molecule_batch(SEED + 1, step, small, atoms, edges, d_feat)
        return {"graph": molecule_graph(mb, device),
                "targets": torch.from_numpy(mb["targets"]).to(device)}

    rg = gc_cfg.REDUCED
    mesh = gcast.build_multimesh(rg.mesh_refinement)
    n = int(mesh.max()) + 1
    xr = np.random.default_rng(SEED + 42).standard_normal((n, rg.n_vars)).astype(np.float32)
    gp = gcast.init(cpu_gen, rg.n_vars, rg.d_hidden, rg.n_layers, rg.n_classes, device="cpu")

    def small_mesh(step, device):
        t = np.random.default_rng(SEED + 60 + step).standard_normal((n, rg.n_classes))
        return {"graph": common.batch_from_edges(n, mesh, xr, device=device),
                "targets": torch.from_numpy(t.astype(np.float32)).to(device)}

    out["card_vs_cpu"] = {"schnet": gnn_card_vs_cpu("schnet REDUCED", sp, TS.schnet_loss(small),
                                                    small_mols),
                          "graphcast": gnn_card_vs_cpu("graphcast REDUCED", gp,
                                                       TS.graphcast_loss(), small_mesh)}
    out["kernel_launches"] = all_launches() - launches
    if out["kernel_launches"]:
        raise AssertionError(f"gnn_molecule: {out['kernel_launches']} hand-kernel launches on a "
                             "path that has none")
    emit(out)
    return out


# train_gnn: graphsage-reddit FULL through launch.train_gnn's loop on the
# gnn_sampled phase's card graph
TRAIN_GNN_STEPS = 40
TRAIN_GNN_STREAM_EVERY = 10
TRAIN_GNN_CKPT_EVERY = 20
TRAIN_GNN_REDUCED_STEPS = 3
# card against CPU at the REDUCED config (float32, TF32 off)
TRAIN_GNN_RTOL = 1e-4


def train_gnn_args(steps: int, device: str, ckpt_dir: str = "", **kw) -> object:
    from repro_torch.launch import train_gnn

    argv = ["--steps", str(steps), "--device", device, "--ckpt-dir", ckpt_dir]
    for k, v in kw.items():
        argv += [f"--{k.replace('_', '-')}"] + [str(x) for x in np.atleast_1d(v)]
    return train_gnn.parser().parse_args(argv)


def train_gnn_card_vs_cpu() -> dict:
    """REDUCED graphsage-reddit for 3 steps through ``train_gnn.train`` on
    the card and on the CPU from the same parameters: the loss and grad
    norm at each step and every parameter after."""
    import torch

    from repro_torch import _tree
    from repro_torch.configs import graphsage_reddit
    from repro_torch.launch import train_gnn
    from repro_torch.models.gnn import graphsage

    cfg = graphsage_reddit.REDUCED
    kw = dict(batch=64, n=4096, m=40_000, d_feat=32, d_hidden=cfg.d_hidden,
              classes=cfg.n_classes, fanout=list(cfg.sample_sizes), stream_every=2)
    params = graphsage.init(torch.Generator().manual_seed(SEED), 32, cfg.d_hidden,
                            cfg.n_classes, device="cpu")
    quiet = lambda line: None  # noqa: E731
    cpu = train_gnn.train(train_gnn_args(TRAIN_GNN_REDUCED_STEPS, "cpu", **kw), params=params,
                          log=quiet)
    gpu = train_gnn.train(train_gnn_args(TRAIN_GNN_REDUCED_STEPS, "cuda", **kw),
                          params=_tree.tree_map(lambda p: p.to("cuda"), params), log=quiet)
    worst = 0.0
    for c, g in zip(cpu["history"], gpu["history"]):
        for k in ("loss", "grad_norm"):
            err = abs(g[k] - c[k]) / max(abs(c[k]), 1e-30)
            if err > TRAIN_GNN_RTOL:
                raise AssertionError(f"train_gnn card vs cpu step {c['step']} {k}: "
                                     f"{g[k]} against {c[k]}")
            worst = max(worst, err)
    for g, c in zip(_tree.leaves(gpu["state"].params), _tree.leaves(cpu["state"].params)):
        scale = max(float(c.abs().max()), 1e-30)
        worst = max(worst, check_close(g.cpu(), c, "train_gnn card vs cpu params",
                                       TRAIN_GNN_RTOL, TRAIN_GNN_RTOL * scale) / scale)
    return {"config": cfg.name, "steps": TRAIN_GNN_REDUCED_STEPS, "max_rel_err": worst,
            "loss": [[h["loss"] for h in cpu["history"]], [h["loss"] for h in gpu["history"]]]}


def phase_train_gnn(g, feats) -> dict:
    """graphsage-reddit FULL trained through ``launch.train_gnn``'s loop on
    the gnn_sampled phase's card graph (~114.6 M edges, 232,965 vertices,
    602 features): B = 1024 at fanout (15, 10), 512 edges streamed in
    every 10 steps, 40 steps with ``ResumableRun`` checkpoints after
    steps 20 and 40; the step-40 checkpoint removed (a run killed after
    step 20's), a fresh restore re-runs steps 21-40 and must equal the
    uninterrupted run bit for bit.  Labels are ``argmax(feats @ w)`` for a
    drawn w, as in the trainer.  Then 3 REDUCED steps on the card against
    the CPU.  No kernel runs here (``use_kernel=False`` in training and
    evaluation, as in the reference)."""
    import torch

    from repro_torch import _tree
    from repro_torch.configs import graphsage_reddit
    from repro_torch.configs.registry import GNN_SHAPES
    from repro_torch.launch import train_gnn
    from repro_torch.models.gnn import graphsage

    cfg, shape = graphsage_reddit.FULL, GNN_SHAPES["minibatch_lg"]
    n, B, d = shape["n_nodes"], shape["batch_nodes"], shape["d_feat"]
    launches = all_launches()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 25)
    labels = (feats @ torch.randn((d, cfg.n_classes), generator=gen, device="cuda")).argmax(1)
    params = graphsage.init(gen, d, cfg.d_hidden, cfg.n_classes, device="cuda")
    ckpt = ROOT / "build" / "train_gnn_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    args = train_gnn_args(TRAIN_GNN_STEPS, "cuda", str(ckpt), batch=B, n=n, d_feat=d,
                          d_hidden=cfg.d_hidden, classes=cfg.n_classes,
                          fanout=list(shape["fanout"]), stream_every=TRAIN_GNN_STREAM_EVERY,
                          ckpt_every=TRAIN_GNN_CKPT_EVERY)

    def data():  # the start graph, the trainer's insert generator afresh
        return (train_gnn.StreamingGraph(g, feats, np.random.default_rng(SEED + 25), n,
                                         TRAIN_GNN_STREAM_EVERY), labels)

    lines = []
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    whole = train_gnn.train(args, params=params, log=lines.append, data=data())
    whole_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    saved = sorted(p.name for p in ckpt.iterdir())
    if saved != ["step_000000020", "step_000000040"]:
        raise AssertionError(f"train_gnn: checkpoints {saved}")
    shutil.rmtree(ckpt / "step_000000040")
    t = time.perf_counter()
    resumed = train_gnn.train(args, params=params, log=lines.append, data=data())
    resume_s = time.perf_counter() - t
    if resumed["start"] != TRAIN_GNN_CKPT_EVERY:
        raise AssertionError(f"train_gnn: resumed at {resumed['start']}")
    for r, w in zip(resumed["history"], whole["history"][TRAIN_GNN_CKPT_EVERY:]):
        if (r["step"], r["loss"], r["grad_norm"]) != (w["step"], w["loss"], w["grad_norm"]):
            raise AssertionError(f"train_gnn: resumed step {r} differs from {w}")
    for (path, a), b in zip(_tree.flatten_with_paths(resumed["state"]),
                            _tree.leaves(whole["state"])):
        if not torch.equal(a, b):
            raise AssertionError(f"train_gnn: resumed state {path} differs")
    if not torch.equal(resumed["stream"].graph.keys, whole["stream"].graph.keys):
        raise AssertionError("train_gnn: the resumed run's graph differs")
    losses = [h["loss"] for h in whole["history"]]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train_gnn: losses {losses[0]} -> {losses[-1]}")
    steps_s = [h["s"] for h in whole["history"]]
    s = statistics.median(steps_s[1:])
    out = {
        "phase": "train_gnn", "config": cfg.name, "shape": "minibatch_lg", "n": n,
        "m_start": int(g.m), "m_end": int(whole["stream"].graph.m), "B": B,
        "fanout": list(shape["fanout"]), "steps": TRAIN_GNN_STEPS,
        "stream_every": TRAIN_GNN_STREAM_EVERY, "first_step_s": steps_s[0],
        "s_per_step": s, "seeds_per_s": B / s, "step_s": steps_s, "whole_run_s": whole_s,
        "resumed_steps": len(resumed["history"]), "resume_run_s": resume_s,
        "sampler_rebuilds": whole["stream"].rebuilds, "loss_first": losses[0],
        "loss_last": losses[-1], "final_acc": whole["acc"], "chance": 1 / cfg.n_classes,
        "peak_bytes": peak, "allocated_at_start_bytes": base, "log": lines,
    }
    out["card_vs_cpu"] = train_gnn_card_vs_cpu()
    out["kernel_launches"] = all_launches() - launches
    if out["kernel_launches"]:
        raise AssertionError(f"train_gnn: {out['kernel_launches']} hand-kernel launches on a "
                             "path that has none")
    shutil.rmtree(ckpt, ignore_errors=True)
    emit(out)
    return out


# dryrun: the reference's tests/test_cells.py REPRESENTATIVE cells on the
# 16x16 fake mesh, and three cells that fit one card run there
DRYRUN_CELLS = (
    ("smollm-360m", "train_4k"), ("qwen3-moe-30b-a3b", "decode_32k"),
    ("gcn-cora", "full_graph_sm"), ("graphsage-reddit", "minibatch_lg"),
    ("schnet", "molecule"), ("graphcast", "molecule"), ("dcn-v2", "serve_p99"),
    ("dcn-v2", "retrieval_cand"), ("aspen-stream", "update_2m"),
)
DRYRUN_CARD_CELLS = (("gcn-cora", "full_graph_sm"), ("dcn-v2", "serve_p99"),
                     ("schnet", "molecule"))
DRYRUN_KEYS = ("arch", "shape", "mesh", "n_chips", "ok", "build_s", "run_s", "flops_per_dev",
               "bytes_per_dev", "collective_bytes_per_dev", "collective_kinds",
               "collective_links", "resharded_views", "masked_local_ops", "compute_s_term",
               "memory_s_term",
               "collective_s_term", "dominant", "model_flops", "useful_compute_frac",
               "mem_argument_bytes", "mem_model", "fits")


def _int_high(path: str, cell, arch: str) -> int:
    """The exclusive upper bound of an integer argument's draws."""
    from repro_torch.configs import registry

    cfg = registry.get(arch).full
    if path.endswith((".src", ".dst")):
        return cell.meta["n_nodes"]
    if path.endswith(".graph_ids"):
        return max(registry.GNN_SHAPES["molecule"]["batch"], 1)
    if path.endswith("['labels']"):
        return cfg.n_classes
    if path.endswith("['sparse_ids']") or path == "[2]":
        return cfg.vocab_per_field
    raise AssertionError(f"dryrun: no range for the integer argument {path}")


def card_args(cell, arch: str, gen):
    """The cell's meta arguments drawn on the card from ``gen``: float
    parameters and features N(0, 0.05^2), distances in [0, 10), optimizer
    moments and step 0, masks all true, ids in range."""
    import torch

    from repro_torch import _tree

    flat = _tree.flatten_with_paths(cell.args)
    out = []
    for path, t in flat:
        if ".opt/" in path or path.endswith(".step"):
            x = torch.zeros(t.shape, dtype=t.dtype, device="cuda")
        elif t.dtype == torch.bool:
            x = torch.ones(t.shape, dtype=torch.bool, device="cuda")
        elif t.is_floating_point():
            x = torch.randn(t.shape, generator=gen, device="cuda", dtype=t.dtype) * 0.05
            if path.endswith(".edge_attr"):
                x = torch.rand(t.shape, generator=gen, device="cuda") * 10.0
        else:
            high = _int_high(path, cell, arch)
            if path.endswith(".graph_ids"):  # atoms of one molecule together
                x = (torch.arange(t.shape[0], device="cuda") * high // t.shape[0]).to(t.dtype)
            else:
                x = torch.randint(0, high, t.shape, generator=gen, device="cuda",
                                  dtype=t.dtype)
        out.append(x)
    return _tree.unflatten(cell.args, out)


DRYRUN_OUT = ROOT / "build" / "dryrun_cells.jsonl"


def dryrun_cells(path: str) -> int:
    """``chip_smoke.py --dryrun-cells PATH``: the dry run of
    ``DRYRUN_CELLS``, one JSON line per cell to ``PATH``.  Host work only
    (meta tensors on a ``fake`` process group of 256 ranks); the main run
    starts it in a process of its own, beside the card's phases."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.launch import dryrun

    torch.set_num_threads(2)
    with open(path, "w") as f:
        for arch, shape in DRYRUN_CELLS:
            t = time.perf_counter()
            res = dryrun.run_cell(arch, shape, False)
            line = {k: res[k] for k in DRYRUN_KEYS}
            line["wall_s"] = time.perf_counter() - t
            f.write(json.dumps(line) + "\n")
            f.flush()
    return 0


def start_dryrun_cells() -> subprocess.Popen:
    """``dryrun_cells`` in a child process that cannot see the card,
    stopped when this process exits."""
    DRYRUN_OUT.parent.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    err = open(str(DRYRUN_OUT) + ".err", "w")
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--dryrun-cells",
                             str(DRYRUN_OUT)], env=env, stdout=subprocess.DEVNULL, stderr=err)
    err.close()
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def phase_dryrun(smi: str, proc: subprocess.Popen) -> dict:
    """The port's dry run (``launch.dryrun``): the reference's nine
    representative cells at full width on the 16x16 fake mesh (a ``fake``
    process group of 256 ranks, meta tensors, nothing allocated), one line
    per cell, from the child process ``proc`` started after the build;
    then three cells that fit one card (gcn-cora full_graph_sm, dcn-v2
    serve_p99, schnet molecule) run on it at 1x1 with arguments drawn from
    the seed, their measured time and peak memory beside the 1x1 dry run's
    FLOPs, bytes, roofline terms and memory model.  No kernel runs here."""
    import types

    import torch

    from repro_torch import _tree
    from repro_torch.launch import cells, dryrun

    launches = all_launches()
    out = {"phase": "dryrun", "card": smi, "cells": [], "card_cells": []}
    t = time.perf_counter()
    rc = proc.wait(timeout=600)
    out["wait_s"] = time.perf_counter() - t
    if rc != 0:
        err = Path(str(DRYRUN_OUT) + ".err").read_text()[-3000:]
        raise AssertionError(f"dryrun: the cells' process exited {rc}:\n{err}")
    for text in DRYRUN_OUT.read_text().splitlines():
        line = json.loads(text)
        if not (line["ok"] and line["flops_per_dev"] >= 0 and line["bytes_per_dev"] > 0):
            raise AssertionError(f"dryrun {line['arch']}/{line['shape']}: {line}")
        out["cells"].append(line)
        emit({"phase": "dryrun_cell", **line})
    if len(out["cells"]) != len(DRYRUN_CELLS):
        raise AssertionError(f"dryrun: {len(out['cells'])} of {len(DRYRUN_CELLS)} cells")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 26)
    host = types.SimpleNamespace(shape={"data": 1, "model": 1})
    for arch, shape in DRYRUN_CARD_CELLS:
        dry = dryrun.run_cell(arch, shape, False, host=True)
        cell = cells.build_cell(arch, shape, host)
        args = card_args(cell, arch, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        res = cell.step_fn(*args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        for leaf in _tree.leaves(res):
            if leaf.is_floating_point() and not bool(leaf.isfinite().all()):
                raise AssertionError(f"dryrun card {arch}/{shape}: a non-finite output")
        ms = time_ms(lambda: cell.step_fn(*args), reps=10)
        terms = {k: dry[k] for k in ("compute_s_term", "memory_s_term", "collective_s_term")}
        line = {"arch": arch, "shape": shape, "mesh": "1x1", "ms": ms,
                "max_memory_allocated": peak, "allocated_before": base,
                "mem_argument_bytes": dry["mem_argument_bytes"], "mem_model": dry["mem_model"],
                "flops": dry["flops_per_dev"], "bytes": dry["bytes_per_dev"], **terms,
                "dominant": dry["dominant"], "roofline_ms": 1e3 * max(terms.values()),
                "model_flops": dry["model_flops"]}
        out["card_cells"].append(line)
        emit({"phase": "dryrun_card", **line})
        del args, res
        gc.collect()
        torch.cuda.empty_cache()
    out["kernel_launches"] = all_launches() - launches
    if out["kernel_launches"]:
        raise AssertionError(f"dryrun: {out['kernel_launches']} hand-kernel launches")
    emit({"phase": "dryrun", "cells": len(out["cells"]), "card_cells": len(out["card_cells"]),
          "kernel_launches": out["kernel_launches"]})
    return out


def sharded_row(cases, name: str) -> dict | None:
    """A kernel row's numbers at the sharded path's default launch shape
    (per shard, D = 1)."""
    c = next((c for c in cases if c["name"] == name and c.get("D", 1) == 1
              and c.get("shape", "per_shard") == "per_shard"), None)
    if c is None:
        return None
    return {k: c[k] for k in ("ms", "pipelined_ms", "plain_ms", "bound_ms", "library_ms",
                              "max_abs_err", "same_bits") if k in c}


def tile_fields(cases, name: str, shape: str | None = None) -> dict:
    """A kernel row's tile at its D = 1 case (``shape``: that launch shape
    only): the winner, every candidate's ms, the ms at the old fixed tile."""
    c = next((c for c in cases if c["name"] == name and c.get("D", 1) == 1
              and c.get("tune") and (shape is None or c.get("shape") == shape)), None)
    if c is None:
        return {}
    t = c["tune"]
    return {"tile": t["tile"], "tile_ms": t["candidates_ms"], "old_tile_ms": t["old_tile_ms"]}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--dryrun-cells":
        return dryrun_cells(sys.argv[2])
    if len(sys.argv) == 4 and sys.argv[1] == "--rank-job":
        return rank_job(sys.argv[2], int(sys.argv[3]))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repo (src/repro_torch missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    # the autotuner's disk table: swept anew in each run (the file is
    # removed first), written for later processes, printed at the end
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(TUNE_TABLE)
    TUNE_TABLE.unlink(missing_ok=True)
    # float32 products in full float32 (the default, set here explicitly):
    # the plain versions and the float32 model comparisons depend on it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    seconds = {}  # wall time of each phase, host clock
    tuning = {}  # each phase's cold consults, sweeps and sweep seconds
    # this process's peak bytes on the card in each phase (from the phase's
    # start, or from its own last reset of the counter)
    peaks = {}

    def run(name, fn, *args):
        t, before = time.perf_counter(), tune_totals()
        torch.cuda.reset_peak_memory_stats()
        res = fn(*args)
        seconds[name] = time.perf_counter() - t
        peaks[name] = torch.cuda.max_memory_allocated()
        tuning[name] = tune_since(before)
        return res

    t_start = time.perf_counter()
    run("env", phase_env, smi)
    dry_proc = start_dryrun_cells()  # host work, beside the card's phases
    run("kernels", phase_kernels)
    run("decode_kernels", phase_decode_kernels)
    stream_launches, plain_stream = run("stream", phase_stream)
    host_launches = run("host_decode", phase_host_decode, plain_stream)
    g, aux, scale_launches = run("scale", phase_scale)
    cases = run("scale_kernels", phase_scale_kernels, g, aux)
    padded = run("scale_decode", phase_scale_decode, g)
    sh_launches, sh_cases = run("sharded_scale", phase_sharded_scale, g, aux)
    plain_raises = plain_scale_graph_raises(g)
    del g, aux  # the 2^22 flat scale graph leaves the card here
    gc.collect()
    torch.cuda.empty_cache()
    run("compressed_kernels", phase_compressed_kernels)
    cstream_launches = run("compressed_stream", phase_compressed_stream, plain_stream)
    serve_launches = run("graph_serve", phase_graph_serve, plain_stream)
    sh_stream = run("sharded_stream", phase_sharded_stream, plain_stream)
    del plain_stream
    gc.collect()
    torch.cuda.empty_cache()
    t_ranks, rank_procs = time.perf_counter(), start_rank_jobs()
    rank_res = run("ranks", phase_ranks, rank_procs, t_ranks)
    run("ranks_serve", phase_ranks_serve, rank_res)
    run("moe_shardmap", phase_moe_shardmap, rank_procs, t_ranks)
    # the training children start once the stream, engine and MoE children end
    t_train, train_procs = time.perf_counter(), start_rank_jobs(TRAIN_JOBS)
    run("ranks_train", phase_ranks_train, train_procs, t_train)
    cscale_launches, ccases = run("compressed_scale", phase_compressed_scale, plain_raises)
    gc.collect()  # the compressed scale pools leave the card here
    torch.cuda.empty_cache()
    shc_launches, shc_cases = run("sharded_compressed", phase_sharded_compressed)
    gc.collect()  # the compressed sharded pools leave the card here
    torch.cuda.empty_cache()
    run("gnn_kernels", phase_gnn_kernels)
    sampled, g_reddit, feats = run("gnn_sampled", phase_gnn_sampled)
    run("train_gnn", phase_train_gnn, g_reddit, feats)
    del g_reddit, feats  # the Reddit-scale graph leaves the card here
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
    gc.collect()
    torch.cuda.empty_cache()
    run("train", phase_train)
    gc.collect()
    torch.cuda.empty_cache()
    moe = run("moe_serve", phase_moe_serve, smi)
    gc.collect()  # the MoE weights leave the card here
    torch.cuda.empty_cache()
    run("gnn_molecule", phase_gnn_molecule, smi)
    gc.collect()
    torch.cuda.empty_cache()
    run("dryrun", phase_dryrun, smi, dry_proc)
    emit({"phase_seconds": seconds, "total_s": time.perf_counter() - t_start,
          "phase_peak_bytes": peaks})
    emit({"autotune_by_phase": {k: v for k, v in tuning.items() if v["consults"]},
          "autotune_total": tune_totals()})

    summary = []
    for name in ("segment_sum", "segment_sum_weighted"):
        c = next(c for c in cases if c["name"] == name and c["D"] == 1)
        summary.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/segment_reduce.cu",
            "replaces": "src/repro/kernels/segment_reduce.py:"
                        + ("53" if name == "segment_sum" else "109"),
            "launches": (stream_launches[name] + scale_launches[name] + serve_launches[name]
                         + sh_launches[name] + sh_stream["launches"][name]
                         + shc_launches[name]),
            "sharded_launches": sh_launches[name] + sh_stream["launches"][name]
            + shc_launches[name],
            "sharded": sharded_row(sh_cases, name),
            "max_abs_err": c["max_abs_err"],
            "ms": c["ms"],
            "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"],
            "library_ms": c["library_ms"],
            "library": c["library"],
            "pipelined_ms": c["pipelined_ms"],
            "same_bits": c["same_bits"],
            **tile_fields(cases, name),
            "sharded_tile": tile_fields(sh_cases, name, "per_shard"),
        })
    replaces = dict(zip(CHUNKED_KERNELS, ("229", "271", "410", "454")))
    for name in CHUNKED_KERNELS:
        c = next(c for c in ccases if c["name"] == name and c["D"] == 1)
        summary.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/segment_reduce.cu",
            "replaces": "src/repro/kernels/segment_reduce.py:" + replaces[name],
            "launches": cstream_launches[name] + cscale_launches[name] + shc_launches[name],
            "sharded_launches": shc_launches[name],
            "sharded": sharded_row(shc_cases, name),
            "max_abs_err": c["max_abs_err"],
            "ms": c["ms"],
            "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"],
            "library_ms": None,
            "raw_kernel_ms": c["raw_kernel_ms"],
            "pipelined_ms": c["pipelined_ms"],
            "same_bits": c["same_bits"],
            **tile_fields(ccases, name),
            "sharded_tile": tile_fields(shc_cases, name, "per_shard"),
        })
    replaces = dict(zip(DECODE_KERNELS, ("83", "162", "210")))
    for name in DECODE_KERNELS:
        if name == "delta_decode_padded":
            c, launches = padded, host_launches[name]
        else:
            c = next(c for c in ccases if c["name"] == name)
            launches = cstream_launches[name] + cscale_launches[name] + shc_launches[name]
        summary.append({
            "name": name,
            "route": "cuda",
            "sharded_launches": shc_launches.get(name, 0),
            "sharded": sharded_row(shc_cases, name),
            "source": "src/repro_torch/kernels/csrc/delta_decode.cu",
            "replaces": "src/repro/kernels/delta_decode.py:" + replaces[name],
            "launches": launches,
            "max_abs_err": c["max_abs_err"],
            "ms": c["ms"],
            "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"],
            "library_ms": c["library_ms"],
            **{k: c[k] for k in ("pipelined_ms", "same_bits", "split") if k in c},
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
        "d16": {**{key: c16[key] for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
                "tile": c16["tune"]["tile"], "tile_ms": c16["tune"]["candidates_ms"]},
        "workspace_bytes": c["workspace_bytes"],
        "tile": c["tune"]["tile"],
        "tile_ms": c["tune"]["candidates_ms"],
        "old_tile_ms": c["tune"]["old_tile_ms"],
    })
    k = long["kernel"]
    summary.append({
        "name": "flash_decode",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode.py:73",
        "launches": (long["launches"]["flash_decode"] + d32k["launches"]["flash_decode"]
                     + lm_serve["launches"] + moe["launches"]),
        "moe_launches": moe["launches"],
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"],
        "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"],
        "library_ms": k["library_ms"],
        "pipelined_ms": k["pipelined_ms"],
        "flash_route": k["route"],
        "workspace_bytes": k["workspace_bytes"],
        "decode_32k": {key: d32k["kernel"][key]
                       for key in ("ms", "pipelined_ms", "bound_ms", "library_ms", "route")},
        **{arch: {key: r["decode_long"]["kernel"][key]
                  for key in ("shape", "max_abs_err", "ms", "pipelined_ms", "plain_ms",
                              "bound_ms", "bound_by", "library_ms", "route")}
           for arch, r in moe["archs"].items()},
    })
    emit({"autotune_table": json.loads(TUNE_TABLE.read_text())})
    print(smi, flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
