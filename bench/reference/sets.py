"""The edge set after a log of batch publishes, and a pool judged against it.

A publish inserts or deletes one batch of directed keys ``(src << 32) |
dst``.  After a log of publishes a key is in the graph iff the last
publish that named it inserted it, or, if none named it, iff the initial
graph held it.  Batches come from a ring, so the last publish naming a
key is found among each ring batch's last publish.
"""
from __future__ import annotations

import numpy as np
import torch

SENT64 = int(np.iinfo(np.int64).max)


def batch_keys(edges: np.ndarray, device) -> torch.Tensor:
    """A batch's distinct keys, sorted, on ``device``."""
    e = torch.from_numpy(np.ascontiguousarray(edges)).to(device)
    return torch.unique((e[:, 0] << 32) | e[:, 1])


def state_after(base: torch.Tensor, ring: list, log: list, upto: int) -> torch.Tensor:
    """Sorted unique keys after the first ``upto`` publishes of ``log``
    (``(kind, ring index)`` pairs, kind "insert" or "delete") applied to
    ``base`` (sorted unique keys); ``ring[r]`` is batch r's keys."""
    last = {}
    for t, (kind, r) in enumerate(log[:upto]):
        last[r] = (t, kind == "insert")
    if not last:
        return base.clone()
    keys = torch.cat([ring[r] for r in last])
    stamp = torch.cat([torch.full((ring[r].numel(),), t, dtype=torch.int64, device=base.device)
                       for r, (t, _) in last.items()])
    ins = torch.cat([torch.full((ring[r].numel(),), i, dtype=torch.bool, device=base.device)
                     for r, (_, i) in last.items()])
    order = torch.argsort(stamp, stable=True)
    keys, ins = keys[order], ins[order]
    order = torch.argsort(keys, stable=True)
    keys, ins = keys[order], ins[order]
    is_last = torch.ones_like(ins)
    is_last[:-1] = keys[1:] != keys[:-1]
    touched, present = keys[is_last], ins[is_last]
    kept = base[~torch.isin(base, touched)]
    return torch.sort(torch.cat([kept, touched[present]])).values


def offsets_of(keys: torch.Tensor, n: int) -> torch.Tensor:
    """CSR offsets of sorted keys over n vertices: offsets[v] = #keys with src < v."""
    counts = torch.bincount(keys >> 32, minlength=n)[:n]
    return torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]).to(torch.int32)


def _lane_errors(got: torch.Tensor, want: torch.Tensor, m_got: int, pad) -> int:
    """Positions where a pool lane disagrees with the wanted prefix, over
    the longer of the two valid prefixes (a side's slots past its own
    end read as ``pad``)."""
    L = max(m_got, want.numel())
    g = torch.full((L,), pad, dtype=want.dtype, device=want.device)
    k = min(m_got, got.numel(), L)
    g[:k] = got[:k].to(want.dtype)
    w = torch.full((L,), pad, dtype=want.dtype, device=want.device)
    w[: want.numel()] = want
    return int((g != w).sum())


def pool_errors(judged: dict, want: torch.Tensor, n: int) -> dict:
    """Numbers that judge one published version against the wanted keys:
    ``m`` off by, edge slots that differ (flat: the keys, pad slots
    included; compressed: the decoded dst lane), offsets that differ."""
    dev = want.device
    m = int(judged["m"])
    out = {"m": abs(m - want.numel())}
    if "keys" in judged:
        keys = judged["keys"].to(dev)
        errs = _lane_errors(keys, want, m, SENT64)
        errs += int((keys[max(m, want.numel()):] != SENT64).sum())
    else:
        dst = judged["dst"].to(dev)
        errs = _lane_errors(dst, (want & 0xFFFFFFFF).to(torch.int32), m, -1)
    out["slots"] = errs
    offs = judged["offsets"].to(dev)
    ref = offsets_of(want, n)
    if offs.numel() != ref.numel():
        out["offsets"] = max(offs.numel(), ref.numel())
    else:
        out["offsets"] = int((offs.to(torch.int32) != ref).sum())
    return out
