"""Async checkpoints with atomic commit, in the reference's on-disk format.

Counterpart of ``repro/checkpoint/checkpoint.py:32-173``.  Layout (one
directory per step):

    <dir>/step_000000123.tmp/       # written first
        manifest.json               # leaf paths, files, shapes, dtypes
        arr_00000.npy ...           # one file per leaf (logical, unsharded)
    <dir>/step_000000123/           # atomic rename on completion
        ... + COMMITTED             # marker file: restore ignores uncommitted

Checkpoints written by either package are readable by the other: the
leaves are the reference's leaves in its order (``_tree``: dict keys
sorted, NamedTuple fields, list items) and each ``path`` is the string
the reference writes (``.params/['embed']/['table']``, ``.opt/.step``).
A reference checkpoint of a ``TrainState`` therefore restores into the
port's ``TrainState`` template, and the reverse.

Specs and re-sharding, as the reference has them: ``save(..., specs)``
writes each leaf's partition spec in the reference's JSON form
(``list(P)``, a tuple entry as a list; ``null`` without specs), and
``restore(mesh=, target_specs=)`` places each leaf on a ``DeviceMesh``
by ``target_specs``, or by the manifest's spec where that is not given:
each rank holds its slice (``dist.shardings.shard_of``).  The arrays on
disk are always the logical ones, so a checkpoint of k ranks restores
onto any other count.  Under a process group (``launch.mesh.init_ranks``)
every rank calls ``save`` with the same tree: with ``mesh`` the sharded
leaves are gathered to rank 0's host one at a time (no rank holds the
logical state on its card), only rank 0 writes and commits, and every
rank returns after the commit; the step ``restore`` and ``latest_step``
pick is rank 0's, broadcast.

bf16 leaves: numpy has no bfloat16 without ``ml_dtypes``, so a bf16
tensor is written as its 16-bit patterns in a two-byte void array
(``V2``: what ``np.load`` also returns for the reference's ``ml_dtypes``
bf16 files), with ``"dtype": "bfloat16"`` in the manifest; ``restore``
reads those bits back as ``torch.bfloat16``, bit for bit, from either
package's file.  The reference's ``restore`` returns such a leaf, from
either package, as the ``V2`` array itself.

Async: ``AsyncCheckpointer.save_async`` copies every leaf to host numpy
at once (a consistent cut: a device leaf's copy waits for the values)
and writes on a background thread, so the train loop goes on; at most
one write is in flight, and ``wait()`` joins it.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .._device import resolve
from .._tree import flatten_with_paths, leaves, unflatten

_BF16 = "bfloat16"


def _host(leaf) -> Tuple[np.ndarray, str]:
    """(numpy array to write, manifest dtype) of one leaf: a host copy."""
    if torch.is_tensor(leaf):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), _BF16
        return t.numpy(), str(t.numpy().dtype)
    a = np.array(leaf)
    return a, str(a.dtype)


def _tensor(arr: np.ndarray, dtype: str, device: torch.device) -> torch.Tensor:
    """A loaded leaf (C-contiguous, as ``np.load`` returns it) as a tensor
    in torch's own memory, on the CPU too (not a view of numpy's buffer)."""
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device, copy=True)
    return torch.from_numpy(arr).to(device, copy=True)


def _ranks() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def _rank0() -> bool:
    import torch.distributed as dist

    return not _ranks() or dist.get_rank() == 0


def _agree(value):
    """Rank 0's ``value`` on every rank (itself without ranks)."""
    if not _ranks():
        return value
    import torch.distributed as dist

    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _barrier() -> None:
    if _ranks():
        import torch.distributed as dist

        dist.barrier()


def _spec_list(specs, n: int) -> List[Optional[list]]:
    """Each leaf's manifest spec: the spec tree's leaves in the tree's leaf
    order when it has one per leaf (the reference's rule), else nulls."""
    if specs is None:
        return [None] * n
    from ..dist import shardings as SH

    flat = leaves(specs)
    if len(flat) != n:
        return [None] * n
    return [SH.spec_to_json(s) if isinstance(s, SH.Spec) else None for s in flat]


def _host_leaves(flat_leaves: List[Any], spec_json: List[Optional[list]],
                 mesh) -> Optional[List[Tuple[np.ndarray, str]]]:
    """Each leaf's host copy (``_host``) as a logical array, on rank 0 (None
    on the others).  With ``mesh`` every rank calls it: one leaf at a time
    is gathered to rank 0's host (``dist.shardings.gather_to_rank0``), so
    no rank holds a whole sharded leaf on its card, and rank 0 at most one
    leaf's slices while they are copied out."""
    if mesh is None:
        return [_host(leaf) for leaf in flat_leaves] if _rank0() else None
    from ..dist import shardings as SH

    out = []
    for leaf, sp in zip(flat_leaves, spec_json):
        if torch.is_tensor(leaf):
            leaf = SH.gather_to_rank0(leaf, SH.spec_from_json(sp), mesh)
        if _rank0():
            out.append(_host(leaf))
    return out if _rank0() else None


def _write(directory: str, step: int, paths: List[str], host: List[Tuple[np.ndarray, str]],
           specs: List[Optional[list]]) -> str:
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:09d}"
    tmp = os.path.join(directory, name + ".tmp")
    final = os.path.join(directory, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": []}
    for i, (path, (arr, dtype), spec) in enumerate(zip(paths, host, specs)):
        fn = f"arr_{i:05d}.npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"].append(
            {"path": path, "file": fn, "shape": list(arr.shape), "dtype": dtype, "spec": spec}
        )
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    # atomic commit: marker then rename
    with open(os.path.join(tmp, "COMMITTED"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def save(directory: str, step: int, tree: Any, specs: Optional[Any] = None,
         mesh=None) -> str:
    """Synchronous checkpoint write with atomic commit; returns the
    committed step directory.  ``specs``: a spec tree of ``tree``'s
    structure, written to the manifest; ``mesh``: the ``DeviceMesh``
    ``tree``'s leaves are this rank's slices on, by ``specs`` (every rank
    calls ``save``; module docstring)."""
    flat = flatten_with_paths(tree)
    spec_json = _spec_list(specs, len(flat))
    host = _host_leaves([leaf for _, leaf in flat], spec_json, mesh)
    final = os.path.join(directory, f"step_{step:09d}")
    if _rank0():
        final = _write(directory, step, [p for p, _ in flat], host, spec_json)
    _barrier()
    return final


class AsyncCheckpointer:
    """Host copy now, background write; at most one write in flight, the
    newest ``keep`` steps kept."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.saved: List[str] = []

    def save_async(self, step: int, tree: Any, specs: Optional[Any] = None, mesh=None):
        """``save``'s arguments; under ranks every rank calls it, the
        gather to rank 0's host runs here and rank 0 writes on the thread."""
        self.wait()
        flat = flatten_with_paths(tree)
        paths = [p for p, _ in flat]
        spec_json = _spec_list(specs, len(flat))
        # the consistent cut, on the host before the thread
        host = _host_leaves([leaf for _, leaf in flat], spec_json, mesh)
        if not _rank0():
            return

        def work():
            self.saved.append(_write(self.directory, step, paths, host, spec_json))
            self._gc()

        self._thread = threading.Thread(target=work)
        self._thread.start()

    def wait(self):
        """Join the write in flight; under ranks every rank calls it and
        returns after rank 0's commit."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        _barrier()

    def _gc(self):
        steps = sorted(list_steps(self.directory))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"), ignore_errors=True)


def list_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for d in os.listdir(directory):
        full = os.path.join(directory, d)
        if d.startswith("step_") and not d.endswith(".tmp") and os.path.exists(
            os.path.join(full, "COMMITTED")
        ):
            out.append(int(d[5:]))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    """The newest committed step (rank 0's, under ranks: every rank calls
    it)."""
    steps = list_steps(directory) if _rank0() else []
    return _agree(steps[-1] if steps else None)


def restore(
    directory: str,
    step: Optional[int] = None,
    device=None,
    template: Optional[Any] = None,
    mesh=None,
    target_specs: Optional[Any] = None,
) -> Tuple[int, Any]:
    """Load a committed checkpoint (the latest by default) onto ``device``
    (default the card).

    With a ``template`` (a tree of the saved structure, e.g. a fresh
    ``TrainState``) the result is that structure, each leaf found by its
    path; otherwise a flat ``path -> tensor`` dict.  Each leaf keeps the
    dtype it was saved with.  With ``mesh`` each leaf is this rank's
    slice by ``target_specs`` (a spec tree of the template's structure)
    or else by the manifest's spec (null: the whole leaf).
    """
    from ..dist import shardings as SH

    dev = resolve(device)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints in {directory}")
    d = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    arrays: Dict[str, torch.Tensor] = {}
    specs: Dict[str, Optional[SH.Spec]] = {}
    for leaf in manifest["leaves"]:
        arr = np.load(os.path.join(d, leaf["file"]))
        # a leaf to be sliced is sliced on the host, then moved
        arrays[leaf["path"]] = _tensor(arr, leaf["dtype"], dev if mesh is None else "cpu")
        specs[leaf["path"]] = SH.spec_from_json(leaf.get("spec"))

    def placed(arr, spec):
        return arr if mesh is None else SH.shard_of(arr, spec, mesh).to(dev, copy=True)

    if template is not None:
        paths = [p for p, _ in flatten_with_paths(template)]
        spec_leaves = (leaves(target_specs) if target_specs is not None
                       else [specs[p] for p in paths])
        return step, unflatten(template, [placed(arrays[p], s)
                                          for p, s in zip(paths, spec_leaves)])
    return step, {p: placed(a, specs[p]) for p, a in arrays.items()}
