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
port's ``TrainState`` template, and the reverse.  Every leaf's ``spec``
is ``null``: re-sharding onto a mesh (``mesh``, ``target_specs``) comes
with multi-rank training (ROADMAP item 16's open half), and ``restore``
takes a device.

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
from .._tree import flatten_with_paths, unflatten

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


def _write(directory: str, step: int, paths: List[str], host: List[Tuple[np.ndarray, str]]) -> str:
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:09d}"
    tmp = os.path.join(directory, name + ".tmp")
    final = os.path.join(directory, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": []}
    for i, (path, (arr, dtype)) in enumerate(zip(paths, host)):
        fn = f"arr_{i:05d}.npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"].append(
            {"path": path, "file": fn, "shape": list(arr.shape), "dtype": dtype, "spec": None}
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


def save(directory: str, step: int, tree: Any) -> str:
    """Synchronous checkpoint write with atomic commit; returns the
    committed step directory."""
    flat = flatten_with_paths(tree)
    return _write(directory, step, [p for p, _ in flat], [_host(leaf) for _, leaf in flat])


class AsyncCheckpointer:
    """Host copy now, background write; at most one write in flight, the
    newest ``keep`` steps kept."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.saved: List[str] = []

    def save_async(self, step: int, tree: Any):
        self.wait()
        flat = flatten_with_paths(tree)
        paths = [p for p, _ in flat]
        host = [_host(leaf) for _, leaf in flat]  # the consistent cut, before the thread

        def work():
            self.saved.append(_write(self.directory, step, paths, host))
            self._gc()

        self._thread = threading.Thread(target=work)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

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
    steps = list_steps(directory)
    return steps[-1] if steps else None


def restore(
    directory: str,
    step: Optional[int] = None,
    device=None,
    template: Optional[Any] = None,
) -> Tuple[int, Any]:
    """Load a committed checkpoint (the latest by default) onto ``device``
    (default the card).

    With a ``template`` (a tree of the saved structure, e.g. a fresh
    ``TrainState``) the result is that structure, each leaf found by its
    path; otherwise a flat ``path -> tensor`` dict.  Each leaf keeps the
    dtype it was saved with.
    """
    dev = resolve(device)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints in {directory}")
    d = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    arrays: Dict[str, torch.Tensor] = {}
    for leaf in manifest["leaves"]:
        arr = np.load(os.path.join(d, leaf["file"]))
        arrays[leaf["path"]] = _tensor(arr, leaf["dtype"], dev)
    if template is not None:
        paths = [p for p, _ in flatten_with_paths(template)]
        return step, unflatten(template, [arrays[p] for p in paths])
    return step, arrays
