"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, compiled for ``sm_90a`` into ``build/repro_torch_kernels/``
at the repo root (git-ignored), keyed on a hash of the source and the
flags so an edited source rebuilds.  Builds start at first use — never at
import — and ``build_all`` starts one ``nvcc`` per source at once.

No fallback: a missing ``nvcc`` or a failed build raises.  PyTorch's
extension build helper is not used, since a source that includes PyTorch's
headers takes minutes to compile where a plain C interface takes seconds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": float, "log": str}; filled by builds made in this process
BUILD_INFO: dict[str, dict] = {}


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): cannot build the CUDA kernels")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, target: Path):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, time.perf_counter()


def _finish(name: str, target: Path, proc, tmp: Path, t0: float) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, target)  # atomic: a concurrent build never loads a partial file
    BUILD_INFO[name] = {"seconds": time.perf_counter() - t0, "log": log}


def build_all() -> dict[str, ctypes.CDLL]:
    """Build every source that is not built yet, all ``nvcc``s in
    parallel, and load them; returns name -> library."""
    with _lock:
        todo = {n: _target(n) for n in sources() if n not in _libs}
        running = {n: _start(n, t) for n, t in todo.items() if not t.is_file()}
        try:
            for n, (proc, tmp, t0) in running.items():
                _finish(n, todo[n], proc, tmp, t0)
        finally:
            for proc, _, _ in running.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for n, t in todo.items():
            _libs[n] = ctypes.CDLL(str(t))
        return dict(_libs)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = build_all()[name]
    return lib
