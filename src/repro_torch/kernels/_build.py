"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, compiled for ``sm_90a`` into ``build/repro_torch_kernels/``
at the repo root (git-ignored), keyed on a hash of the source, every
``csrc/*.cuh`` header and the flags, so an edited source or header
rebuilds.  Builds start at first use — never at
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

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# (library, entry point) -> the C function, its argtypes set at its first call
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}
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
    for header in sorted(CSRC.glob("*.cuh")):  # any source may include any header
        h.update(header.name.encode())
        h.update(header.read_bytes())
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


def check_operands(tensors) -> torch.device:
    """The one device every operand lies on (CPU or CUDA); raises unless
    all are contiguous."""
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all operands must be on one device")
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all operands must be contiguous")
    return dev


def c_function(name: str, fn_name: str, argtypes: list, restype=ctypes.c_int):
    """The C entry point ``fn_name`` of ``csrc/<name>.cu``, its argtypes
    and restype set once, at its first use: every later call must pass the
    same ctypes types (ctypes raises on another)."""
    fn = _fns.get((name, fn_name))
    if fn is None:
        fn = getattr(library(name), fn_name)
        fn.argtypes = argtypes
        fn.restype = restype
        _fns[(name, fn_name)] = fn
    return fn


def call(fn, fn_name: str, args: list, index: int) -> None:
    """``fn(*args, stream)`` with the current stream of CUDA device
    ``index``, as that device; raises on the cudaError it returns.  The
    stream and device come from PyTorch's raw getters, which cost a
    fraction of ``torch.cuda.current_stream``'s object."""
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch._C._cuda_getDevice():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed: cudaError {rc}")


def launch(name: str, fn_name: str, args: list, device: torch.device) -> None:
    """Call the C entry point ``fn_name`` of ``csrc/<name>.cu`` with
    ``args`` (tensors go as pointers, ctypes scalars as typed) and the
    device's current stream; raises on the cudaError it returns."""
    fn = _fns.get((name, fn_name))
    if fn is None:
        fn = c_function(name, fn_name, [ctypes.c_void_p if torch.is_tensor(a) else type(a)
                                        for a in args] + [ctypes.c_void_p])
    args = [a.data_ptr() if torch.is_tensor(a) else a for a in args]
    call(fn, fn_name, args, device.index if device.index is not None
         else torch.cuda.current_device())


# (tag, device index, stream) -> a buffer that calls on that stream reuse
_SCRATCH: dict[tuple[str, int, int], torch.Tensor] = {}


def scratch(tag: str, device: torch.device, nbytes: int, zeroed: bool = False) -> torch.Tensor:
    """A uint8 buffer of at least ``nbytes`` on ``device``, kept per
    (tag, device, current stream) and grown when a call needs more.  The
    calls on one stream run in order, so each may use the whole buffer;
    a ``zeroed`` buffer is zero when made, and its users leave it so."""
    key = (tag, device.index, torch._C._cuda_getCurrentRawStream(device.index))
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < nbytes:
        make = torch.zeros if zeroed else torch.empty
        buf = make(max(nbytes, 16), dtype=torch.uint8, device=device)
        _SCRATCH[key] = buf
    return buf
