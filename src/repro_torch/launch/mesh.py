"""Production mesh factory and the H100 roofline constants.

Counterpart of ``repro/launch/mesh.py``.  A FUNCTION, not a module
constant: importing this module touches no process group.  Single pod:
(16, 16) = 256 ranks ("data", "model"); multi-pod: (2, 16, 16) = 512
ranks ("pod", "data", "model"), the reference's shapes and names, so the
per-device shapes can be held against it.  The mesh needs a default
process group of that world size: the dry run starts one on the ``fake``
backend in one process (``launch.dryrun.fake_world``).

Real ranks: ``init_ranks`` starts the default process group of a
multi-process run (``torchrun --nproc-per-node k``, or an explicit
``init_method`` such as a ``file://`` store), NCCL on the card and gloo
on the host, and ``rank_mesh`` lays a ``DeviceMesh`` over its ranks
(``rank_mesh((d, m), ("data", "model"))`` over d·m ranks, row-major:
the model axis's ranks are consecutive).
``control_group`` is a second, gloo, group over the same ranks for
host-side messages (the graph query service's op descriptors,
``send_op`` / ``recv_op`` / ``ack_op``), so they never queue behind the
data collectives of the default group.

The roofline constants are one H100 SXM's datasheet figures.  A
collective whose ranks all sit in one HGX node (8 GPUs joined by NVLink)
is priced at the NVLink rate, any other at the per-GPU network rate
(``link_of``): ranks are laid out row-major over the mesh, so a mesh axis
larger than 8 always leaves the node.
"""
from __future__ import annotations

import atexit
import os
from datetime import timedelta
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve

# NVIDIA H100 Tensor Core GPU datasheet, SXM5 column: dense BF16 tensor
# rate (1,979 TFLOP/s with sparsity, halved) and HBM3 bandwidth.
PEAK_FLOPS_BF16 = 989e12  # FLOP/s
HBM_BW = 3.35e12  # B/s
# Same datasheet: NVLink 900 GB/s per GPU, both directions together; a
# rank sends at half of it.
NVLINK_BW = 450e9  # B/s per direction
# NVIDIA DGX H100 / HGX H100 reference: one ConnectX-7 400 Gb/s NDR
# InfiniBand port per GPU.
NET_BW = 50e9  # B/s per GPU
NODE_GPUS = 8  # one HGX node's NVLink domain


def link_of(ranks: Sequence[int]) -> str:
    """``"nvlink"`` if the ranks of a collective share one node, else
    ``"network"``."""
    return "nvlink" if len({int(r) // NODE_GPUS for r in ranks}) <= 1 else "network"


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) ``("data", "model")`` mesh, or (2, 16, 16) with
    ``"pod"`` in front, over the default process group's ranks.  Its
    device type is ``cuda``, so DTensor moves a shard between dims with
    the all-to-all a GPU mesh runs (on a ``cpu`` mesh it gathers the
    whole tensor instead).  Building it touches no card."""
    from torch.distributed.device_mesh import DeviceMesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    return DeviceMesh("cuda", torch.arange(n).reshape(shape), mesh_dim_names=axes)


def make_host_mesh():
    """1x1 mesh with the same axis names (smoke tests / examples)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))


def spmd_mesh(mesh):
    """The mesh the dry run's DTensors live on: ``mesh`` itself, or for
    the multi-pod mesh a (32, 16) mesh whose first dim ("pod+data") is
    the pod and data axes flattened, pod-major, with the same ranks in
    the same places.  The sharding rules always shard over pod and data
    together, so nothing is lost, and DTensor's strategies are at home
    on two mesh dims."""
    from torch.distributed.device_mesh import DeviceMesh

    names = tuple(mesh.mesh_dim_names)
    if names[:2] != ("pod", "data"):
        return mesh
    sizes = dict(zip(names, mesh.shape))
    return DeviceMesh(mesh.device_type,
                      torch.arange(mesh.size()).reshape(sizes["pod"] * sizes["data"],
                                                        sizes["model"]),
                      mesh_dim_names=("pod+data", "model"))


def init_ranks(backend: Optional[str] = None, device=None, *,
               init_method: Optional[str] = None, rank: Optional[int] = None,
               world_size: Optional[int] = None) -> torch.device:
    """Start the default process group of this rank and return the
    device it works on.

    ``device`` as ``_device.resolve`` takes it: ``None`` is the card, and
    a CUDA request without a GPU raises.  ``backend`` defaults to NCCL on
    the card and gloo on the host; gloo on the card runs its collectives
    through host memory where it has no CUDA form.  The rendezvous is
    ``init_method`` with ``rank`` and ``world_size`` when given (tests
    point it at a ``file://`` store), else torchrun's environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``).  On the
    card each rank takes GPU ``LOCAL_RANK`` (default: its rank) modulo the
    GPU count, so ranks may share one card.  A group already up is kept,
    and its backend must be the one asked for."""
    dev = resolve(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank if rank is not None
                                   else os.environ.get("RANK", 0)))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"a {dist.get_backend()} process group is already up, "
                               f"not {backend}")
        return dev
    kw = {"device_id": dev} if backend == "nccl" else {}
    if init_method is None:
        dist.init_process_group(backend, **kw)
    else:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size, **kw)
    return dev


def rank_mesh(shape: Optional[Tuple[int, ...]] = None,
              names: Sequence[str] = ("data", "model"), device=None):
    """A ``DeviceMesh`` over the default process group's ranks, laid out
    row-major: ``shape`` (default: all ranks on the first axis, 1 on the
    others) with the axis ``names``, of ``device``'s type (``None``: the
    card).  Its ``get_group(axis)`` gives each axis's process group."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("rank_mesh needs a process group: call init_ranks first")
    names = tuple(names)
    if shape is None:
        shape = (dist.get_world_size(),) + (1,) * (len(names) - 1)
    if int(np.prod(shape)) != dist.get_world_size():
        raise ValueError(f"mesh {tuple(shape)} does not cover {dist.get_world_size()} ranks")
    return init_device_mesh(resolve(device).type, tuple(shape), mesh_dim_names=names)


# the control channel: a wait for a control message ends with an error
# after this long, so a rank that died ends its peers within it (a
# closed connection ends them at once); rank 0 sends a keep-alive when
# it has sent nothing for KEEPALIVE_S, so an idle service never gets
# near it
CONTROL_TIMEOUT_S = 60.0
KEEPALIVE_S = 1.0
_CONTROL: list = []  # [the gloo group], while it is registered


def _drop_control() -> None:
    _CONTROL.clear()  # before interpreter teardown, not during it


atexit.register(_drop_control)


def control_group():
    """The gloo process group over every rank of the default group that
    carries host-side control messages.  Made on first use, once per
    default group: ``dist.new_group`` is itself a collective, so every
    rank must make its first call at the same point (the graph query
    service's constructor does)."""
    if not dist.is_initialized():
        raise RuntimeError("control_group needs a process group: call init_ranks first")
    if _CONTROL:
        try:
            dist.get_process_group_ranks(_CONTROL[0])
        except (KeyError, ValueError, RuntimeError):  # destroyed with its default group
            _CONTROL.clear()
    if not _CONTROL:
        _CONTROL.append(dist.new_group(backend="gloo",
                                       timeout=timedelta(seconds=CONTROL_TIMEOUT_S)))
    return _CONTROL[0]


def send_op(desc: dict) -> None:
    """Rank 0: broadcast one control message (any picklable dict)."""
    dist.broadcast_object_list([desc], src=0, group=control_group())


def recv_op() -> dict:
    """A follower rank: the next control message from rank 0 (raises after
    ``CONTROL_TIMEOUT_S``, or at once when rank 0's connection closes)."""
    box = [None]
    dist.broadcast_object_list(box, src=0, group=control_group())
    return box[0]


def ack_op(fault: bool = False) -> bool:
    """Every rank, at the end of a control message's work: one scalar
    all-reduce over the control group; True when some rank reported a
    fault."""
    t = torch.tensor([int(fault)], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=control_group())
    return bool(t.item())
