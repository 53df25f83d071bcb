"""Production mesh factory and the H100 roofline constants.

Counterpart of ``repro/launch/mesh.py``.  A FUNCTION, not a module
constant: importing this module touches no process group.  Single pod:
(16, 16) = 256 ranks ("data", "model"); multi-pod: (2, 16, 16) = 512
ranks ("pod", "data", "model"), the reference's shapes and names, so the
per-device shapes can be held against it.  The mesh needs a default
process group of that world size: the dry run starts one on the ``fake``
backend in one process (``launch.dryrun.fake_world``).

The roofline constants are one H100 SXM's datasheet figures.  A
collective whose ranks all sit in one HGX node (8 GPUs joined by NVLink)
is priced at the NVLink rate, any other at the per-GPU network rate
(``link_of``): ranks are laid out row-major over the mesh, so a mesh axis
larger than 8 always leaves the node.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

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
