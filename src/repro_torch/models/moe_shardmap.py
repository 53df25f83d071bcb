"""Shard-local MoE: routing on each rank's own tokens and an explicit
collective schedule over a ("data", "model") mesh.

Counterpart of ``repro/models/moe_shardmap.py``.  The reference runs the
block under ``shard_map``; here each rank runs the same local program on
plain tensors and issues the same two collectives, functional
``torch.distributed`` all-gathers over the mesh's axes (the process
subgroups ``DeviceMesh.get_group(axis)``):

  1. route, sort and capacity-assign ONLY this rank's T/nd tokens
     (``C_local`` slots per expert per data shard, the capacity rule of
     ``models/moe.py`` at T/nd tokens);
  2. build the local dispatch buffer (E, C_local, D) and slice out the
     E/nm experts this model column owns;
  3. all-gather over the data axes ("pod" then "data"): (nd, E/nm,
     C_local, D), every data shard's slots for my experts;
  4. the local grouped products with my experts' weights (E/nm, D, F),
     batched over the expert axis as ``models/moe.py`` runs them (the
     reference has no Pallas kernel here);
  5. all-gather over "model": all experts' outputs for MY data shard's
     slots, and the local combine back to (T/nd, D).

On each rank ``x`` is its data shard (B/nd, S, D) and the result is the
same shard of the output.  The experts' weights may be this column's
E/nm experts or all E (then sliced here); the router and the shared
experts are whole on every rank.  With DTensors (the dry run's fake
process group) the arguments are first laid out as the reference's
``in_specs``, and the dry run records the two gathers.  On a 1x1 mesh
both gathers move nothing and the block is ``models/moe.py``'s, slot for
slot.  Token order, the
capacity-drop policy and the numbers match ``moe.py`` when no expert
overflows its local capacity.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch
import torch.nn.functional as F

from . import layers as L

# set by ``launch/cells.py`` (the ``moe_impl="shardmap"`` override) or by
# the caller before the forward: a ``DeviceMesh`` cannot live in the
# frozen ``LMConfig``
ACTIVE_MESH = None


def _local_dispatch(xt: torch.Tensor, router: torch.Tensor, m, C_local: int):
    """Everything token-local: the dispatch buffer (E, C_local, D) and the
    combine's (slot, keep, src_tok, flat_p, order)."""
    T, D = xt.shape
    dev = xt.device
    logits = L._einsum("td,de->te", xt.float(), router)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, m.top_k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    flat_e = top_e.reshape(-1)
    flat_p = top_p.reshape(-1)
    flat_t = torch.arange(T, device=dev).repeat_interleave(m.top_k)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    first_of_e = torch.searchsorted(e_sorted, torch.arange(m.n_experts, device=dev))
    rank = torch.arange(T * m.top_k, device=dev) - first_of_e[e_sorted]
    keep = rank < C_local
    slot = e_sorted * C_local + rank
    src_tok = flat_t[order]
    n_slots = m.n_experts * C_local
    # a dropped pair goes to the spare row n_slots, sliced off
    buf = xt.new_zeros((n_slots + 1, D)).index_copy(
        0, torch.where(keep, slot, n_slots), xt[src_tok])[:n_slots]
    return buf.reshape(m.n_experts, C_local, D), (slot, keep, src_tok, flat_p, order)


def _block(x_loc, router, w_gate, w_up, w_down, shared, m, C_local: int, nd: int,
           di: int, mi: int, gather_data: Callable, gather_model: Callable):
    """The reference's ``local``: one rank's program, its two collectives
    given as ``gather_data`` ((E/nm, C_local, D) -> (nd, E/nm, C_local,
    D)) and ``gather_model`` ((E/nm, C_local, D) -> (E, C_local, D))."""
    D = x_loc.shape[-1]
    e_per = w_gate.shape[0]
    xt = x_loc.reshape(-1, D)
    buf, (slot, keep, src_tok, flat_p, order) = _local_dispatch(xt, router, m, C_local)
    mine = buf[mi * e_per:(mi + 1) * e_per]
    full = gather_data(mine)  # (nd, E/nm, C_local, D): full capacity for my experts
    h = full.transpose(0, 1).reshape(e_per, nd * C_local, D)
    g = L._einsum("ecd,edf->ecf", h, w_gate)
    u = L._einsum("ecd,edf->ecf", h, w_up)
    o = L._einsum("ecf,efd->ecd", F.silu(g) * u, w_down)
    # back to (nd, E/nm, C_local, D); my data shard's slots
    o_mine = o.reshape(e_per, nd, C_local, D).transpose(0, 1)[di]
    o_all = gather_model(o_mine.contiguous())  # (E, C_local, D)
    o_flat = o_all.reshape(m.n_experts * C_local, D)
    w = torch.where(keep, flat_p[order], 0.0)[:, None].to(x_loc.dtype)
    gathered = o_flat[torch.where(keep, slot, 0)] * w
    out = torch.zeros((xt.shape[0], D), dtype=x_loc.dtype, device=x_loc.device)
    out = out.index_add(0, src_tok, gathered)
    if shared is not None:
        out = out + L.swiglu(shared, xt)
    return out.reshape(x_loc.shape)


def _capacity_local(m, T_local: int) -> int:
    return max(8, -(-int(m.capacity_factor * T_local * m.top_k / m.n_experts) // 8) * 8)


def _experts(w: torch.Tensor, n_experts: int, nm: int, mi: int) -> torch.Tensor:
    """This model column's experts of ``w``: ``w`` itself when it holds
    E/nm of them, else its slice."""
    e_per = n_experts // nm
    return w if w.shape[0] == e_per else w[mi * e_per:(mi + 1) * e_per]


def moe_apply_shardmap(params: Dict[str, Any], cfg, x: torch.Tensor, mesh) -> torch.Tensor:
    """x: this rank's data shard (B/nd, S, D) of the (B, S, D) input over
    the ``mesh``'s data axes ("data", or "pod" and "data"); returns the
    same shard of the output.  ``mesh`` is a ``DeviceMesh`` with a
    "model" axis.  With DTensor arguments x and the output are the whole
    (B, S, D), laid out over the data axes, and ``x``'s own mesh is used
    (the dry run flattens "pod" and "data" into one dim).  The gathers
    are autograd-aware functional collectives, so the block trains."""
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if mesh is None:
        raise RuntimeError("moe_impl='shardmap' needs a (data, model) mesh: set "
                           "models.moe_shardmap.ACTIVE_MESH (launch/cells.py does)")
    m = cfg.moe
    dt = isinstance(x, DTensor)
    mesh = x.device_mesh if dt else mesh
    names = tuple(mesh.mesh_dim_names)
    mdim = names.index("model")
    ddims = [i for i, a in enumerate(names) if a != "model"]
    nm = mesh.size(mdim)
    nd = 1
    for i in ddims:
        nd *= mesh.size(i)
    if m.n_experts % nm:
        raise ValueError(f"{m.n_experts} experts do not split over {nm} model ranks")
    coord = mesh.get_coordinate()
    mi = coord[mdim]
    di = 0
    for i in ddims:
        di = di * mesh.size(i) + coord[i]  # pod-major, as the reference's axis_index
    R = Replicate()
    x_pl = [R if i == mdim else Shard(0) for i in range(mesh.ndim)]
    w_pl = [Shard(0) if i == mdim else R for i in range(mesh.ndim)]

    def local(t, pl):
        """The reference's in_specs: a DTensor laid out as ``pl``, its shard."""
        if isinstance(t, dict):
            return {k: local(v, pl) for k, v in t.items()}
        return t.redistribute(mesh, pl).to_local() if isinstance(t, DTensor) else t

    x_loc = local(x, x_pl)
    C_local = _capacity_local(m, x_loc.shape[0] * x_loc.shape[1])

    def gather(t, i):
        """``t`` gathered along a new leading dim over mesh dim ``i``
        (gloo has no CUDA all-gather: a CUDA tensor goes through host
        memory there)."""
        if t.is_cuda and not dt and dist.get_backend(mesh.get_group(i)) == "gloo":
            return funcol.all_gather_tensor_autograd(t.cpu(), 0, (mesh, i)).to(t.device)
        return funcol.all_gather_tensor_autograd(t, 0, (mesh, i))

    def gather_data(t):
        # over the innermost data axis first: (n_pod, n_data, ...) -> (nd, ...)
        for i in reversed(ddims):
            t = gather(t[None], i)
        return t.reshape((nd,) + tuple(t.shape[len(ddims):]))

    def gather_model(t):
        return gather(t, mdim)

    shared = params.get("shared")
    out = _block(x_loc, local(params["router"], [R] * mesh.ndim),
                 *(_experts(local(params[k], w_pl), m.n_experts, nm, mi)
                   for k in ("w_gate", "w_up", "w_down")),
                 None if shared is None else local(shared, [R] * mesh.ndim),
                 m, C_local, nd, di, mi, gather_data, gather_model)
    if dt:
        return DTensor.from_local(out, mesh, x_pl, run_check=False, shape=x.shape,
                                  stride=x.stride())
    return out
