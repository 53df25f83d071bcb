"""The control of the writer cells: the plain reference put in the
layout's place, computing each publish with its set operations and
writing it into the previous version's storage in place, so that a
version held from before later publishes does not stay as it was.  A
query generator keeps its own control beside its program call
(``control_answerer``); with this object as the system it runs that
instead, on the version this object builds.

Run a cell with its control on the card with ``python3 -m bench.control
--workload <cell> --seed <n> --seconds <s>``; ``bench.run`` never runs a
control.
"""
from __future__ import annotations

import numpy as np
import torch

from .reference import sets

SENT64 = sets.SENT64


class Control:
    is_control = True

    def build(self, cfg, keys: np.ndarray, device):
        k = torch.from_numpy(keys).to(device)
        pool = torch.full((cfg["pool_edges"],), SENT64, dtype=torch.int64, device=device)
        pool[: k.numel()] = k
        return {"keys": pool, "offsets": sets.offsets_of(k, cfg["n"]), "m": k.numel(),
                "n": cfg["n"]}

    def publish(self, v, kind, edges, m, device, span):
        cur = v["keys"][: v["m"]]
        b = sets.batch_keys(edges, device)
        new = (torch.unique(torch.cat([cur, b])) if kind == "insert"
               else cur[~torch.isin(cur, b)])
        v["keys"][: new.numel()] = new
        v["keys"][new.numel():] = SENT64
        v["offsets"].copy_(sets.offsets_of(new, v["n"]))
        v["m"] = new.numel()
        return v

    def settle(self, v):
        if v["keys"].is_cuda:
            torch.cuda.synchronize()
        return v["m"], False

    def storages(self, v):
        return [v["keys"], v["offsets"]]

    def judged(self, v):
        return {"keys": v["keys"], "offsets": v["offsets"], "m": v["m"]}
