"""Fault-tolerance policies for multi-host runs.

Counterpart of ``repro/dist/fault_tolerance.py:19-120``, a copy of its
host code over the port's checkpoint module.  Three small,
deterministic, host-side components:

* ``HeartbeatMonitor`` — liveness bookkeeping: hosts beat, the
  coordinator asks who's dead.
* ``StragglerPolicy``  — per-step accept/reject of gradient shards:
  persistent stragglers are flagged for reassignment, accepted steps
  rescale the gradient by n/(n - late) (drop-and-rescale), and a step
  with too few timely shards is rejected outright (grad_scale 0).
* ``ResumableRun``     — checkpoint-backed resume loop glue over
  ``repro_torch.checkpoint.checkpoint`` (restore-or-init, save-every-k).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple


class HeartbeatMonitor:
    def __init__(self, n_hosts: int, timeout_s: float):
        self.n_hosts = n_hosts
        self.timeout_s = float(timeout_s)
        self._last: Dict[int, float] = {}

    def beat(self, host_id: int, now: float) -> None:
        self._last[host_id] = float(now)

    def dead_hosts(self, now: float) -> List[int]:
        """Hosts whose last beat is older than the timeout (hosts that
        never beat count as dead)."""
        return [
            h
            for h in range(self.n_hosts)
            if now - self._last.get(h, float("-inf")) > self.timeout_s
        ]


class StragglerPolicy:
    def __init__(
        self,
        n_shards: int,
        min_shards: int,
        deadline_s: float,
        strikes_out: int = 3,
    ):
        self.n_shards = n_shards
        self.min_shards = min_shards
        self.deadline_s = float(deadline_s)
        self.strikes_out = strikes_out
        self._strikes: Dict[int, int] = {s: 0 for s in range(n_shards)}

    def step(self, durations_s: Dict[int, float]) -> Dict[str, Any]:
        """One training step's verdict given per-shard durations.

        Returns ``{accepted, late, grad_scale, reassign}``:
        late shards are excluded; if enough timely shards remain the
        step is accepted with gradients rescaled by n/(n - late);
        shards late ``strikes_out`` steps in a row are reassigned.
        """
        late = sorted(
            s for s, d in durations_s.items() if d > self.deadline_s
        )
        for s in range(self.n_shards):
            if s in late:
                self._strikes[s] = self._strikes.get(s, 0) + 1
            else:
                self._strikes[s] = 0
        reassign = sorted(
            s for s in late if self._strikes[s] >= self.strikes_out
        )
        timely = self.n_shards - len(late)
        accepted = timely >= self.min_shards
        grad_scale = (self.n_shards / timely) if accepted and timely else 0.0
        return {
            "accepted": accepted,
            "late": late,
            "grad_scale": grad_scale,
            "reassign": reassign,
        }


class ResumableRun:
    """Restore-or-init + periodic-save glue for a training loop.

    ``make_state`` builds a fresh state (also used as the restore
    template).  A falsy ``directory`` disables checkpointing entirely
    (restore_or_init returns a fresh state; saves are no-ops).  A
    restored state lands on ``device`` (default the card).

    Across ranks, ``specs`` (the state's spec tree) and ``mesh`` (the
    ``DeviceMesh`` it is laid out on): saves gather the state's slices and
    record the specs, restores place each rank's slice, and the fresh
    state is ``make_state()`` placed the same way.  Every rank runs the
    same calls.
    """

    def __init__(
        self,
        directory: Optional[str],
        make_state: Callable[[], Any],
        save_every: int = 100,
        device=None,
        specs: Optional[Any] = None,
        mesh=None,
    ):
        self.directory = directory
        self.make_state = make_state
        self.save_every = max(1, int(save_every))
        self.device = device
        self.specs = specs
        self.mesh = mesh

    def _fresh(self, template):
        if self.mesh is None:
            return template
        from .shardings import place

        return place(template, self.specs, self.mesh)

    def restore_or_init(self) -> Tuple[int, Any]:
        template = self.make_state()
        if not self.directory:
            return 0, self._fresh(template)
        from ..checkpoint import checkpoint as ckpt

        step = ckpt.latest_step(self.directory)  # rank 0's, under ranks
        if step is None:
            return 0, self._fresh(template)
        return ckpt.restore(self.directory, step, device=self.device, template=template,
                            mesh=self.mesh, target_specs=self.specs)

    def maybe_save(self, step: int, state: Any) -> bool:
        if not self.directory or step <= 0 or step % self.save_every != 0:
            return False
        from ..checkpoint import checkpoint as ckpt

        ckpt.save(self.directory, step, state, self.specs, mesh=self.mesh)
        return True

    def finish(self) -> None:
        """Flush point for symmetry with async savers (sync saves need
        no teardown)."""
