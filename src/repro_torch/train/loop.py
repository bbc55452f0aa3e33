"""The A²DTWP training loop: one step per wire format + host-side AWP
(counterpart of ``repro.train.loop``).

``Trainer`` caches one step function per format tuple. In the reference a
new tuple means an XLA recompile; here it means the first step at these
formats (``StepRecord.recompiled``), so ``summary()["recompiles"]`` counts
the format changes of a run (at most ``3 × num_groups``: AWP only widens).

A :class:`~repro_torch.plan.PrecisionPlan` drives the loop: its schedule
source selects between the static oracle and AWP, and its
:meth:`~repro_torch.plan.PrecisionPlan.wire_table` is the per-step wire
log. (The reference's pre-plan ``policy=`` strings are not ported: every
caller passes a plan.)
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

from repro_torch.core.awp import AWPController
from repro_torch.plan import PrecisionPlan


@dataclasses.dataclass
class StepRecord:
    step: int
    loss: float
    round_tos: tuple[int, ...]
    wire_bytes: int
    recompiled: bool  # first step at these formats
    wall_s: float  # host clock around the step, ending in the loss sync
    # per-traffic-class split of wire_bytes
    wire_by_entry: dict


class Trainer:
    """Generic A²DTWP loop.

    step_builder(round_tos) -> step_fn(storage, opt, batch, lr, *extra)
        returning (storage, opt, metrics with 'loss' and 'group_norms_sq').
    plan: schedule "awp" runs Algorithm 1 with the plan's threshold /
        interval / initial bits; "static" pins the plan's own formats
        (the paper's oracle; rt=4 = the 32-bit baseline).
    """

    def __init__(
        self,
        step_builder: Callable,
        num_groups: int,
        *,
        plan: PrecisionPlan,
        dist_elems_per_group: list[int] | None = None,
        gather_axis_size: int = 1,
    ):
        self.step_builder = step_builder
        self.num_groups = num_groups
        self.plan = plan.broadcast(num_groups)
        self.awp = self.plan.schedule.source == "awp"
        self.controller = AWPController(num_groups, self.plan.awp_config())
        self._cache: dict[tuple[int, ...], Callable] = {}
        self.records: list[StepRecord] = []
        self.dist_elems = dist_elems_per_group or [0] * num_groups
        self.gather_n = gather_axis_size

    # ------------------------------------------------------------------
    def current_round_tos(self) -> tuple[int, ...]:
        return self.controller.round_to if self.awp else self.plan.round_tos

    def _step_fn(self, round_tos):
        if round_tos not in self._cache:
            self._cache[round_tos] = self.step_builder(round_tos)
        return self._cache[round_tos]

    def wire_entries(self, round_tos) -> dict:
        """Per-traffic-class wire bytes of one step at these formats."""
        return self.plan.with_round_tos(round_tos).wire_table(
            self.dist_elems, self.gather_n
        )

    def wire_bytes(self, round_tos) -> int:
        return self.wire_entries(round_tos)["total"]

    # ------------------------------------------------------------------
    def run_step(self, storage, opt_state, batch, lr, *extra):
        rts = self.current_round_tos()
        recompiled = rts not in self._cache
        fn = self._step_fn(rts)
        t0 = time.perf_counter()
        storage, opt_state, metrics = fn(storage, opt_state, batch, lr, *extra)
        loss = float(metrics["loss"])
        if self.awp:
            norms = metrics["group_norms_sq"].detach().cpu().numpy()
            self.controller.update(np.asarray(norms))
        entries = self.wire_entries(rts)
        self.records.append(
            StepRecord(
                step=len(self.records),
                loss=loss,
                round_tos=rts,
                wire_bytes=entries["total"],
                recompiled=recompiled,
                wall_s=time.perf_counter() - t0,
                wire_by_entry=entries,
            )
        )
        return storage, opt_state, metrics

    # ------------------------------------------------------------------
    @property
    def bits_history(self):
        return self.controller.history

    def summary(self) -> dict:
        total_wire = sum(r.wire_bytes for r in self.records)
        base_wire = sum(
            self.wire_bytes((4,) * self.num_groups) for _ in self.records
        )
        out = {
            "steps": len(self.records),
            "final_loss": self.records[-1].loss if self.records else None,
            "recompiles": sum(r.recompiled for r in self.records),
            "wire_bytes": total_wire,
            "wire_bytes_fp32": base_wire,
            "wire_reduction": 1 - total_wire / base_wire if base_wire else 0.0,
            "bits_history": self.bits_history,
        }
        by_entry: dict[str, int] = {}
        for r in self.records:
            for k, v in r.wire_by_entry.items():
                if k != "total":
                    by_entry[k] = by_entry.get(k, 0) + v
        out["wire_by_entry"] = by_entry
        return out
