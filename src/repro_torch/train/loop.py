"""The A²DTWP training loop: one step per wire format + host-side AWP
(counterpart of ``repro.train.loop``).

``Trainer`` caches one step function per format tuple. In the reference a
new tuple means an XLA recompile; here it means the first step at these
formats (``StepRecord.recompiled``), so ``summary()["recompiles"]`` counts
the format changes of a run (at most ``3 × num_groups``: AWP only widens).

A :class:`~repro_torch.plan.PrecisionPlan` drives the loop: its schedule
source selects between the static oracle and AWP, and its
:meth:`~repro_torch.plan.PrecisionPlan.wire_table` is the per-step
analytic wire log, and a step's ``wire_bytes`` is its total, as in the
reference. Across ranks (``gather_axis_size > 1``) each step also gets a
measured log: ``ring_wire_bytes`` of the collectives that
:mod:`repro_torch.dist.comm` recorded during the step, per traffic class
(``weights``, ``gradients``, ``activations``, ``seq_boundary`` and the
classes no plan entry prices: ``grad_sync``, ``metrics``, ``loss``), a
count independent of the plan's formulas, with the seconds the step spent
staging tensors between the device and the host for gloo. A step fed by
the shard prefetcher also keeps its batch's training-I/O bytes
(``run_step(..., io_log=...)``, ``StepRecord.io_by_entry``), summed in the
summary's ``io_by_entry``. (The
reference's pre-plan ``policy=`` strings are not ported: every caller
passes a plan.)
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

from repro_torch.core.awp import AWPController
from repro_torch.dist import comm
from repro_torch.plan import PrecisionPlan
from repro_torch.utils import spans


@dataclasses.dataclass
class StepRecord:
    step: int
    loss: float
    round_tos: tuple[int, ...]
    wire_bytes: int
    recompiled: bool  # first step at these formats
    wall_s: float  # host clock around the step, ending in the loss sync
    # per-traffic-class split of the plan's wire_table
    wire_by_entry: dict
    # measured per-traffic-class bytes (dist.comm's log of the step), with
    # the classes the plan does not price ("grad_sync", "metrics", "loss");
    # None on one device (no collective)
    measured_by_entry: dict | None = None
    # host clock of the step's device <-> host staging for gloo
    stage_s: float = 0.0
    # training-I/O bytes of the step's batch ("shard_read": stored bytes
    # read off disk, "host_device": bytes staged across the boundary at
    # the plan's host_device policy), from the prefetcher's io_log; None
    # for batches made inline
    io_by_entry: dict | None = None
    # the step's MoE auxiliary loss (the step's metrics["aux"]); 0.0 for a
    # step without one
    aux: float = 0.0


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
    def run_step(self, storage, opt_state, batch, lr, *extra, io_log=None):
        with spans.span("train.step"):
            rts = self.current_round_tos()
            recompiled = rts not in self._cache
            fn = self._step_fn(rts)
            first = len(comm.LOG)
            t0 = time.perf_counter()
            storage, opt_state, metrics = fn(storage, opt_state, batch, lr, *extra)
            with spans.span("train.loss_sync"):
                loss = float(metrics["loss"])
            wall_s = time.perf_counter() - t0
            if self.awp:
                norms = metrics["group_norms_sq"].detach().cpu().numpy()
                self.controller.update(np.asarray(norms))
            entries = self.wire_entries(rts)
            measured, stage_s = None, 0.0
            calls = comm.LOG[first:]
            if self.gather_n > 1 or calls:
                measured = comm.wire_by_traffic(calls)
                stage_s = sum(c.stage_s for c in calls)
            self.records.append(
                StepRecord(
                    step=len(self.records),
                    loss=loss,
                    round_tos=rts,
                    wire_bytes=entries["total"],
                    recompiled=recompiled,
                    wall_s=wall_s,
                    wire_by_entry=entries,
                    measured_by_entry=measured,
                    stage_s=stage_s,
                    io_by_entry=(
                        {k: v for k, v in io_log.items() if isinstance(v, int)}
                        if io_log is not None else None
                    ),
                    aux=float(metrics.get("aux", 0.0)),
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
        for key in ("wire_by_entry", "measured_by_entry"):
            by_entry: dict[str, int] = {}
            for r in self.records:
                for k, v in (getattr(r, key) or {}).items():
                    if k != "total":
                        by_entry[k] = by_entry.get(k, 0) + v
            if key == "wire_by_entry" or any(r.measured_by_entry is not None
                                             for r in self.records):
                out[key] = by_entry
        if any(r.io_by_entry for r in self.records):
            io: dict[str, int] = {}
            for r in self.records:
                for k, v in (r.io_by_entry or {}).items():
                    io[k] = io.get(k, 0) + v
            out["io_by_entry"] = io
        return out
