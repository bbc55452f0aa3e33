"""PrecisionPlan — the declarative precision plan (counterpart of
``repro.plan.plan``, the subset the one-device paths use).

A plan holds one :class:`~repro_torch.transport.CompressionPolicy` per
weight precision group, an optional ``activations`` policy (the CNN's
stage-boundary quantize), an optional ``host_device`` policy (the serve
engine's token staging; defaults to the weight entries) and a schedule
source (``static`` — the paper's oracle — or ``awp``, with Algorithm 1's
hyper-parameters).
:meth:`PrecisionPlan.wire_table` is the per-entry byte account of one
step on one device, from the policy formulas.

Plan JSON loads across packages: :meth:`PrecisionPlan.to_json_dict`
writes the reference's other fields at their defaults, and
:meth:`PrecisionPlan.from_json_dict` accepts them only at those defaults
(anything else raises ``NotImplementedError``: the port has no code that
would honour it yet).

Invalid plans raise :class:`ValueError` at construction.
"""
from __future__ import annotations

import copy
import dataclasses
import json
from typing import Mapping

import torch

from repro_torch.core.awp import AWPConfig
from repro_torch.transport.policy import (
    FP32_BYTES,
    CompressionPolicy,
    policy_for,
)

TRAFFIC_CLASSES = (
    "weights", "gradients", "activations", "seq_boundary", "host_device",
    "kv_migration", "weight_publish",
)
VALID_SCHEDULES = ("static", "awp")
# The reference plan's fields this port has no code for, at the values
# that leave a one-device CNN run unchanged.
UNPORTED_DEFAULTS = {
    "gradients": None,
    "seq_boundary": None,
    "kv_migration": None,
    "weight_publish": None,
    "seq_parallel": False,
    "chunks": 1,
    "dtype": "f32",
    "int8_kv": False,
    "accum_steps": 1,
    "env_overrides": {},
    "sampling": {"temperature": 0.0, "top_p": 1.0, "top_k": 0, "seed": 0},
    "spec_draft": "",
    "spec_k": 4,
}
# the reference's JSON key order
JSON_FIELDS = (
    "weights", "gradients", "activations", "seq_boundary", "host_device",
    "kv_migration", "weight_publish", "schedule", "seq_parallel", "chunks",
    "dtype", "int8_kv", "accum_steps", "env_overrides", "sampling",
    "spec_draft", "spec_k",
)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Who decides the weight formats at runtime.

    ``static`` — the plan's weight entries are final (the paper's
    *oracle* policy; a uniform rt=4 plan is the fp32 baseline).
    ``awp`` — Algorithm 1 monitors Σw² per group and widens the weight
    entries; the controller hyper-parameters live here so one JSON file
    describes the whole run.
    """

    source: str = "static"
    awp_threshold: float = -2e-3
    awp_interval: int = 100
    awp_initial_bits: int = 8

    def __post_init__(self):
        if self.source not in VALID_SCHEDULES:
            raise ValueError(
                f"schedule source must be in {VALID_SCHEDULES}, "
                f"got {self.source!r}"
            )
        if self.awp_interval <= 0:
            raise ValueError("awp_interval must be positive")
        if self.awp_initial_bits % 8 or not (8 <= self.awp_initial_bits <= 32):
            raise ValueError("awp_initial_bits must be 8/16/24/32")

    def awp_config(self) -> AWPConfig:
        return AWPConfig(
            threshold=self.awp_threshold,
            interval=self.awp_interval,
            initial_bits=self.awp_initial_bits,
        )


def _coerce_policy(v) -> CompressionPolicy | None:
    if v is None or isinstance(v, CompressionPolicy):
        return v
    if isinstance(v, Mapping):
        return CompressionPolicy(**v)
    return policy_for(v)


@dataclasses.dataclass(frozen=True)
class PrecisionPlan:
    """Declarative precision plan (see module docstring)."""

    weights: tuple[CompressionPolicy, ...] = (CompressionPolicy(),)
    activations: CompressionPolicy | None = None
    host_device: CompressionPolicy | None = None
    schedule: Schedule = dataclasses.field(default_factory=Schedule)

    def __post_init__(self):
        ws = self.weights
        if isinstance(ws, CompressionPolicy):
            ws = (ws,)
        ws = tuple(_coerce_policy(w) for w in ws)
        if not ws or any(w is None for w in ws):
            raise ValueError("plan needs at least one weights entry")
        object.__setattr__(self, "weights", ws)
        object.__setattr__(self, "activations", _coerce_policy(self.activations))
        object.__setattr__(self, "host_device", _coerce_policy(self.host_device))
        if isinstance(self.schedule, Mapping):
            object.__setattr__(self, "schedule", Schedule(**self.schedule))
        if not isinstance(self.schedule, Schedule):
            raise ValueError("schedule must be a Schedule")
        # activation-path stochastic rounding has no PRNG plumbing
        a = self.activations
        if a is not None and "stochastic" in (a.mode, a.grad_mode):
            raise ValueError(
                "activations policy cannot use stochastic rounding; "
                "use mode='nearest'"
            )

    # -- resolution ------------------------------------------------------
    @property
    def num_weight_groups(self) -> int:
        return len(self.weights)

    @property
    def round_tos(self) -> tuple[int, ...]:
        return tuple(w.round_to for w in self.weights)

    def broadcast(self, num_groups: int) -> "PrecisionPlan":
        """Expand a single weights entry to ``num_groups`` groups (a
        plan JSON need not know the architecture's group count)."""
        if len(self.weights) == num_groups:
            return self
        if len(self.weights) == 1:
            return dataclasses.replace(
                self, weights=self.weights * num_groups
            )
        raise ValueError(
            f"plan has {len(self.weights)} weight entries, "
            f"model needs {num_groups}"
        )

    def with_round_tos(self, round_tos) -> "PrecisionPlan":
        """Same plan with the weight formats replaced — how the AWP
        schedule materializes each widening as a new plan."""
        rts = tuple(int(r) for r in round_tos)
        ws = self.weights
        if len(ws) == 1 and len(rts) > 1:
            ws = ws * len(rts)
        if len(ws) != len(rts):
            raise ValueError(f"{len(rts)} round_tos for {len(ws)} entries")
        return dataclasses.replace(
            self,
            weights=tuple(
                dataclasses.replace(w, round_to=rt)
                for w, rt in zip(ws, rts)
            ),
        )

    def weight_policies(self) -> tuple[CompressionPolicy, ...]:
        """The per-group policies the transport runs."""
        return self.weights

    def host_device_policies(self) -> tuple[CompressionPolicy, ...]:
        """Policies of the host<->device boundary (the paper's weight
        staging model and the serve engine's token staging): the
        ``host_device`` entry for every group, else the weight entries."""
        if self.host_device is not None:
            return (self.host_device,) * len(self.weights)
        return self.weights

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.float32  # the plan's dtype field is "f32" (only that is ported)

    def make_env(self, mesh_cfg):
        """Build the execution :class:`~repro_torch.models.env.Env` (the
        trivial mesh only: ``Env`` raises for tp > 1)."""
        from repro_torch.models.env import Env

        return Env(tp=mesh_cfg.tp, dtype=self.compute_dtype)

    @property
    def needs_rng(self) -> bool:
        """True when a stochastic mode is configured on the weight path
        (the step would need a PRNG key). Width-independent on purpose,
        as in the reference: ``with_round_tos`` never flips it."""
        return any(
            "stochastic" in (p.mode, p.grad_mode) for p in self.weights
        )

    def awp_config(self) -> AWPConfig | None:
        if self.schedule.source != "awp":
            return None
        return self.schedule.awp_config()

    # -- per-entry wire accounting ---------------------------------------
    def wire_table(self, dist_elems_per_group, gather_axis_size: int = 1) -> dict:
        """Per-traffic-class wire bytes of ONE step on one device: the
        paper's host→device model, every ``DIST`` weight moved once at its
        group's width (``CompressionPolicy.host_device_bytes``). The keys
        are the reference's; the classes a one-device step does not move
        report 0.

        ``dist_elems_per_group`` — compressed element count per precision
        group (see ``repro_torch.train.cnn_step.cnn_dist_elems``).
        ``gather_axis_size`` — FSDP shards; only 1 is ported.
        """
        if int(gather_axis_size) > 1:
            raise NotImplementedError(
                "sharded wire accounting is not ported (one device only)"
            )
        elems = list(dist_elems_per_group)
        if len(elems) != len(self.weights):
            raise ValueError(
                f"{len(elems)} group element counts for "
                f"{len(self.weights)} weight entries"
            )
        table = {k: 0 for k in TRAFFIC_CLASSES}
        table["host_device"] = sum(
            pol.host_device_bytes(e)
            for pol, e in zip(self.host_device_policies(), elems)
        )
        table["total"] = table["host_device"]
        return table

    # -- serialization ---------------------------------------------------
    def to_json_dict(self) -> dict:
        """The reference's JSON layout: this plan's fields, and the
        reference's other fields at their defaults."""
        def pol(p):
            return None if p is None else dataclasses.asdict(p)

        ours = {
            "weights": [pol(w) for w in self.weights],
            "activations": pol(self.activations),
            "host_device": pol(self.host_device),
            "schedule": dataclasses.asdict(self.schedule),
        }
        d = {"version": 1}
        for k in JSON_FIELDS:
            d[k] = ours[k] if k in ours else copy.deepcopy(UNPORTED_DEFAULTS[k])
        return d

    @classmethod
    def from_json_dict(cls, d: Mapping) -> "PrecisionPlan":
        d = dict(d)
        version = d.pop("version", 1)
        if version != 1:
            raise ValueError(f"unknown plan version {version!r}")
        ws = d.pop("weights", None)
        if ws is None:
            raise ValueError("plan JSON needs a 'weights' entry")
        if isinstance(ws, Mapping):
            ws = [ws]
        for k in [k for k in d if k in UNPORTED_DEFAULTS]:
            v = d.pop(k)
            if v != UNPORTED_DEFAULTS[k]:
                raise NotImplementedError(
                    f"plan field {k}={v!r} is not ported (only its "
                    f"default {UNPORTED_DEFAULTS[k]!r} runs)"
                )
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown plan fields {sorted(unknown)}")
        return cls(weights=tuple(ws), **d)

    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(self.to_json_dict(), indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "PrecisionPlan":
        return cls.from_json_dict(json.loads(text))

    # -- builder sugar ---------------------------------------------------
    @classmethod
    def build(
        cls,
        num_groups: int = 1,
        round_to: int = 4,
        *,
        mode: str = "truncate",
        impl: str = "auto",
        act_round_to: int = 4,
        act_mode: str = "nearest",
        schedule: str = "static",
        awp_threshold: float = -2e-3,
        awp_interval: int = 100,
        awp_initial_bits: int = 8,
    ) -> "PrecisionPlan":
        """The CLI flag → plan builder the launcher uses (the reference's
        ``build`` restricted to the flags of the CNN path)."""
        activations = None
        if act_round_to < FP32_BYTES:
            activations = CompressionPolicy(
                round_to=int(act_round_to),
                grad_round_to=int(act_round_to),
                mode=act_mode,
                grad_mode=act_mode,
                impl=impl,
            )
        return cls(
            weights=(CompressionPolicy(
                round_to=int(round_to), mode=mode, impl=impl
            ),) * num_groups,
            activations=activations,
            schedule=Schedule(
                source=schedule,
                awp_threshold=awp_threshold,
                awp_interval=awp_interval,
                awp_initial_bits=awp_initial_bits,
            ),
        )
