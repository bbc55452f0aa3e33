"""PrecisionPlan — the declarative precision plan (counterpart of
``repro.plan.plan``, the subset the training and serving paths use).

A plan holds one :class:`~repro_torch.transport.CompressionPolicy` per
weight precision group, an optional ``gradients`` policy (the backward
reduce-scatter's format, folded into the weight policies' grad fields), an
optional ``activations`` policy (the LM's TP-region all-reduces; the
CNN's stage-boundary quantize), an optional ``seq_boundary`` policy (the
sequence-parallel gather / scatter pair; defaults to ``activations``), an
optional ``host_device`` policy (the serve engine's token staging and
training ingest's; defaults to the weight entries), the fleet fabric's
``kv_migration`` (prefill->decode KV page parcels; defaults to the
``host_device`` chain) and ``weight_publish`` (trainer->replica weight
parcels; defaults to the first weights entry) policies, the execution layout (``seq_parallel``,
``chunks`` — the weight gather's plane blocks — ``dtype``, the compute
dtype ``f32`` or ``bf16``, ``int8_kv``, the serve caches' int8 KV,
``accum_steps``, the train step's micro-batches, and ``env_overrides``,
the ``Env`` knobs ``attn_chunk``, ``causal_skip`` and ``mlstm_chunk``), the serving defaults (``sampling``, a
:class:`SamplingParams`; ``spec_draft`` and ``spec_k``, the speculative
engine's draft name and proposals a round) and a schedule source
(``static`` — the paper's oracle — or ``awp``, with Algorithm 1's
hyper-parameters). :meth:`PrecisionPlan.wire_table` is the per-entry
byte account of one step, from the policy formulas.

Plan JSON loads across packages: :meth:`PrecisionPlan.to_json_dict`
writes the reference's layout byte for byte, and each package loads the
other's files. :func:`policy_uses_rng` is the one rule for which
materialization sites take a stochastic-rounding key.

Invalid plans raise :class:`ValueError` at construction.
"""
from __future__ import annotations

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
VALID_DTYPES = ("f32", "bf16")
_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# Env knobs a plan may override (the reference's list)
ENV_OVERRIDE_KEYS = ("attn_chunk", "causal_skip", "mlstm_chunk")


def policy_uses_rng(p: CompressionPolicy) -> bool:
    """True when materializing or synchronizing under this policy packs
    planes with stochastic rounding *at its current widths* (which needs a
    PRNG key): the rule by which the step factories hand a materialization
    site a key."""
    return (p.mode == "stochastic" and p.round_to < FP32_BYTES) or (
        p.grad_mode == "stochastic" and p.grad_round_to < FP32_BYTES
    )


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling contract (the serve engine's PRNG surface).

    ``temperature == 0`` is greedy: the engine's argmax path. A positive
    temperature samples from the temperature-scaled softmax restricted to
    the ``top_k`` highest-probability ids (0 = all) and the smallest prefix
    of the sorted distribution whose *preceding* cumulative mass stays
    below ``top_p`` (:func:`repro_torch.serve.sampling.sample_tokens`).

    Determinism: the id sampled for the n-th emitted token of a request
    (0-based; the prefill's token is n = 0) is a function of ``(logits,
    seed, n)`` alone, under the key ``fold_in(PRNGKey(seed), n)`` with the
    seed taken as a uint32, as the reference takes it."""

    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = 0
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "temperature", float(self.temperature))
        object.__setattr__(self, "top_p", float(self.top_p))
        if self.temperature < 0.0:
            raise ValueError("temperature must be >= 0")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        if not isinstance(self.top_k, int) or self.top_k < 0:
            raise ValueError("top_k must be an int >= 0")
        if not isinstance(self.seed, int) or self.seed < 0:
            raise ValueError("seed must be a non-negative int")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


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
    gradients: CompressionPolicy | None = None
    activations: CompressionPolicy | None = None
    seq_boundary: CompressionPolicy | None = None
    host_device: CompressionPolicy | None = None
    kv_migration: CompressionPolicy | None = None
    weight_publish: CompressionPolicy | None = None
    schedule: Schedule = dataclasses.field(default_factory=Schedule)
    seq_parallel: bool = False
    chunks: int = 1
    dtype: str = "f32"
    int8_kv: bool = False
    accum_steps: int = 1
    env_overrides: tuple[tuple[str, object], ...] = ()
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    spec_draft: str = ""
    spec_k: int = 4

    def __post_init__(self):
        ws = self.weights
        if isinstance(ws, CompressionPolicy):
            ws = (ws,)
        ws = tuple(_coerce_policy(w) for w in ws)
        if not ws or any(w is None for w in ws):
            raise ValueError("plan needs at least one weights entry")
        object.__setattr__(self, "weights", ws)
        for name in ("gradients", "activations", "seq_boundary", "host_device",
                     "kv_migration", "weight_publish"):
            object.__setattr__(self, name, _coerce_policy(getattr(self, name)))
        if isinstance(self.schedule, Mapping):
            object.__setattr__(self, "schedule", Schedule(**self.schedule))
        if not isinstance(self.schedule, Schedule):
            raise ValueError("schedule must be a Schedule")
        if not isinstance(self.chunks, int) or self.chunks < 1:
            raise ValueError("chunks must be an int >= 1")
        if self.dtype not in VALID_DTYPES:
            raise ValueError(f"dtype must be in {VALID_DTYPES}")
        if not isinstance(self.accum_steps, int) or self.accum_steps < 1:
            raise ValueError("accum_steps must be an int >= 1")
        if isinstance(self.sampling, Mapping):
            object.__setattr__(self, "sampling", SamplingParams(**self.sampling))
        if not isinstance(self.sampling, SamplingParams):
            raise ValueError("sampling must be a SamplingParams")
        if not isinstance(self.spec_draft, str):
            raise ValueError("spec_draft must be a draft name string")
        if not isinstance(self.spec_k, int) or self.spec_k < 1:
            raise ValueError("spec_k must be an int >= 1")
        if isinstance(self.env_overrides, Mapping):
            object.__setattr__(self, "env_overrides",
                               tuple(sorted(self.env_overrides.items())))
        object.__setattr__(self, "env_overrides",
                           tuple(tuple(kv) for kv in self.env_overrides))
        for k, _ in self.env_overrides:
            if k not in ENV_OVERRIDE_KEYS:
                raise ValueError(f"unknown env override {k!r} (allowed: {ENV_OVERRIDE_KEYS})")
        # activation-path stochastic rounding has no PRNG plumbing
        for name in ("activations", "seq_boundary"):
            a = getattr(self, name)
            if a is not None and "stochastic" in (a.mode, a.grad_mode):
                raise ValueError(
                    f"{name} policy cannot use stochastic rounding; "
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
        """The fully resolved per-group policies the transport runs: the
        weight entries with the ``gradients`` entry folded into their grad
        fields and the plan's ``chunks`` applied."""
        out = []
        for w in self.weights:
            if self.gradients is not None:
                w = dataclasses.replace(
                    w,
                    grad_round_to=self.gradients.round_to,
                    grad_mode=self.gradients.mode,
                )
            if self.chunks != w.chunks:
                w = dataclasses.replace(w, chunks=self.chunks)
            out.append(w)
        return tuple(out)

    def seq_policy(self) -> CompressionPolicy | None:
        """The sequence-parallel pair's policy: ``seq_boundary``, else
        ``activations``."""
        return self.seq_boundary if self.seq_boundary is not None else self.activations

    def host_device_policies(self) -> tuple[CompressionPolicy, ...]:
        """Policies of the host<->device boundary (the paper's weight
        staging model and the serve engine's token staging): the
        ``host_device`` entry for every group, else the weight entries."""
        if self.host_device is not None:
            return (self.host_device,) * len(self.weights)
        return self.weights

    def kv_migration_policy(self) -> CompressionPolicy:
        """The policy pricing prefill->decode KV page parcels on the fleet
        fabric: ``kv_migration``, else the ``host_device`` chain (migrated
        pages are staged bytes crossing a replica boundary)."""
        if self.kv_migration is not None:
            return self.kv_migration
        return self.host_device_policies()[0]

    def weight_publish_policy(self) -> CompressionPolicy:
        """The policy pricing trainer->replica weight parcels:
        ``weight_publish``, else the first weights entry (published planes
        ride the checkpoint tiers at the gathers' widths)."""
        if self.weight_publish is not None:
            return self.weight_publish
        return self.weights[0]

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def make_env(self, mesh_cfg, mesh=None):
        """Build the execution :class:`~repro_torch.models.env.Env`: the
        model and FSDP groups of ``mesh`` (``launch.mesh.make_mesh_from_cfg``'s;
        needed at ``tp > 1``), the activation and seq-boundary policies,
        the layout and the env overrides."""
        from repro_torch.launch.mesh import fsdp_group, model_group
        from repro_torch.models.env import Env

        return Env(
            model_group=model_group(mesh),
            fsdp_group=fsdp_group(mesh),
            tp=mesh_cfg.tp,
            dtype=self.compute_dtype,
            act_policy=self.activations,
            seq_policy=self.seq_boundary,
            seq_parallel=self.seq_parallel,
            int8_kv=self.int8_kv,
            **dict(self.env_overrides),
        )

    @property
    def needs_rng(self) -> bool:
        """True when a stochastic mode is configured on the weight path
        (the step would need a PRNG key). Width-independent on purpose,
        as in the reference: ``with_round_tos`` never flips it."""
        return any(
            "stochastic" in (p.mode, p.grad_mode) for p in self.weight_policies()
        )

    def awp_config(self) -> AWPConfig | None:
        if self.schedule.source != "awp":
            return None
        return self.schedule.awp_config()

    # -- per-entry wire accounting ---------------------------------------
    def wire_table(self, dist_elems_per_group, gather_axis_size: int = 1, *,
                   training: bool = True, tp: int = 1, act_elems: int = 0,
                   act_collectives: int = 0, act_bytes: int = FP32_BYTES) -> dict:
        """Per-traffic-class wire bytes of ONE step, from the policy
        formulas. The keys are the reference's; classes a step does not
        move report 0.

        ``dist_elems_per_group`` — global compressed element count per
        precision group (see ``repro_torch.train.cnn_step.cnn_dist_elems``).
        ``gather_axis_size`` — FSDP shards; ``<= 1`` selects the paper's
        host→device staging model (every ``DIST`` weight moved once at its
        group's width), ``> 1`` the per-device all-gather bytes of the
        weights (``all_gather_wire_bytes``) and, when ``training``, the
        reduce-scatter bytes of their gradients
        (``reduce_scatter_wire_bytes``).
        ``act_elems`` × ``act_collectives`` — gathered activation element
        count and number of TP-region boundaries a step (at ``tp > 1``):
        the ``seq_boundary`` row under ``seq_parallel`` (pairs,
        ``seq_pair_wire_bytes``), else the ``activations`` row
        (all-reduces, ``all_reduce_wire_bytes``); both at the policy's
        forward width, an uncompressed element at ``act_bytes`` (the
        compute dtype's width: 2 under bf16; the reference prices 4).
        """
        pols = self.weight_policies()
        elems = list(dist_elems_per_group)
        if len(elems) != len(pols):
            raise ValueError(
                f"{len(elems)} group element counts for "
                f"{len(pols)} weight entries"
            )
        n = int(gather_axis_size)
        table = {k: 0 for k in TRAFFIC_CLASSES}
        if n > 1:
            for pol, e in zip(pols, elems):
                table["weights"] += pol.all_gather_wire_bytes(e // n, n)
                if training:
                    table["gradients"] += pol.reduce_scatter_wire_bytes(e // n, n)
        else:
            for pol, e in zip(self.host_device_policies(), elems):
                table["host_device"] += pol.host_device_bytes(e)
        if act_collectives and act_elems and tp > 1:
            act = self.activations or CompressionPolicy()
            seq = self.seq_policy() or CompressionPolicy()
            if self.seq_parallel:
                table["seq_boundary"] = act_collectives * seq.seq_pair_wire_bytes(
                    act_elems, tp, uncompressed_bytes=act_bytes)
            else:
                table["activations"] = act_collectives * act.all_reduce_wire_bytes(
                    act_elems, tp, act_bytes)
        table["total"] = sum(table[k] for k in TRAFFIC_CLASSES)
        return table

    # -- serialization ---------------------------------------------------
    def to_json_dict(self) -> dict:
        """The reference's JSON layout, key for key and in its order."""
        def pol(p):
            return None if p is None else dataclasses.asdict(p)

        return {
            "version": 1,
            "weights": [pol(w) for w in self.weights],
            "gradients": pol(self.gradients),
            "activations": pol(self.activations),
            "seq_boundary": pol(self.seq_boundary),
            "host_device": pol(self.host_device),
            "kv_migration": pol(self.kv_migration),
            "weight_publish": pol(self.weight_publish),
            "schedule": dataclasses.asdict(self.schedule),
            "seq_parallel": self.seq_parallel,
            "chunks": self.chunks,
            "dtype": self.dtype,
            "int8_kv": self.int8_kv,
            "accum_steps": self.accum_steps,
            "env_overrides": dict(self.env_overrides),
            "sampling": dataclasses.asdict(self.sampling),
            "spec_draft": self.spec_draft,
            "spec_k": self.spec_k,
        }

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

    def to_file(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def from_file(cls, path: str) -> "PrecisionPlan":
        with open(path) as f:
            return cls.from_json(f.read())

    # -- builder sugar ---------------------------------------------------
    @classmethod
    def build(
        cls,
        num_groups: int = 1,
        round_to: int = 4,
        *,
        mode: str = "truncate",
        impl: str = "auto",
        grad_round_to: int | None = None,
        grad_mode: str = "nearest",
        act_round_to: int = 4,
        act_mode: str = "nearest",
        seq_parallel: bool = False,
        chunks: int = 1,
        dtype: str = "f32",
        int8_kv: bool = False,
        accum_steps: int = 1,
        schedule: str = "static",
        awp_threshold: float = -2e-3,
        awp_interval: int = 100,
        awp_initial_bits: int = 8,
        env_overrides=(),
    ) -> "PrecisionPlan":
        """The CLI flag → plan builder the launchers use: every knob maps
        onto exactly one plan field, as in the reference's."""
        gradients = None
        if grad_round_to is not None and (
            grad_round_to != 4 or grad_mode != "nearest"
        ):
            gradients = CompressionPolicy(
                round_to=int(grad_round_to), mode=grad_mode, impl=impl
            )
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
            gradients=gradients,
            activations=activations,
            seq_parallel=seq_parallel,
            chunks=chunks,
            dtype=dtype,
            int8_kv=int8_kv,
            accum_steps=accum_steps,
            env_overrides=env_overrides,
            schedule=Schedule(
                source=schedule,
                awp_threshold=awp_threshold,
                awp_interval=awp_interval,
                awp_initial_bits=awp_initial_bits,
            ),
        )
