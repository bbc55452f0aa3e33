"""Auditable (step, inputs) combos from the registry (counterpart of
``repro.audit.cases``): reduced configs, tiny shapes, the mesh from a
``DPxTP`` spec. Build a case inside :func:`~repro_torch.audit.record.recording`:
its storage, batch and caches are fake tensors of the rank's shapes, and
nothing is allocated.
"""
from __future__ import annotations

import dataclasses
import itertools

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.configs.registry import get_config, reduced
from repro_torch.configs.shapes import applicable, input_specs
from repro_torch.dist.spec import MeshCfg, build_spec_tree, leaf_to_local
from repro_torch.launch.train import parse_mesh  # noqa: F401  (the reference's name here)
from repro_torch.models.init import param_shapes
from repro_torch.optim.sgd import SGDConfig
from repro_torch.plan import PrecisionPlan
from repro_torch.utils.trees import tree_map

#: the plan points the acceptance sweep pins (AWP twice: the initial
#: 8-bit widths and a heterogeneous mid-run widening — per-group rt
#: 1/2/4 exercises mixed-format inventories in one run)
PLAN_NAMES = ("rt4", "rt2", "awp", "awp_widened")


def make_plan(name: str, num_entries: int, *, seq_parallel: bool = False) -> PrecisionPlan:
    """The reference's named plan points, broadcast to ``num_entries``."""
    if name == "rt4":
        plan = PrecisionPlan.build(1, round_to=4, seq_parallel=seq_parallel)
    elif name == "rt2":
        plan = PrecisionPlan.build(1, round_to=2, grad_round_to=2, act_round_to=2,
                                   seq_parallel=seq_parallel)
    elif name in ("awp", "awp_widened"):
        # awp_initial_bits=8 -> every group starts at rt=1; the widened
        # variant is a mid-run controller step (how the trainer rebuilds
        # the step)
        plan = PrecisionPlan.build(1, round_to=1, grad_round_to=2, act_round_to=2,
                                   schedule="awp", seq_parallel=seq_parallel)
        if name == "awp_widened":
            plan = plan.broadcast(num_entries).with_round_tos(
                tuple(itertools.islice(itertools.cycle((1, 2, 4)), num_entries)))
    else:
        raise ValueError(f"unknown plan name {name!r} (want {PLAN_NAMES})")
    return plan.broadcast(num_entries)


@dataclasses.dataclass
class AuditCase:
    """Everything ``audit_step`` needs for one registry combo."""

    arch: str
    kind: str
    mesh_cfg: MeshCfg
    mesh: object
    plan: PrecisionPlan
    spec_tree: dict
    step: object
    args: tuple


def _fake(spec: torch.Tensor) -> torch.Tensor:
    """A tensor of ``spec``'s shape and dtype (a fake one inside the recorder)."""
    return torch.zeros(spec.shape, dtype=spec.dtype)


def rank_storage(cfg: ModelConfig, mesh_cfg: MeshCfg, rank: int):
    """``(spec_tree, storage)``: the rank's storage blocks of ``cfg`` at
    ``mesh_cfg``, laid out from whole leaves of the logical shapes (fake
    tensors inside the recorder: their values are never read)."""
    shapes, metas = param_shapes(cfg, tp=mesh_cfg.tp)
    spec_tree = build_spec_tree(shapes, metas, mesh_cfg)
    storage = tree_map(lambda s, x: leaf_to_local(_fake(x), s, mesh_cfg, rank),
                       spec_tree, shapes)
    return spec_tree, storage


def build_case(arch: str, kind: str, mesh_cfg: MeshCfg, plan: PrecisionPlan, *, mesh,
               rank: int = 0, seq_len: int = 32, global_batch: int = 4,
               cfg: ModelConfig | None = None, window: int | None = None,
               weight_stationary: bool = False) -> AuditCase | None:
    """One auditable combo of the rank, or ``None`` where the combo does not
    apply (decode on an encoder-only arch). ``mesh`` is the recording's.
    A decode step takes ``window`` (a long-context window override) and
    ``weight_stationary`` (its storage placed first by the place step)."""
    from repro_torch.serve.step import (
        init_serve_caches, make_decode_step, make_place_step, make_prefill_step,
    )
    from repro_torch.train.step import make_train_step

    cfg = reduced(get_config(arch)) if cfg is None else cfg
    shape = InputShape(f"audit_{kind}", seq_len, global_batch,
                       "train" if kind == "place" else kind)
    if kind != "place" and not applicable(cfg, shape)[0]:
        return None
    plan = plan.broadcast(cfg.num_groups + 1)
    spec_tree, storage = rank_storage(cfg, mesh_cfg, rank)
    shard_batch = shape.global_batch >= mesh_cfg.dshards

    def case(step, args):
        return AuditCase(arch, kind, mesh_cfg, mesh, plan, spec_tree, step, args)

    if kind == "place":
        return case(make_place_step(cfg, mesh_cfg, mesh, spec_tree, plan=plan), (storage,))
    batch = {k: _fake(v) for k, v in input_specs(cfg, shape).items()}
    if kind == "train":
        step = make_train_step(cfg, mesh_cfg, mesh, spec_tree, SGDConfig(),
                               {k: tuple(v.shape) for k, v in batch.items()}, plan=plan)
        args = (storage, tree_map(torch.zeros_like, storage), batch, 0.1)
        if plan.needs_rng:
            from repro_torch.random import PRNGKey

            args += (PRNGKey(0),)
        return case(step, args)
    if kind == "prefill":
        return case(make_prefill_step(cfg, mesh_cfg, mesh, spec_tree, plan=plan,
                                      cache_capacity=shape.seq_len, shard_batch=shard_batch),
                    (storage, batch))
    if kind == "decode":
        capacity = min(shape.seq_len, window or shape.seq_len,
                       cfg.sliding_window or shape.seq_len)
        caches = init_serve_caches(cfg, mesh_cfg, shape.global_batch, capacity,
                                   plan.compute_dtype, shard_batch=shard_batch,
                                   int8_kv=plan.int8_kv, device="cpu")
        step = make_decode_step(cfg, mesh_cfg, mesh, spec_tree, plan=plan,
                                shard_batch=shard_batch, window_override=window,
                                weight_stationary=weight_stationary)
        if weight_stationary:
            storage = make_place_step(cfg, mesh_cfg, mesh, spec_tree, plan=plan)(storage)
        return case(step, (storage, caches, batch))
    raise ValueError(f"unknown kind {kind!r}")
