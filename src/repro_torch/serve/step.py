"""Serving steps: prefill (build caches) and one-token decode (counterpart
of ``repro.serve.step``, the trivial mesh).

Weights move through the same ADT transfer as in training: every step
materializes each ``DIST`` leaf through Bitpack and Bitunpack at its
group's width, unless the decode step is weight-stationary, where
:func:`make_place_step` ran that transfer once. A
:class:`~repro_torch.plan.PrecisionPlan` drives every precision choice.
Serving is deterministic, so a plan whose forward weight path rounds
stochastically is rejected.

PyTorch runs eagerly: a step is a plain function under ``torch.no_grad``
(the reference jits it against ``batch_shapes``, which the port therefore
does not take), and the reference's ``mesh`` argument must be ``None``
(one device; the ``shard_map`` counterpart comes with the sharded
slices).
"""
from __future__ import annotations

import torch

from repro_torch import fp32_math
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.spec import MeshCfg, placed_leaf
from repro_torch.models import model as M
from repro_torch.models.env import Env
from repro_torch.plan import PrecisionPlan
from repro_torch.train.step import make_mat_fns, resolve_plan
from repro_torch.transport.policy import FP32_BYTES
from repro_torch.utils.trees import tree_map


def _serve_plan(cfg, plan, *, caller):
    """Shared plan validation: required plan=, group broadcast, and the
    deterministic-forward constraint."""
    plan = resolve_plan(cfg, plan=plan, caller=caller)
    for pol in plan.weight_policies():
        if pol.mode == "stochastic" and pol.round_to < FP32_BYTES:
            raise ValueError(
                f"{caller}: stochastic forward rounding is not supported "
                "in serving steps (deterministic, no PRNG key); use "
                "mode='nearest'"
            )
    return plan


def _one_device(mesh, mesh_cfg: MeshCfg, caller: str):
    if mesh is not None or not mesh_cfg.trivial:
        raise NotImplementedError(
            f"{caller}: only one device is ported (mesh=None, trivial MeshCfg; serving "
            "at tp > 1 is ROADMAP Queue 1 item 7.1)"
        )


def global_cache_shapes(
    cfg: ModelConfig,
    mesh_cfg: MeshCfg,
    batch: int,
    capacity: int,
    dtype=torch.float32,
    *,
    per_slot: bool = False,
    paged_pages: int | None = None,
    page_size: int | None = None,
):
    """The decode step's cache tree as ``meta`` tensors (shapes and dtypes,
    no allocation): the counterpart of the reference's
    ``ShapeDtypeStruct`` tree. ``paged_pages`` + ``page_size`` select
    ``model.init_paged_caches`` (``capacity`` is then not read)."""
    _one_device(None, mesh_cfg, "global_cache_shapes")
    env = Env(tp=mesh_cfg.tp)
    if paged_pages is not None:
        return M.init_paged_caches(cfg, env, batch, paged_pages, page_size, dtype,
                                   device="meta")
    return M.init_caches(cfg, env, batch, capacity, dtype, per_slot=per_slot,
                         device="meta")


def make_prefill_step(
    cfg: ModelConfig,
    mesh_cfg: MeshCfg,
    mesh,
    spec_tree,
    *,
    plan: PrecisionPlan | None = None,
    cache_capacity: int,
):
    """``step(storage, batch) -> (last-token logits, caches)``."""
    plan = _serve_plan(cfg, plan, caller="make_prefill_step")
    _one_device(mesh, mesh_cfg, "make_prefill_step")
    fp32_math()
    env = plan.make_env(mesh_cfg)
    mat_group, mat_top_factory = make_mat_fns(
        spec_tree, mesh_cfg, plan.weight_policies(), plan.compute_dtype
    )

    @torch.no_grad()
    def step(storage, batch):
        return M.forward_prefill(
            storage, batch, cfg, env,
            mat_group=mat_group, mat_top=mat_top_factory(storage),
            cache_capacity=cache_capacity,
        )

    return step


def make_place_step(
    cfg: ModelConfig,
    mesh_cfg: MeshCfg,
    mesh,
    spec_tree,
    *,
    plan: PrecisionPlan | None = None,
):
    """Weight-stationary serving: run every ADT transfer ONCE, giving
    resident weights; decode steps built with ``weight_stationary=True``
    then move no weights. Returns ``place_fn`` (the reference also returns
    the placed partition specs, which one device does not have)."""
    plan = _serve_plan(cfg, plan, caller="make_place_step")
    _one_device(mesh, mesh_cfg, "make_place_step")
    policies = plan.weight_policies()

    @torch.no_grad()
    def place(storage):
        groups = [
            tree_map(lambda x, s, g=g: placed_leaf(x, s, mesh_cfg, policies[g]), gp, gs)
            for g, (gp, gs) in enumerate(zip(storage["groups"], spec_tree["groups"]))
        ]
        top = {
            k: placed_leaf(storage[k], spec_tree[k], mesh_cfg, policies[-1])
            for k in storage if k != "groups"
        }
        return {"groups": groups, **top}

    return place


def make_decode_step(
    cfg: ModelConfig,
    mesh_cfg: MeshCfg,
    mesh,
    spec_tree,
    *,
    plan: PrecisionPlan | None = None,
    weight_stationary: bool = False,
    paged: bool = False,
):
    """``step(weights, caches, batch) -> (logits, caches')``; ``weights``
    is the storage tree, or the placed tree when ``weight_stationary``.
    Per-slot positions (the engine's slotted caches) are read from the
    caches' ``pos`` and the batch's ``pos``. ``paged=True`` is the step over
    ``init_paged_caches`` pools, whose batches carry ``page_table``
    (B, n_pages) int32; a batch that does not match the layout raises."""
    plan = _serve_plan(cfg, plan, caller="make_decode_step")
    _one_device(mesh, mesh_cfg, "make_decode_step")
    fp32_math()
    env = plan.make_env(mesh_cfg)
    mat_group, mat_top_factory = make_mat_fns(
        spec_tree, mesh_cfg, plan.weight_policies(), plan.compute_dtype,
        placed=weight_stationary,
    )

    @torch.no_grad()
    def step(weights, caches, batch):
        if paged != (batch.get("page_table") is not None):
            raise ValueError(
                f"make_decode_step(paged={paged}): the batch "
                f"{'lacks' if paged else 'carries'} a page_table"
            )
        return M.forward_decode(
            weights, batch, caches, cfg, env,
            mat_group=mat_group, mat_top=mat_top_factory(weights),
        )

    return step
