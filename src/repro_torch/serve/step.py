"""Serving steps: prefill (build caches) and one-token decode (counterpart
of ``repro.serve.step``), on one device or on an FSDP×TP mesh of ranks.

Weights move through the same ADT transfer as in training: every step
materializes each ``DIST`` leaf through Bitpack and Bitunpack at its
group's width (on a mesh the rank's TP slice, gathered as planes over its
FSDP group), unless the decode step is weight-stationary, where
:func:`make_place_step` ran that transfer once. A
:class:`~repro_torch.plan.PrecisionPlan` drives every precision choice:
the weight entries, the ``activations`` / ``seq_boundary`` policies of the
TP-region collectives, ``seq_parallel`` for prefill (decode keeps the
psum layout) and ``int8_kv``, the caches' int8 KV with per-(slot, local
kv head) scales. Serving is deterministic, so a plan whose forward
weight path rounds stochastically is rejected (the plan itself refuses a
stochastic activation path). :func:`make_verify_step` is the decode step
at a ``(slots, spec_k + 1)`` token block (speculative decoding), and a
``window_override`` gives decode a sliding window (a ring when the cache
capacity is at most the window).

PyTorch runs eagerly: a step is a plain function under ``torch.no_grad``.
On a mesh (each rank a process, ``mesh`` from
``launch.mesh.make_mesh_from_cfg``) a step is the reference's
``shard_map`` body on this rank: it takes the rank's rows of the batch
under ``shard_batch`` (``train.step.batch_rows``), runs the forward on its
heads and vocabulary slice with rank-local caches, and returns what the
reference's ``out_specs`` ``P(dp, None, model)`` assemble: the
vocabulary-sharded logits gathered over the model group along the
vocabulary in rank order, then over the FSDP group along the batch under
``shard_batch`` (the ``logits`` class), the global ``(B, 1, V)`` on every
rank. The caches stay the rank's own (:func:`init_serve_caches`).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import fp32_math
from repro_torch.configs.base import ModelConfig
from repro_torch.dist import comm
from repro_torch.dist.spec import MeshCfg, dist_elems_per_group, placed_leaf
from repro_torch.models import model as M
from repro_torch.launch.mesh import fsdp_group
from repro_torch.models.env import Env
from repro_torch.plan import PrecisionPlan
from repro_torch.train.step import (
    batch_rows,
    check_mesh,
    check_seq_parallel,
    layer_boundaries,
    make_mat_fns,
    resolve_plan,
)
from repro_torch.transport import CompressionPolicy
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


def _sharded_rows(mesh_cfg: MeshCfg, shard_batch: bool, paged: bool = False) -> bool:
    """Whether a serve batch's rows are split over the data ranks (else the
    batch is whole on every rank). A page pool is slot-global: every rank
    must see every page, so a paged layout never shards the batch."""
    if mesh_cfg.dshards <= 1 or not shard_batch:
        return False
    if paged:
        raise ValueError("paged caches cannot shard the batch dim: the page pool is "
                         "slot-global")
    return True


def init_serve_caches(
    cfg: ModelConfig,
    mesh_cfg: MeshCfg,
    batch: int,
    capacity: int,
    dtype=torch.float32,
    *,
    shard_batch: bool = True,
    per_slot: bool = False,
    int8_kv: bool = False,
    paged_pages: int | None = None,
    page_size: int | None = None,
    device="cpu",
):
    """Zeroed caches of one rank of the mesh (the counterpart of the
    reference's ``cache_pspecs``: its ``heads_local`` kv heads, the
    recurrent states' rank-local widths — the mLSTM's ``C`` split on its
    value dim, the RG-LRU's channels, the sLSTM's state whole — and its
    ``batch / dshards`` rows when the batch is sharded; a page pool keeps
    every slot). ``int8_kv`` gives int8 KV leaves with fp32 scales per
    (slot or page row, position, local kv head); recurrent states and the
    cross blocks' image KV (``num_image_tokens`` rows of local kv heads, a
    scalar ``pos``) keep ``dtype``. ``paged_pages`` +
    ``page_size`` select ``model.init_paged_caches`` (``capacity`` is then
    not read)."""
    paged = paged_pages is not None
    if _sharded_rows(mesh_cfg, shard_batch, paged):
        if batch % mesh_cfg.dshards:
            raise ValueError(f"batch of {batch} does not split over {mesh_cfg.dshards} "
                             "FSDP ranks")
        batch //= mesh_cfg.dshards
    kv_l = kv_heads_of(cfg, mesh_cfg, 0)[1]
    env = Env(int8_kv=int8_kv)
    if paged:
        return M.init_paged_caches(cfg, env, batch, paged_pages, page_size, dtype,
                                   device=device, kv_heads=kv_l, tp=mesh_cfg.tp)
    return M.init_caches(cfg, env, batch, capacity, dtype, per_slot=per_slot,
                         device=device, kv_heads=kv_l, tp=mesh_cfg.tp)


def kv_heads_of(cfg: ModelConfig, mesh_cfg: MeshCfg, model_rank: int) -> tuple[int, int]:
    """``(first, count)`` of the global kv heads model rank ``model_rank``
    holds in its caches: ``count = max(1, Kv // tp)`` (``Env.heads_local``)
    from ``model_rank · Kv // tp`` on, one head replicated over ``tp / Kv``
    ranks where ``Kv < tp`` (the ``wk`` / ``wv`` slices of
    ``ParamMeta.tp_slice_index``)."""
    Kv, tp = cfg.num_kv_heads, mesh_cfg.tp
    return model_rank * Kv // tp, max(1, Kv // tp)


def global_cache_shapes(cfg: ModelConfig, mesh_cfg: MeshCfg, batch: int, capacity: int,
                        dtype=torch.float32, **kw):
    """The decode step's cache tree as ``meta`` tensors (shapes and dtypes,
    no allocation): the counterpart of the reference's
    ``ShapeDtypeStruct`` tree, as one rank holds it (the reference's global
    shapes divided along the dims its ``cache_pspecs`` maps to the model
    and data axes). Keywords as :func:`init_serve_caches`."""
    return init_serve_caches(cfg, mesh_cfg, batch, capacity, dtype, device="meta", **kw)


def _gather_logits(logits, env: Env, mesh_cfg: MeshCfg, shard_batch: bool):
    """The rank's ``(B_local, 1, V / tp)`` logits -> the global ``(B, 1, V)``
    (the reference's ``out_specs`` ``P(dp, None, model)``), equal on every
    rank."""
    if env.model_group is not None:
        logits = comm.all_gather(logits, env.model_group, axis=-1, traffic="logits")
    if _sharded_rows(mesh_cfg, shard_batch):
        logits = comm.all_gather(logits, env.fsdp_group, axis=0, traffic="logits")
    return logits


def _step_parts(cfg, mesh_cfg, mesh, spec_tree, plan, caller, placed=False):
    plan = _serve_plan(cfg, plan, caller=caller)
    check_mesh(mesh_cfg, mesh, caller)
    fp32_math()
    env = plan.make_env(mesh_cfg, mesh)
    mat_group, mat_top_factory = make_mat_fns(
        spec_tree, mesh_cfg, plan.weight_policies(), plan.compute_dtype, placed=placed,
        group=env.fsdp_group,
    )
    return env, mat_group, mat_top_factory


def make_prefill_step(
    cfg: ModelConfig,
    mesh_cfg: MeshCfg,
    mesh,
    spec_tree,
    *,
    plan: PrecisionPlan | None = None,
    cache_capacity: int,
    shard_batch: bool = True,
    window_override=None,
):
    """``step(storage, batch) -> (last-token logits (B, 1, V), caches)``;
    ``storage`` is the rank's blocks, the caches its own. Under the plan's
    ``seq_parallel`` at ``tp > 1`` the prompt length must split over the
    model group (``ValueError``). ``window_override`` reaches only the
    caches' geometry check (a prompt longer than the capacity rings), as in
    the reference."""
    env, mat_group, mat_top_factory = _step_parts(
        cfg, mesh_cfg, mesh, spec_tree, plan, "make_prefill_step")

    @torch.no_grad()
    def step(storage, batch):
        if env.seq_parallel_active:
            check_seq_parallel({"tokens": tuple(batch["tokens"].shape)}, mesh_cfg)
        batch = batch_rows(batch, mesh_cfg, env.fsdp_group, shard_batch)
        logits, caches = M.forward_prefill(
            storage, batch, cfg, env,
            mat_group=mat_group, mat_top=mat_top_factory(storage),
            cache_capacity=cache_capacity, window_override=window_override,
        )
        return _gather_logits(logits, env, mesh_cfg, shard_batch), caches

    return step


def make_place_step(
    cfg: ModelConfig,
    mesh_cfg: MeshCfg,
    mesh,
    spec_tree,
    *,
    plan: PrecisionPlan | None = None,
):
    """Weight-stationary serving: run every ADT transfer ONCE (on a mesh the
    FSDP gather of every ``DIST`` leaf's TP slice), giving the rank's
    resident weights; decode steps built with ``weight_stationary=True``
    then move no weights. Returns ``place_fn`` (the reference also returns
    the placed partition specs: here every rank holds its own)."""
    plan = _serve_plan(cfg, plan, caller="make_place_step")
    check_mesh(mesh_cfg, mesh, "make_place_step")
    policies = plan.weight_policies()
    group = fsdp_group(mesh)

    def leaf(x, s, pol):
        return placed_leaf(x, s, mesh_cfg, pol, group=group)

    @torch.no_grad()
    def place(storage):
        groups = [
            tree_map(lambda x, s, g=g: leaf(x, s, policies[g]), gp, gs)
            for g, (gp, gs) in enumerate(zip(storage["groups"], spec_tree["groups"]))
        ]
        top = {k: leaf(storage[k], spec_tree[k], policies[-1])
               for k in storage if k != "groups"}
        return {"groups": groups, **top}

    return place


def make_decode_step(
    cfg: ModelConfig,
    mesh_cfg: MeshCfg,
    mesh,
    spec_tree,
    *,
    plan: PrecisionPlan | None = None,
    shard_batch: bool = True,
    window_override=None,
    weight_stationary: bool = False,
    paged: bool = False,
):
    """``step(weights, caches, batch) -> (logits (B, T, V), caches')``;
    ``weights`` is the storage tree, or the placed tree when
    ``weight_stationary``. Per-slot positions (the engine's slotted
    caches) are read from the caches' ``pos`` and the batch's ``pos``.
    ``paged=True`` is the step over ``init_paged_caches`` pools, whose
    batches carry ``page_table`` (B, n_pages) int32; a batch that does not
    match the layout raises. The plan's ``seq_parallel`` does not apply:
    one token has no sequence to split (``model.forward_decode``)."""
    _sharded_rows(mesh_cfg, shard_batch, paged)  # refuses a paged, row-sharded step
    env, mat_group, mat_top_factory = _step_parts(
        cfg, mesh_cfg, mesh, spec_tree, plan, "make_decode_step", placed=weight_stationary)

    @torch.no_grad()
    def step(weights, caches, batch):
        if paged != (batch.get("page_table") is not None):
            raise ValueError(
                f"make_decode_step(paged={paged}): the batch "
                f"{'lacks' if paged else 'carries'} a page_table"
            )
        batch = batch_rows(batch, mesh_cfg, env.fsdp_group, shard_batch)
        logits, caches = M.forward_decode(
            weights, batch, caches, cfg, env,
            mat_group=mat_group, mat_top=mat_top_factory(weights),
            window_override=window_override,
        )
        return _gather_logits(logits, env, mesh_cfg, shard_batch), caches

    return step


def make_verify_step(
    cfg: ModelConfig,
    mesh_cfg: MeshCfg,
    mesh,
    spec_tree,
    *,
    plan: PrecisionPlan | None = None,
    shard_batch: bool = True,
    weight_stationary: bool = False,
    paged: bool = False,
):
    """The k-token verify variant of the decode step (speculative
    decoding): the same step over per-slot caches, fed ``tokens (slots,
    spec_k + 1)`` — the carried last-emitted token plus the draft's k
    proposals — so that one batched target forward scores them all. Block
    position j is written at ``pos + j`` (models/attention.py); the engine
    rolls back rejected positions by re-stamping ``pos``
    (:func:`repro_torch.serve.spec.rollback_caches`). PyTorch runs
    eagerly, so the reference's compile-time ``n_slots`` / ``block`` /
    ``table_width`` are the batch's shapes here."""
    return make_decode_step(cfg, mesh_cfg, mesh, spec_tree, plan=plan,
                            shard_batch=shard_batch, weight_stationary=weight_stationary,
                            paged=paged)


def serve_wire_table(plan: PrecisionPlan, cfg: ModelConfig, spec_tree, mesh_cfg: MeshCfg,
                     *, rows: int, tokens: int, gathers: bool = True,
                     seq_parallel: bool = False) -> dict:
    """Per-class wire bytes of one serve forward on a rank (a prefill of
    ``tokens`` tokens, or a decode step at ``tokens=1``) over ``rows`` of
    the batch on that rank: the plan's
    :meth:`~repro_torch.plan.PrecisionPlan.wire_table` without gradients,
    whose weight gathers are dropped when ``gathers`` is false (a
    weight-stationary decode step; the placement is one forward's
    gathers), with one forward's TP-region exits (the embedding's, and
    each layer's block and mixer exits, ``train.step.layer_boundaries``;
    an sLSTM has none), at ``act elems = rows · tokens · d``.
    Under the sequence-parallel layout of a prefill the embedding's and
    every block's exit is a scatter and every block's enter a gather; the
    logits entry takes the last token through the lossless merge instead
    (``relayout``). In each collective class the log
    (``comm.wire_by_traffic``) must equal it; ``host_device`` is the
    plan's staging model, not a collective."""
    nrt = cfg.num_groups + 1
    n, tp = mesh_cfg.dshards, mesh_cfg.tp
    plan = dataclasses.replace(plan, seq_parallel=False)  # the layout is the argument's
    elems = dist_elems_per_group(spec_tree, mesh_cfg, nrt)
    if not gathers:
        elems = [0] * nrt
    exits = 1 + layer_boundaries(cfg)[0]
    act_elems = rows * tokens * cfg.d_model if tp > 1 else 0
    table = plan.wire_table(elems, n, training=False, tp=tp, act_elems=act_elems,
                            act_collectives=0 if seq_parallel else exits)
    if seq_parallel and act_elems:
        seq = plan.seq_policy() or CompressionPolicy()
        table["seq_boundary"] = (exits * seq.seq_scatter_wire_bytes(act_elems, tp)
                                 + (exits - 1) * seq.seq_gather_wire_bytes(act_elems, tp))
        table["total"] += table["seq_boundary"]
    return table
