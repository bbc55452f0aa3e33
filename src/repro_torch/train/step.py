"""Dense LM train step on one device, and the step-factory helpers the
serve steps share with it (counterpart of ``repro.train.step``).

:func:`make_train_step` is the reference's single-device branch
(``mesh is None``): the loss and its gradient over weights materialized
through the straight-through ADT quantize (Bitpack/Bitunpack in the CUDA
kernels for CUDA tensors), momentum SGD with the weight-decay mask, then
the AWP monitor :func:`awp_group_norms` on the updated masters (the
``l2norm_sq`` kernel for CUDA tensors). PyTorch runs eagerly, so the
jitted step becomes a plain function that updates storage and momentum in
place; the trainer caches one per format tuple.

Not ported, each raising ``NotImplementedError``: a mesh other than the
trivial one (FSDP×TP, the gradient reductions), stochastic rounding
(``plan.needs_rng``, the step's PRNG key) and gradient accumulation (the
port's plan has no ``accum_steps`` other than 1).
"""
from __future__ import annotations

import torch

from repro_torch import fp32_math
from repro_torch.dist.spec import (
    DIST,
    MeshCfg,
    materialize_leaf,
    materialize_placed_leaf,
)
from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.optim.sgd import SGDConfig, sgd_update
from repro_torch.plan import PrecisionPlan
from repro_torch.transport import policy_for
from repro_torch.utils.trees import tree_leaves, tree_map


def resolve_plan(
    cfg,
    *,
    plan: PrecisionPlan | None,
    caller: str = "step factory",
    num_groups: int | None = None,
) -> PrecisionPlan:
    """One validation point for the required ``plan=`` argument of the
    step factories: type-check and broadcast to the architecture's group
    count (``cfg.num_groups + 1`` for an LM: the last entry covers the
    embedding and head)."""
    if plan is None:
        raise TypeError(f"{caller}: needs plan= (a repro_torch.plan.PrecisionPlan)")
    if not isinstance(plan, PrecisionPlan):
        raise TypeError(f"{caller}: plan must be a PrecisionPlan")
    n = num_groups if num_groups is not None else cfg.num_groups + 1
    return plan.broadcast(n)


def make_mat_fns(spec_tree, mesh_cfg: MeshCfg, round_tos, dtype=torch.float32,
                 placed: bool = False):
    """``(mat_group, mat_top_factory)`` shared by the train and serve steps.

    ``mat_group(g, key, storage)`` materializes one layer repetition of
    group ``g`` (``storage`` without the repetition dim) at the group's
    policy; ``mat_top_factory(storage)(name)`` a top-level leaf at the
    last policy. ``round_tos`` entries are ints or policies (a plan
    passes ``plan.weight_policies()``). Materialized weights are cast to
    the compute dtype; the fp32 masters stay in storage. ``placed=True``
    consumes resident weights (weight-stationary serving)."""
    policies = tuple(policy_for(rt) for rt in round_tos)

    def _cast(x):
        return x.to(dtype) if x.dtype == torch.float32 else x

    def _mat(x, s, pol):
        if placed:
            return _cast(materialize_placed_leaf(x, s, mesh_cfg))
        return _cast(materialize_leaf(x, s, mesh_cfg, pol))

    def mat_group(g, key, storage):
        pol = policies[g]
        return tree_map(lambda x, s: _mat(x, s, pol), storage, spec_tree["groups"][g][key])

    def mat_top_factory(storage):
        pol = policies[-1]

        def mat_top(name):
            return _mat(storage[name], spec_tree[name], pol)

        return mat_top

    return mat_group, mat_top_factory


def _require_one_device(mesh, mesh_cfg: MeshCfg, what: str) -> None:
    if mesh is not None or not mesh_cfg.trivial:
        raise NotImplementedError(
            f"{what}: only the single-device path is ported (mesh None, "
            f"tp=1, dshards=1; got tp={mesh_cfg.tp}, dshards={mesh_cfg.dshards})"
        )


def build_wd_mask(spec_tree):
    """1.0 for matrices (compressible), 0.0 for norms/biases/gates."""
    return tree_map(lambda s: 1.0 if s.meta.compress else 0.0, spec_tree)


def awp_group_norms(storage, spec_tree, mesh_cfg: MeshCfg) -> torch.Tensor:
    """Per-precision-group Σw² of the compressed (``DIST``) weights, with
    replication factors divided out: ``(num_groups + 1,)`` fp32, the last
    entry over the top-level leaves. One ``ops.l2norm_sq`` per ``DIST``
    leaf (the kernel on a CUDA tensor); the sums are taken on the device
    in a fixed leaf order, with no host sync."""
    _require_one_device(None, mesh_cfg, "awp_group_norms")
    top = [k for k in storage if k != "groups"]
    dev = storage[top[0]].device

    @torch.no_grad()
    def subtree_sum(xs, specs):
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for x, s in zip(xs, specs):
            if s.kind == DIST:
                total = total + ops.l2norm_sq(x) / s.repl_factor
        return total

    norms = [
        subtree_sum(tree_leaves(gp), tree_leaves(gs))
        for gp, gs in zip(storage["groups"], spec_tree["groups"])
    ]
    norms.append(subtree_sum([storage[k] for k in top], [spec_tree[k] for k in top]))
    return torch.stack(norms)


def _split_reps(tree, spec_tree, leaf_fn):
    """The LM tree with each stacked ``(R, ...)`` group leaf as a list of
    its ``R`` per-repetition views (through ``leaf_fn``): every
    repetition's gradient is then a tensor of its own, not a full-size
    zero-filled one per repetition."""
    groups = [
        tree_map(lambda x, s: [leaf_fn(x[r]) for r in range(s.reps)], g, gs)
        for g, gs in zip(tree["groups"], spec_tree["groups"])
    ]
    top = {k: leaf_fn(v) for k, v in tree.items() if k != "groups"}
    return {"groups": groups, **top}


def make_train_step(
    cfg,
    mesh_cfg: MeshCfg,
    mesh,
    spec_tree,
    opt_cfg: SGDConfig | None = None,
    batch_shapes: dict | None = None,
    *,
    plan: PrecisionPlan | None = None,
):
    """Returns ``step(storage, momentum, batch, lr) -> (storage, momentum,
    metrics)`` with ``metrics = {"loss", "token_count",
    "group_norms_sq"}`` (0-d, 0-d and ``(num_groups + 1,)`` tensors on the
    storage's device). ``batch`` holds ``tokens`` and ``labels``, ``(B,
    S)`` integer tensors; the loss is the summed NLL over ``B * S`` (the
    reference's static token count). Storage and momentum are updated in
    place and returned.

    Call as the reference is called::

        make_train_step(cfg, mesh_cfg, None, spec_tree, opt_cfg,
                        batch_shapes, plan=plan)

    ``batch_shapes`` is only checked for presence: nothing is traced."""
    if opt_cfg is None or batch_shapes is None:
        raise TypeError("make_train_step: opt_cfg and batch_shapes required")
    _require_one_device(mesh, mesh_cfg, "make_train_step")
    plan = resolve_plan(cfg, plan=plan, caller="make_train_step")
    if plan.needs_rng:
        raise NotImplementedError(
            "stochastic rounding is not ported yet (needs a bit-exact "
            "jax.random.randint and the step's PRNG key)"
        )
    fp32_math()
    env = plan.make_env(mesh_cfg)
    mat_group, mat_top_factory = make_mat_fns(
        spec_tree, mesh_cfg, plan.weight_policies(), plan.compute_dtype
    )
    # one weight-decay flag per leaf of _split_reps' trees (per repetition)
    wd = [w for w, s in zip(tree_leaves(build_wd_mask(spec_tree)), tree_leaves(spec_tree))
          for _ in range(s.reps)]

    def step(storage, momentum, batch, lr):
        B, S = batch["labels"].shape
        live = _split_reps(storage, spec_tree, lambda t: t.detach().requires_grad_(True))
        nll_sum, metrics = M.forward_loss(
            live, batch, cfg, env, mat_group=mat_group, mat_top=mat_top_factory(live)
        )
        loss = nll_sum / float(B * S)
        grads = torch.autograd.grad(loss, tree_leaves(live))
        del live
        sgd_update(
            tree_leaves(_split_reps(storage, spec_tree, lambda t: t)), list(grads),
            tree_leaves(_split_reps(momentum, spec_tree, lambda t: t)), wd, opt_cfg, lr,
        )
        del grads
        norms = awp_group_norms(storage, spec_tree, mesh_cfg)
        return storage, momentum, {
            "loss": loss.detach(),
            "token_count": metrics["token_count"].detach(),
            "group_norms_sq": norms,
        }

    return step
