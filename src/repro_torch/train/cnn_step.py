"""CNN train step with per-layer ADT compression on one device (counterpart
of ``repro.train.cnn_step``): the paper's setting — fp32 master weights,
a byte-plane weight transfer every batch, uncompressed gradients,
per-layer AWP.

A :class:`~repro_torch.plan.PrecisionPlan` with ``num_groups`` weight
entries drives the per-layer formats and the activation policy (a
straight-through stage-boundary quantize). Each ``DIST`` weight is
materialized through :func:`~repro_torch.dist.spec.materialize_leaf`:
Bitpack and Bitunpack in the CUDA kernels for CUDA tensors, the plain
versions on the CPU.

PyTorch runs eagerly, so the reference's jitted step becomes a plain
function; the trainer caches one step per format tuple as the reference
caches compiled steps.
"""
from __future__ import annotations

import torch

from repro_torch import fp32_math
from repro_torch.dist.spec import (
    DIST,
    MeshCfg,
    build_leaf_spec,
    leaf_to_storage,
    materialize_leaf,
)
from repro_torch.models.cnn import CNNConfig, cnn_loss, topk_error
from repro_torch.optim.sgd import SGDConfig, sgd_update
from repro_torch.plan import PrecisionPlan
from repro_torch.train.step import resolve_plan
from repro_torch.transport import policy_for
from repro_torch.transport import transport as _T
from repro_torch.utils.trees import tree_leaves, tree_map


def _act_quant_fn(act_policy):
    """Activation policy -> straight-through stage-boundary truncation
    (None when the policy keeps fp32)."""
    if act_policy is None:
        return None
    pol = policy_for(act_policy)
    if not pol.compresses:
        return None

    def aq(x):
        return _T.quantize(x.to(torch.float32), pol).to(x.dtype)

    return aq


def build_cnn_spec_tree(params, metas, mesh_cfg: MeshCfg):
    return tree_map(
        lambda x, m: build_leaf_spec(x.shape, m, mesh_cfg, stacked=False),
        params, metas,
    )


def cnn_to_storage(params, spec_tree, mesh_cfg: MeshCfg):
    return tree_map(lambda x, s: leaf_to_storage(x, s, mesh_cfg), params, spec_tree)


def cnn_dist_elems(spec_tree, groups_info, mesh_cfg: MeshCfg) -> list[int]:
    """Compressed (``DIST``) element count per AWP group — the geometry
    ``PrecisionPlan.wire_table`` multiplies by each policy's width."""
    groups, num_groups = groups_info
    elems = [0] * num_groups
    for name, leafs in spec_tree["layers"].items():
        for s in leafs.values():
            if s.kind == DIST:
                elems[groups[name]] += s.s_loc * mesh_cfg.dshards
    return elems


def _mat(storage, spec_tree, mesh_cfg, groups, policies):
    """Materialize every layer with its own AWP format (per-layer mode)."""
    by_name = {name: policies[g] for name, g in groups.items()}
    return {
        name: {
            k: materialize_leaf(v, spec_tree["layers"][name][k], mesh_cfg, by_name[name])
            for k, v in leafs.items()
        }
        for name, leafs in storage["layers"].items()
    }


def make_cnn_train_step(
    cfg: CNNConfig,
    mesh_cfg: MeshCfg,
    spec_tree,
    groups_info,
    opt_cfg: SGDConfig,
    *,
    plan: PrecisionPlan | None = None,
):
    """Returns ``step(storage, momentum, batch, lr, key)`` ->
    ``(storage, momentum, {"loss", "group_norms_sq"})``.

    ``key`` is a ``repro_torch.random`` key (dropout). Storage and
    momentum are updated in place and returned. ``group_norms_sq`` is the
    per-group Σw² of the post-update, unquantized masters of every
    ``meta.compress`` leaf (so conv0, compressible but under
    ``compress_min_size``, is monitored and decayed but never packed)."""
    groups, num_groups = groups_info
    plan = resolve_plan(
        cfg, plan=plan, caller="make_cnn_train_step", num_groups=num_groups
    )
    fp32_math()
    policies = plan.weight_policies()
    if plan.needs_rng:
        raise NotImplementedError(
            "stochastic rounding is not ported yet (needs a bit-exact "
            "jax.random.randint)"
        )
    aq = _act_quant_fn(plan.activations)
    wd = tree_map(lambda s: 1.0 if s.meta.compress else 0.0, spec_tree)
    monitored = [
        (name, k, groups[name])
        for name, leafs in spec_tree["layers"].items()
        for k, s in leafs.items()
        if s.meta.compress
    ]

    def step(storage, momentum, batch, lr, key):
        leaves = tree_leaves(storage)
        live = [p.detach().requires_grad_(True) for p in leaves]
        it = iter(live)
        st = tree_map(lambda _: next(it), storage)
        layers = _mat(st, spec_tree, mesh_cfg, groups, policies)
        loss = cnn_loss(
            layers, batch["images"], batch["labels"], cfg,
            train=True, key=key, act_quant=aq,
        )
        grads = torch.autograd.grad(loss, live)
        git = iter(grads)
        grad_tree = tree_map(lambda _: next(git), storage)
        storage, momentum = sgd_update(
            storage, grad_tree, momentum, wd, opt_cfg, lr
        )

        # AWP per-group Σw² (paper Algorithm 1 line 6 input)
        with torch.no_grad():
            dev = leaves[0].device
            sums = torch.zeros((num_groups,), dtype=torch.float32, device=dev)
            for name, k, g in monitored:
                v = storage["layers"][name][k].to(torch.float32)
                sums[g] += torch.sum(v * v)
        return storage, momentum, {"loss": loss.detach(), "group_norms_sq": sums}

    return step


def make_cnn_eval(cfg, mesh_cfg, spec_tree, groups_info, *,
                  plan: PrecisionPlan | None = None):
    """Returns ``evaluate(storage, images, labels)`` (top-5 error) at the
    plan's weight widths."""
    groups, num_groups = groups_info
    plan = resolve_plan(cfg, plan=plan, caller="make_cnn_eval", num_groups=num_groups)
    fp32_math()
    # evaluation is deterministic: stochastic forward rounding falls back
    # to nearest (same kept bytes, no PRNG dependence)
    policies = tuple(
        pol if pol.mode != "stochastic" else policy_for(pol, mode="nearest")
        for pol in plan.weight_policies()
    )

    @torch.no_grad()
    def evaluate(storage, images, labels):
        layers = _mat(storage, spec_tree, mesh_cfg, groups, policies)
        return topk_error(layers, images, labels, cfg, k=5)

    return evaluate

