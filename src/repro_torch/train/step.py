"""Step-factory helpers shared by the train and serve steps (counterpart
of the part of ``repro.train.step`` the serving slice reads:
``resolve_plan`` and ``make_mat_fns``). The dense LM train step itself
comes with its own slice.
"""
from __future__ import annotations

import torch

from repro_torch.dist.spec import MeshCfg, materialize_leaf, materialize_placed_leaf
from repro_torch.plan import PrecisionPlan
from repro_torch.transport import policy_for
from repro_torch.utils.trees import tree_map


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
