"""CNN train step with per-layer ADT compression (counterpart of
``repro.train.cnn_step``): the paper's setting — fp32 master weights, a
byte-plane weight transfer every batch, uncompressed gradients, per-layer
AWP — on one device or across data-parallel ranks.

A :class:`~repro_torch.plan.PrecisionPlan` with ``num_groups`` weight
entries drives the per-layer formats, the gradient reduce-scatter entry
and the activation policy (a straight-through stage-boundary quantize).
Each ``DIST`` weight is materialized through
:func:`~repro_torch.dist.spec.materialize_leaf`: on one device Bitpack and
Bitunpack in place; across ranks Bitpack of the rank's shard, an
all-gather of the planes, Bitunpack of the result, with the gradient
reduce-scattered back onto the shard on the way back (fp32 at
``grad_round_to`` 4, packed planes below it). The kernels are the CUDA
ones for CUDA tensors, the plain versions on the CPU. The AWP monitor's
Σw² goes through ``ops.l2norm_sq`` (the CUDA kernel for CUDA tensors),
one call per monitored leaf of the rank's storage.

Across ranks (``mesh_cfg.dshards > 1``, each rank a process of an
initialised ``torch.distributed`` group) the step is the reference's
``shard_map`` body: the rank takes its slice of the global batch, its
loss is divided by ``dshards``, the gradients of the non-``DIST`` leaves
and then the per-group Σw² and the loss are summed over the ranks in
fp32 (:mod:`repro_torch.dist.comm`). As in the reference, a monitored leaf
that is not ``DIST`` (conv0 at full width, under ``compress_min_size``)
is whole on every rank, so its Σw² enters the sum ``dshards`` times.

PyTorch runs eagerly, so the reference's jitted step becomes a plain
function; the trainer caches one step per format tuple as the reference
caches compiled steps.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import fp32_math
from repro_torch.dist import comm
from repro_torch.dist.spec import (
    DIST,
    MeshCfg,
    build_leaf_spec,
    leaf_to_storage,
    materialize_leaf,
)
from repro_torch.launch.mesh import fsdp_group
from repro_torch.kernels import ops
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


def _mat(storage, spec_tree, mesh_cfg, groups, policies, group=None):
    """Materialize every layer with its own AWP format (per-layer mode)."""
    by_name = {name: policies[g] for name, g in groups.items()}
    return {
        name: {
            k: materialize_leaf(v, spec_tree["layers"][name][k], mesh_cfg, by_name[name],
                                group=group)
            for k, v in leafs.items()
        }
        for name, leafs in storage["layers"].items()
    }


def _dp_group(mesh_cfg: MeshCfg, mesh, caller: str):
    """The FSDP group of a data-parallel mesh (checked against
    ``dshards``), or None on one device."""
    if mesh_cfg.dshards == 1:
        return None
    group = fsdp_group(mesh)
    n = dist.get_world_size(group)
    if n != mesh_cfg.dshards:
        raise ValueError(f"{caller}: mesh has dshards={mesh_cfg.dshards}, the process "
                         f"group {n} ranks")
    return group


def _rank_slice(x, group, n):
    """This rank's rows of a global batch (the reference's ``P(dp)``)."""
    if x.shape[0] % n:
        raise ValueError(f"batch of {x.shape[0]} does not split over {n} ranks")
    per = x.shape[0] // n
    r = dist.get_rank(group)
    return x[r * per:(r + 1) * per]


def make_cnn_train_step(
    cfg: CNNConfig,
    mesh_cfg: MeshCfg,
    spec_tree,
    groups_info,
    opt_cfg: SGDConfig,
    *,
    plan: PrecisionPlan | None = None,
    mesh=None,
):
    """Returns ``step(storage, momentum, batch, lr, key)`` ->
    ``(storage, momentum, {"loss", "group_norms_sq"})``.

    ``key`` is a ``repro_torch.random`` key (dropout; the same on every
    rank, as in the reference). Storage and momentum are updated in place
    and returned: on a data-parallel mesh they are the rank's own shards
    (``dist.spec.tree_to_local``), ``batch`` is the global batch, of which
    the rank takes its slice, and ``mesh`` is
    ``launch.mesh.make_mesh_from_cfg``'s (``None`` takes the default
    process group). ``group_norms_sq`` is the per-group Σw² of the
    post-update, unquantized masters of every ``meta.compress`` leaf (so
    conv0, compressible but under ``compress_min_size``, is monitored and
    decayed but never packed), summed over the ranks; the loss is the
    global batch's."""
    groups, num_groups = groups_info
    plan = resolve_plan(
        cfg, plan=plan, caller="make_cnn_train_step", num_groups=num_groups
    )
    fp32_math()
    policies = plan.weight_policies()
    if plan.needs_rng:
        raise NotImplementedError(
            "stochastic rounding is not ported yet (needs a bit-exact "
            "jax.random.randint; ROADMAP Queue 1 item 6.3)"
        )
    group = _dp_group(mesh_cfg, mesh, "make_cnn_train_step")
    n = mesh_cfg.dshards
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
        layers = _mat(st, spec_tree, mesh_cfg, groups, policies, group)
        images, labels = batch["images"], batch["labels"]
        if n > 1:
            images, labels = _rank_slice(images, group, n), _rank_slice(labels, group, n)
        loss = cnn_loss(
            layers, images, labels, cfg, train=True, key=key, act_quant=aq,
        ) / n
        grads = torch.autograd.grad(loss, live)
        if n > 1:
            # DIST gradients came back reduce-scattered onto the shards (the
            # gather's backward); the replicated leaves' are summed in fp32
            grads = [g if s.kind == DIST else comm.all_reduce(g, group, traffic="grad_sync")
                     for g, s in zip(grads, tree_leaves(spec_tree))]
        git = iter(grads)
        grad_tree = tree_map(lambda _: next(git), storage)
        storage, momentum = sgd_update(
            storage, grad_tree, momentum, wd, opt_cfg, lr
        )

        # AWP per-group Σw² (paper Algorithm 1 line 6 input): the
        # l2norm_sq kernel on a CUDA tensor, on the rank's storage
        with torch.no_grad():
            dev = leaves[0].device
            sums = torch.zeros((num_groups,), dtype=torch.float32, device=dev)
            for name, k, g in monitored:
                sums[g] += ops.l2norm_sq(storage["layers"][name][k])
            loss = loss.detach()
            if n > 1:
                sums = comm.all_reduce(sums, group, traffic="metrics")
                loss = comm.all_reduce(loss, group, traffic="metrics")
        return storage, momentum, {"loss": loss, "group_norms_sq": sums}

    return step


def make_cnn_eval(cfg, mesh_cfg, spec_tree, groups_info, *,
                  plan: PrecisionPlan | None = None, mesh=None):
    """Returns ``evaluate(storage, images, labels)`` (top-5 error) at the
    plan's weight widths. On a data-parallel mesh ``storage`` is the rank's
    shards: the weights are gathered, and every rank evaluates the whole
    batch (the reference replicates the images)."""
    groups, num_groups = groups_info
    plan = resolve_plan(cfg, plan=plan, caller="make_cnn_eval", num_groups=num_groups)
    fp32_math()
    # evaluation is deterministic: stochastic forward rounding falls back
    # to nearest (same kept bytes, no PRNG dependence)
    policies = tuple(
        pol if pol.mode != "stochastic" else policy_for(pol, mode="nearest")
        for pol in plan.weight_policies()
    )

    group = _dp_group(mesh_cfg, mesh, "make_cnn_eval")

    @torch.no_grad()
    def evaluate(storage, images, labels):
        layers = _mat(storage, spec_tree, mesh_cfg, groups, policies, group)
        return topk_error(layers, images, labels, cfg, k=5)

    return evaluate

