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

Stochastic rounding (``plan.needs_rng``) packs with keys folded off
``fold_in(key, 0xAD7)``, one a leaf of each layer whose policy uses one,
as the reference's; the planes then go through the plain version.

PyTorch runs eagerly, so the reference's jitted step becomes a plain
function; the trainer caches one step per format tuple as the reference
caches compiled steps.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch import fp32_math
from repro_torch import random as _random
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
from repro_torch.plan import PrecisionPlan, policy_uses_rng
from repro_torch.train.step import resolve_plan
from repro_torch.transport import policy_for
from repro_torch.transport import transport as _T
from repro_torch.utils import spans
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


def reference_index(shapes: dict, device) -> dict:
    """``{name: index}`` for the weights (``shapes``: ``{layer name: w
    shape}`` in layer order) whose port layout is not the reference's:
    every conv kernel (OIHW here, HWIO there) and the first dense layer
    after the convolutions (rows in NCHW flatten order here, NHWC there).
    ``index`` has the port weight's shape and holds each element's flat
    index in the reference's layout (int64 on ``device``): where stochastic
    rounding draws its noise. Tracks the channels the last layer produced."""
    out, ch = {}, None
    for name, shape in shapes.items():
        ar = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
        if len(shape) == 4:  # reference (H, W, I, O) -> port (O, I, H, W)
            o, i, h, k = shape
            out[name] = ar.reshape(h, k, i, o).permute(3, 2, 0, 1).contiguous()
            ch = o
        elif len(shape) == 2:
            rows, cols = shape
            if ch and rows != ch and rows % ch == 0:  # rows (h, w, c) -> (c, h, w)
                hw = math.isqrt(rows // ch)
                out[name] = ar.reshape(hw, hw, ch, cols).permute(2, 0, 1, 3).reshape(shape)
            ch = cols
    return out


def noise_indices(spec_tree, mesh_cfg: MeshCfg, device, rank: int = 0) -> dict:
    """``{name: index}``, the ``index`` argument of
    :func:`~repro_torch.dist.spec.materialize_leaf` for each weight of
    :func:`reference_index`, on FSDP rank ``rank``: on the trivial mesh the
    index itself; across ranks ``(forward, backward)``, the backward over
    the padded flat storage (padding at its own index) and the forward
    over the rank's shard, modulo the shard length (the reference packs
    each rank's shard from index 0). A chunked gather (``plan.chunks > 1``)
    reads the forward index chunk by chunk: an element at shard offset
    ``q`` draws under the key of the reference's chunk ``q // loc`` at
    ``q % loc`` (``transport._pack_by_chunk``)."""
    specs = {n: leafs["w"] for n, leafs in spec_tree["layers"].items() if "w" in leafs}
    out = {}
    for name, idx in reference_index({n: s.logical for n, s in specs.items()},
                                     device).items():
        spec = specs[name]
        if mesh_cfg.trivial or spec.kind != DIST:
            out[name] = idx
            continue
        flat = idx.reshape(-1)
        pad = torch.arange(flat.numel(), spec.pad_rep, dtype=torch.int64, device=device)
        full = torch.cat([flat, pad])
        per = spec.pad_rep // mesh_cfg.dshards
        out[name] = (full[rank * per:(rank + 1) * per] % per, full)
    return out


def _mat(storage, spec_tree, mesh_cfg, groups, policies, group=None, rng=None,
         indices=None):
    """Materialize every layer with its own AWP format (per-layer mode).

    ``rng``: the stochastic-rounding key. Each leaf of a layer whose
    policy uses it gets ``fold_in(rng, i)``, ``i`` counted over those
    leaves in the reference's order (layer names, then leaf names, sorted:
    jax's order for a dict). ``indices`` (:func:`noise_indices`) draws
    each weight's noise where the reference draws it for the same element,
    so the planes are the reference's."""
    by_name = {name: policies[g] for name, g in groups.items()}
    keys, fold = {}, 0
    for name in sorted(storage["layers"]):
        if rng is not None and policy_uses_rng(by_name[name]):
            for k in sorted(storage["layers"][name]):
                keys[name, k] = _random.fold_in(rng, fold)
                fold += 1

    def mat(name, k, v):
        key = keys.get((name, k))
        index = (indices or {}).get(name) if key is not None and k == "w" else None
        return materialize_leaf(v, spec_tree["layers"][name][k], mesh_cfg, by_name[name],
                                key=key, group=group, index=index)

    return {name: {k: mat(name, k, v) for k, v in leafs.items()}
            for name, leafs in storage["layers"].items()}


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
    needs_rng = plan.needs_rng
    group = _dp_group(mesh_cfg, mesh, "make_cnn_train_step")
    rank = 0 if mesh_cfg.trivial else dist.get_rank(group)
    indices: dict = {}  # noise indices, built at the first step on its device
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
        # stochastic rounding rides a branch folded off the dropout key, so
        # that turning it on never moves an existing run's dropout pattern
        rngq = _random.fold_in(key, 0xAD7) if needs_rng else None
        if needs_rng and not indices:
            indices.update(noise_indices(spec_tree, mesh_cfg, leaves[0].device, rank))
        layers = _mat(st, spec_tree, mesh_cfg, groups, policies, group, rngq, indices)
        images, labels = batch["images"], batch["labels"]
        if n > 1:
            images, labels = _rank_slice(images, group, n), _rank_slice(labels, group, n)
        with spans.span("train.forward"):
            loss = cnn_loss(
                layers, images, labels, cfg, train=True, key=key, act_quant=aq,
            ) / n
        with spans.span("train.backward"):
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
            with spans.span("awp.monitor"):
                dev = leaves[0].device
                sums = torch.zeros((num_groups,), dtype=torch.float32, device=dev)
                for name, k, g in monitored:
                    sums[g] += ops.l2norm_sq(storage["layers"][name][k])
                if n > 1:
                    sums = comm.all_reduce(sums, group, traffic="metrics")
            loss = loss.detach()
            if n > 1:
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

