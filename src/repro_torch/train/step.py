"""Dense LM train step, on one device or on an FSDP×TP mesh of ranks, and
the step-factory helpers the serve steps share with it (counterpart of
``repro.train.step``).

:func:`make_train_step` gives the loss and its gradient over weights
materialized at the plan's formats, momentum SGD with the weight-decay
mask, then the AWP monitor :func:`awp_group_norms` on the updated masters
(one ``ops.l2norm_sq`` a ``DIST`` leaf: the kernel for CUDA tensors).
On one device (``mesh is None``) a weight is the straight-through ADT
quantize (Bitpack/Bitunpack in the CUDA kernels for CUDA tensors). On a
mesh (each rank a process of an initialised ``torch.distributed`` group,
``mesh`` from ``launch.mesh.make_mesh_from_cfg``) the step is the
reference's ``shard_map`` body: the rank holds its blocks of storage
(``dist.spec.tree_to_local``) and takes its FSDP slice of the global
batch; each ``DIST`` leaf is its TP slice, gathered as planes over the
FSDP group, whose backward reduce-scatters the gradient onto the shard;
the model's ``Env`` carries the TP-region collectives (compressed by the
plan's ``activations`` / ``seq_boundary`` policies, sequence-parallel
under ``seq_parallel``); :func:`sync_grads` sums the other gradients
over the groups that hold partial ones; the loss, token count and Σw²
are summed over the groups. PyTorch runs eagerly, so the jitted step
becomes a plain function that updates storage and momentum in place; the
trainer caches one per format tuple.

The plan's ``dtype`` is the compute dtype (materialized weights are cast
to it after the unpack; masters, planes and Σw² stay fp32), its
``accum_steps`` the number of micro-batches whose gradients and losses a
step sums. ``plan.needs_rng`` (stochastic rounding on the weight or
gradient path) gives the step a trailing ``repro_torch.random`` key; each
materialization site of a policy that uses it gets ``fold_in(key, i)``,
``i`` counted in the reference's trace order (:func:`fold_sites`).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import fp32_math
from repro_torch import random as _random
from repro_torch.dist import comm
from repro_torch.dist.spec import (
    DIST,
    MeshCfg,
    dist_elems_per_group,
    materialize_leaf,
    materialize_placed_leaf,
)
from repro_torch.launch.mesh import fsdp_group
from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.optim.sgd import SGDConfig, sgd_update
from repro_torch.plan import PrecisionPlan, policy_uses_rng
from repro_torch.transport import CompressionPolicy, policy_for
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


def check_seq_parallel(batch_shapes: dict, mesh_cfg: MeshCfg):
    """Sequence-parallel precondition: every sequence dim splits evenly
    over the model group (reduce-scatter semantics)."""
    for key in ("tokens", "labels", "features"):
        shape = batch_shapes.get(key)
        if shape is not None and len(shape) >= 2 and shape[1] % mesh_cfg.tp:
            raise ValueError(f"seq_parallel needs batch[{key!r}] seq dim {shape[1]} "
                             f"divisible by tp={mesh_cfg.tp}")


def _jax_paths(tree, prefix=()) -> list[tuple]:
    """The leaf paths of nested dicts in jax's flattening order (keys
    sorted), the order in which the reference's ``tree_map`` visits them."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _jax_paths(tree[k], prefix + (k,))]
    return [prefix]


def _shared_reps(cfg) -> bool:
    """Whether a group's layers share their stochastic-rounding keys: the
    reference traces the layer body once under a scan or ``remat``."""
    return cfg.scan_layers or cfg.remat


def fold_sites(cfg, spec_tree, policies) -> dict:
    """The reference's stochastic-rounding fold index of every
    materialization site of one forward: ``{site: i}``, the site's key
    being ``fold_in(key, i)``.

    The reference counts one index per materialized leaf whose policy
    uses a key (:func:`~repro_torch.plan.policy_uses_rng`), DIST or not,
    in the order its forward traces them: the embedding; then each
    group's layers, a pattern key's leaves in jax's order (sorted keys);
    the final norm; the head (or, tied, the embedding again). A group's
    layer body is traced once under ``cfg.scan_layers`` (the scan), and
    also under ``cfg.remat`` (``jax.checkpoint`` traces the body once and
    reuses it for every repetition of the group), so then every layer of
    the group shares one index a leaf (sites ``("group", g, None, key,
    path)``); otherwise each repetition has its own (``rep`` for
    ``None``). A recomputed (remat) layer looks its key up again: the same
    site, the same key. Top-level sites are ``("top", name, n)``, the
    ``n``-th materialization of ``name`` in the forward."""
    sites, top = [], policies[-1]
    tops = ["embed", "final_norm", "embed" if cfg.tie_embeddings else "head"]
    seen: dict = {}

    def add_top(name):
        seen[name] = seen.get(name, -1) + 1
        if policy_uses_rng(top):
            sites.append(("top", name, seen[name]))

    add_top(tops[0])
    for g, gs in enumerate(spec_tree["groups"]):
        if not policy_uses_rng(policies[g]):
            continue
        reps = next(iter(tree_leaves(gs))).reps
        for rep in [None] if _shared_reps(cfg) else range(reps):
            for pi in range(len(cfg.pattern)):
                key = f"p{pi}"
                sites += [("group", g, rep, key, p) for p in _jax_paths(gs[key])]
    for name in tops[1:]:
        add_top(name)
    return {site: i for i, site in enumerate(sites)}


def make_mat_fns(spec_tree, mesh_cfg: MeshCfg, round_tos, dtype=torch.float32,
                 placed: bool = False, group=None, rng=None, cfg=None):
    """``(mat_group, mat_top_factory)`` shared by the train and serve steps.

    ``mat_group(g, key, storage, rep=None)`` materializes repetition
    ``rep`` of group ``g``'s pattern key ``key`` (``storage`` without the
    repetition dim) at the group's policy; ``mat_top_factory(storage)(name)``
    a top-level leaf at the last policy. ``round_tos`` entries are ints or
    policies (a plan passes ``plan.weight_policies()``). Materialized
    weights are cast to the compute dtype after the unpack; the fp32
    masters stay in storage. ``placed=True`` consumes resident weights
    (weight-stationary serving). ``group`` is the FSDP group of a sharded
    mesh. ``rng`` is the stochastic-rounding key of one forward, folded per
    site as :func:`fold_sites` numbers them from ``cfg`` (make a new pair
    for each forward: the top-level sites are counted by call)."""
    policies = tuple(policy_for(rt) for rt in round_tos)
    folds = {} if rng is None else fold_sites(cfg, spec_tree, policies)

    def _cast(x):
        return x.to(dtype) if x.dtype == torch.float32 else x

    def _mat(x, s, pol, site):
        if placed:
            return _cast(materialize_placed_leaf(x, s, mesh_cfg))
        i = folds.get(site)
        key = None if i is None else _random.fold_in(rng, i)
        return _cast(materialize_leaf(x, s, mesh_cfg, pol, key=key, group=group))

    def _mat_tree(x, s, pol, site):
        if isinstance(x, dict):
            return {k: _mat_tree(x[k], s[k], pol, site + (k,)) for k in x}
        return _mat(x, s, pol, site[:4] + (site[4:],))

    def mat_group(g, key, storage, rep=None):
        site = ("group", g, None if cfg is None or _shared_reps(cfg) else rep, key)
        return _mat_tree(storage, spec_tree["groups"][g][key], policies[g], site)

    def mat_top_factory(storage):
        pol = policies[-1]
        calls: dict = {}

        def mat_top(name):
            calls[name] = calls.get(name, -1) + 1
            return _mat(storage[name], spec_tree[name], pol, ("top", name, calls[name]))

        return mat_top

    return mat_group, mat_top_factory


def build_wd_mask(spec_tree):
    """1.0 for matrices (compressible), 0.0 for norms/biases/gates."""
    return tree_map(lambda s: 1.0 if s.meta.compress else 0.0, spec_tree)


def check_mesh(mesh_cfg: MeshCfg, mesh, caller: str):
    """``mesh`` must be ``None`` on one device, else
    ``make_mesh_from_cfg(mesh_cfg)``'s, with an FSDP group of ``dshards``
    ranks."""
    if mesh_cfg.trivial:
        if mesh is not None:
            raise ValueError(f"{caller}: a mesh object on the trivial mesh")
        return
    if mesh is None or mesh.cfg != mesh_cfg:
        raise ValueError(f"{caller}: needs launch.mesh.make_mesh_from_cfg(mesh_cfg)'s mesh")
    n = dist.get_world_size(fsdp_group(mesh))
    if n != mesh_cfg.dshards:
        raise ValueError(f"{caller}: FSDP group of {n} ranks, dshards={mesh_cfg.dshards}")


def sync_grads(grads, specs, mesh_cfg: MeshCfg, *, fsdp=None, model=None,
               seq_parallel: bool = False):
    """The gradient sums the gathers' backward does not do (the
    reference's ``_sync_grads``) on ``grads``, a list beside ``specs``
    (each gradient's :class:`~repro_torch.dist.spec.LeafSpec`): every
    non-``DIST`` leaf summed over the FSDP group; ``grad_sync_model``
    leaves (and, under the sequence-parallel layout, ``grad_sync_seq``
    leaves) then over the model group. fp32, the ``grad_sync`` class."""
    out = []
    for g, s in zip(grads, specs):
        if s.kind != DIST and mesh_cfg.dshards > 1:
            g = comm.all_reduce(g, fsdp, traffic="grad_sync")
        if mesh_cfg.tp > 1 and (s.meta.grad_sync_model
                                or (seq_parallel and s.meta.grad_sync_seq)):
            g = comm.all_reduce(g, model, traffic="grad_sync")
        out.append(g)
    return out


def awp_group_norms(storage, spec_tree, mesh_cfg: MeshCfg, *, fsdp=None,
                    model=None) -> torch.Tensor:
    """Per-precision-group Σw² of the compressed (``DIST``) weights, with
    replication factors divided out: ``(num_groups + 1,)`` fp32, the last
    entry over the top-level leaves. One ``ops.l2norm_sq`` per ``DIST``
    leaf of the rank's storage (the kernel on a CUDA tensor); the sums
    are taken on the device in a fixed leaf order, then summed over the
    FSDP group and then over the model group (fp32, the ``metrics``
    class) on a mesh."""
    top = [k for k in storage if k != "groups"]
    dev = storage[top[0]].device

    @torch.no_grad()
    def subtree_sum(xs, specs):
        total = torch.zeros((), dtype=torch.float32, device=dev)
        # paired by key, in the storage's order (a tree's dict order is free)
        for x, s in tree_leaves(tree_map(lambda a, b: (a, b), xs, specs)):
            if s.kind == DIST:
                total = total + ops.l2norm_sq(x) / s.repl_factor
        return total

    norms = [subtree_sum(gp, gs) for gp, gs in zip(storage["groups"], spec_tree["groups"])]
    norms.append(subtree_sum({k: storage[k] for k in top}, {k: spec_tree[k] for k in top}))
    out = torch.stack(norms)
    if mesh_cfg.dshards > 1:
        out = comm.all_reduce(out, fsdp, traffic="metrics")
    if mesh_cfg.tp > 1:
        out = comm.all_reduce(out, model, traffic="metrics")
    return out


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


# the plan's traffic classes that a step's collectives carry (the plan's
# host_device row, at one FSDP rank, is its staging model, not a collective)
COLLECTIVE_CLASSES = ("weights", "gradients", "activations", "seq_boundary")


def tp_boundaries(cfg) -> int:
    """TP-region boundaries of one train step of the dense LM, each moving
    one ``(B / dshards, S, d)`` activation over the model group: the
    embedding's exit and every block's exit (attention, and the MLP when
    ``d_ff``) in the forward, every block's enter and the logits' enter in
    the backward. Under the sequence-parallel layout each is one
    gather/scatter pair, as :meth:`PrecisionPlan.wire_table` prices it."""
    blocks = cfg.num_layers * (2 if cfg.d_ff else 1)
    return 2 * blocks + 2


def remat_tp_collectives(cfg) -> tuple[int, int]:
    """``(enters, exits)`` of the TP-region boundaries that the ``remat``
    backward runs again in the recomputed forward: every block's enter
    (a collective only under the sequence-parallel layout) and every
    block's exit but each layer's last, whose output nothing in the layer
    reads (the recomputation stops once it has what the backward saved)."""
    if not cfg.remat:
        return 0, 0
    per_layer = 2 if cfg.d_ff else 1
    return cfg.num_layers * per_layer, cfg.num_layers * (per_layer - 1)


def step_wire_table(plan: PrecisionPlan, cfg, spec_tree, mesh_cfg: MeshCfg,
                    batch_shape) -> dict:
    """Per-class wire bytes of one train step of ``make_train_step`` on a
    rank: the plan's :meth:`~repro_torch.plan.PrecisionPlan.wire_table`
    with the step's TP-region boundaries (:func:`tp_boundaries`) at ``act
    elems = (B / dshards) · S · d``; under ``remat`` the recomputed
    forward's collectives are added by the same policy formulas: the
    group leaves' gathers (the top-level leaves are gathered outside the
    recomputed layers) and :func:`remat_tp_collectives`; with
    ``accum_steps`` micro-batches the weight and gradient rows are that
    many times one's (the plan's ``wire_table``, like the reference's,
    prices one). In each of
    :data:`COLLECTIVE_CLASSES` the collectives' measured log
    (``comm.wire_by_traffic``) must equal it."""
    B, S = batch_shape
    nrt = cfg.num_groups + 1
    elems = dist_elems_per_group(spec_tree, mesh_cfg, nrt)
    n, tp = mesh_cfg.dshards, mesh_cfg.tp
    act_elems = (B // n) * S * cfg.d_model if tp > 1 else 0
    width = plan.compute_dtype.itemsize  # an uncompressed activation's bytes
    table = plan.wire_table(elems, n, tp=tp, act_elems=act_elems,
                            act_collectives=tp_boundaries(cfg), act_bytes=width)
    extra = {}
    if cfg.remat and n > 1:
        extra["weights"] = plan.wire_table(elems[:-1] + [0], n, training=False)["weights"]
    enters, exits = remat_tp_collectives(cfg)
    if tp > 1 and plan.seq_parallel:
        seq = plan.seq_policy() or CompressionPolicy()
        extra["seq_boundary"] = (
            enters * seq.seq_gather_wire_bytes(act_elems, tp, uncompressed_bytes=width)
            + exits * seq.seq_scatter_wire_bytes(act_elems, tp, uncompressed_bytes=width))
    elif tp > 1:
        act = plan.activations or CompressionPolicy()
        extra["activations"] = exits * act.all_reduce_wire_bytes(act_elems, tp, width)
    for k, v in extra.items():
        table[k] += v
        table["total"] += v
    # each micro-batch gathers the weights and reduce-scatters its gradients
    # (its activations are 1 / accum of the batch's: their sum is the same)
    for k in ("weights", "gradients"):
        table["total"] += (plan.accum_steps - 1) * table[k]
        table[k] *= plan.accum_steps
    return table


def _rank_rows(x, group, n):
    """This rank's rows of a global batch (the reference's ``P(dp)``)."""
    if x.shape[0] % n:
        raise ValueError(f"batch of {x.shape[0]} does not split over {n} FSDP ranks")
    per = x.shape[0] // n
    r = dist.get_rank(group)
    return x[r * per:(r + 1) * per]


def batch_rows(batch: dict, mesh_cfg: MeshCfg, group, shard_batch: bool) -> dict:
    """A data rank's part of a serve batch (the reference's
    ``batch_pspecs``): with ``shard_batch`` on more than one FSDP rank, its
    rows of every leaf with a batch dim; 0-d leaves (a scalar ``pos``, a
    ``last``) and, without ``shard_batch``, every leaf whole."""
    n = mesh_cfg.dshards
    if n <= 1 or not shard_batch:
        return batch
    return {k: _rank_rows(v, group, n) if torch.is_tensor(v) and v.ndim else v
            for k, v in batch.items()}


def _rep_specs(storage, spec_tree) -> list:
    """The spec of every leaf of ``_split_reps(storage, ...)``, in its
    order (each stacked leaf's once per repetition)."""
    groups = [tree_map(lambda _, s: [s] * s.reps, g, gs)
              for g, gs in zip(storage["groups"], spec_tree["groups"])]
    return tree_leaves({"groups": groups,
                        **{k: spec_tree[k] for k in storage if k != "groups"}})


def micro_batches(batch: dict, accum_steps: int) -> list[dict]:
    """The reference's ``(accum, B / accum, ...)`` reshape of a (rank-local)
    batch: row ``i`` of micro-batch ``j`` is row ``j * B / accum + i``."""
    if accum_steps == 1:
        return [batch]
    B = next(iter(batch.values())).shape[0]
    if B % accum_steps:
        raise ValueError(f"a batch of {B} rows does not split into accum_steps="
                         f"{accum_steps} micro-batches")
    per = B // accum_steps
    return [{k: v[j * per:(j + 1) * per] for k, v in batch.items()}
            for j in range(accum_steps)]


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
    """Returns ``step(storage, momentum, batch, lr[, key]) -> (storage,
    momentum, metrics)`` with ``metrics = {"loss", "token_count",
    "group_norms_sq"}`` (0-d, 0-d and ``(num_groups + 1,)`` tensors on the
    storage's device, equal on every rank). ``batch`` holds ``tokens``
    and ``labels``, the global ``(B, S)`` integer tensors (on a mesh the
    rank takes its FSDP slice of the rows); the loss is the summed NLL
    over ``B * S`` (the reference's static token count). Storage and
    momentum (on a mesh, the rank's blocks) are updated in place and
    returned. The trailing ``key`` (a ``repro_torch.random`` key) exists
    exactly when ``plan.needs_rng``; every micro-batch uses it alike.

    Call as the reference is called::

        make_train_step(cfg, mesh_cfg, mesh, spec_tree, opt_cfg,
                        batch_shapes, plan=plan)

    with ``mesh`` None on one device, else
    ``launch.mesh.make_mesh_from_cfg(mesh_cfg)``'s. ``batch_shapes`` maps
    ``tokens`` / ``labels`` to their ``(B, S)`` shapes (the
    sequence-parallel precondition reads them); nothing is traced.

    With ``plan.accum_steps > 1`` the rank's rows are cut into that many
    micro-batches (:func:`micro_batches`; a batch that does not split
    raises ``ValueError``); their gradients and losses are summed in
    micro-batch order before the gradient sync and the update."""
    if opt_cfg is None or batch_shapes is None:
        raise TypeError("make_train_step: opt_cfg and batch_shapes required")
    check_mesh(mesh_cfg, mesh, "make_train_step")
    plan = resolve_plan(cfg, plan=plan, caller="make_train_step")
    fp32_math()
    env = plan.make_env(mesh_cfg, mesh)
    fsdp, model = env.fsdp_group, env.model_group
    if env.seq_parallel and mesh_cfg.tp > 1:
        check_seq_parallel(batch_shapes, mesh_cfg)
    policies = plan.weight_policies()
    n = mesh_cfg.dshards

    def grad_one(live, batch, total, rng):
        mat_group, mat_top_factory = make_mat_fns(
            spec_tree, mesh_cfg, policies, plan.compute_dtype, group=fsdp, rng=rng, cfg=cfg
        )
        nll_sum, metrics = M.forward_loss(
            live, batch, cfg, env, mat_group=mat_group, mat_top=mat_top_factory(live)
        )
        loss = nll_sum / total  # local tokens x dshards
        grads = list(torch.autograd.grad(loss, tree_leaves(live)))
        return loss.detach(), metrics["token_count"].detach(), grads

    def _step(storage, momentum, batch, lr, rng):
        B, S = batch["labels"].shape
        if n > 1:
            batch = {k: _rank_rows(v, fsdp, n) for k, v in batch.items()}
        live = _split_reps(storage, spec_tree, lambda t: t.detach().requires_grad_(True))
        loss = count = grads = None
        for mb in micro_batches(batch, plan.accum_steps):
            l, c, g = grad_one(live, mb, float(B * S), rng)
            if grads is None:
                loss, count, grads = l, c, g
            else:  # summed in micro-batch order, as the reference's scan
                loss, count = loss + l, count + c
                for acc, gi in zip(grads, g):
                    acc.add_(gi)
                del g
        del live
        specs = _rep_specs(storage, spec_tree)  # one a gradient, in the same order
        if not mesh_cfg.trivial:
            grads = sync_grads(grads, specs, mesh_cfg, fsdp=fsdp, model=model,
                               seq_parallel=env.seq_parallel_active)
        wd = [1.0 if s.meta.compress else 0.0 for s in specs]
        sgd_update(
            tree_leaves(_split_reps(storage, spec_tree, lambda t: t)), grads,
            tree_leaves(_split_reps(momentum, spec_tree, lambda t: t)), wd, opt_cfg, lr,
        )
        del grads
        norms = awp_group_norms(storage, spec_tree, mesh_cfg, fsdp=fsdp, model=model)
        if n > 1:
            loss = comm.all_reduce(loss, fsdp, traffic="metrics")
            count = comm.all_reduce(count, fsdp, traffic="metrics")
        return storage, momentum, {
            "loss": loss,
            "token_count": count,
            "group_norms_sq": norms,
        }

    if plan.needs_rng:
        def step(storage, momentum, batch, lr, key):
            return _step(storage, momentum, batch, lr, key)
    else:
        def step(storage, momentum, batch, lr):
            return _step(storage, momentum, batch, lr, None)

    return step
