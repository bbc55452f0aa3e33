"""Storage layout of parameter leaves on the FSDP×TP mesh (counterpart of
``repro.dist.spec``).

Every parameter leaf is classified into one of three storage *kinds*:

  * ``DIST`` — large / compressible (``meta.compress`` and at least
    ``compress_min_size`` elements): the fp32 master copy lives as flat
    shards, TP-sliced first (a leading ``tp`` dim when ``meta.tp_dim`` is
    set), then flattened and zero-padded so the flat dim splits evenly
    over the ``dshards = dp * pods`` FSDP ranks. Materialization is a
    compressed all-gather over the rank's FSDP group through
    :mod:`repro_torch.transport`, whose backward reduce-scatters the
    gradient back onto the shards.
  * ``TP_SMALL`` — small but TP-sheared (only on meshes with ``tp > 1``):
    stored as stacked per-rank slices, whole on every FSDP rank.
  * ``REPL`` — small replicated leaves (biases, norm scales, and weights
    under ``compress_min_size``): stored and used as they are, on every
    rank.

Kind assignment depends only on the logical shape, the
:class:`~repro_torch.models.meta.ParamMeta` and ``compress_min_size``,
never on the mesh geometry, exactly as in the reference. ``DIST`` storage
order is TP slice first, then flatten, then zero-pad; stacked leaves keep
the layer-repetition dim outside: ``(reps, tp, pad_rep)``. When
``tp_units < tp`` (kv-head replication) consecutive model ranks share a
unit and ``repl_factor`` records the multiplicity, which the AWP monitor
divides back out.

On the trivial mesh (``tp == 1 and dshards == 1``) storage *is* the
logical tensor and materialization of a ``DIST`` leaf is the
straight-through format truncation (per use, or once under
weight-stationary serving, :func:`placed_leaf`, which on a sharded mesh
runs the FSDP gather once).

On a sharded mesh each rank is one process and holds its own block:
:func:`tree_to_storage` lays a leaf out as the reference does (all ranks'
blocks), and :func:`local_shard` / :func:`tree_to_local` take the block
of the rank at mesh coordinates (pod, data, model), what the reference's
``leaf_partition_spec`` selects for ``shard_map``. A rank is numbered in
mesh order, ``((pod * dp) + data) * tp + model``, as the reference's
``jax.make_mesh`` lays devices out. :func:`storage_to_global` reads the
layout backwards: the whole storage array from every rank's block (what a
checkpoint across ranks writes, and :func:`local_shard` takes back out of
it on a load). The reference's ``dist/shard.py``
(its ``shard_map`` version shim) has no counterpart here: each rank's
process *is* the shard.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.models.meta import COMPRESS_MIN_SIZE, ParamMeta
from repro_torch.transport import policy_for
from repro_torch.transport import transport as _T
from repro_torch.utils import spans
from repro_torch.utils.trees import round_up, tree_leaves, tree_map

DIST = "dist"
REPL = "repl"
TP_SMALL = "tp_small"


@dataclasses.dataclass(frozen=True)
class MeshCfg:
    """(pods ×) data × model mesh geometry + compression threshold."""

    tp: int = 1
    dp: int = 1
    pods: int = 1
    # leaves with fewer logical elements stay uncompressed (the paper's
    # "biases" carve-out); element count, not bytes
    compress_min_size: int = COMPRESS_MIN_SIZE

    @property
    def dshards(self) -> int:
        return self.dp * self.pods

    @property
    def shape(self) -> tuple[int, ...]:
        if self.pods > 1:
            return (self.pods, self.dp, self.tp)
        return (self.dp, self.tp)

    @property
    def axis_names(self) -> tuple[str, ...]:
        if self.pods > 1:
            return ("pod", "data", "model")
        return ("data", "model")

    @property
    def trivial(self) -> bool:
        return self.tp == 1 and self.dshards == 1


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """Storage descriptor for one parameter leaf (see the reference for
    the sharded fields; ``s_loc * dshards`` is the DIST element count the
    wire accounting multiplies by a policy's bytes/element)."""

    kind: str
    meta: ParamMeta
    logical: tuple[int, ...]
    local_logical: tuple[int, ...]
    stacked: bool = False
    reps: int = 1
    pad_rep: int = 0          # per-rep padded flat length (DIST)
    s_loc: int = 0            # per-FSDP-shard flat elems, all reps (DIST)
    repl_factor: int = 1

    @property
    def n_local(self) -> int:
        return math.prod(self.local_logical) if self.local_logical else 1


def build_leaf_spec(
    shape, meta: ParamMeta, mesh_cfg: MeshCfg, *, stacked: bool = False
) -> LeafSpec:
    """Classify one leaf and precompute its storage geometry."""
    shape = tuple(int(s) for s in shape)
    base = shape[1:] if stacked else shape
    reps = shape[0] if stacked else 1
    n = math.prod(base) if base else 1
    local = tuple(meta.local_shape(base, mesh_cfg.tp))
    n_local = math.prod(local) if local else 1

    compressible = meta.compress and n >= mesh_cfg.compress_min_size
    if compressible:
        kind = DIST
    elif meta.tp_dim is not None and mesh_cfg.tp > 1:
        kind = TP_SMALL
    else:
        kind = REPL

    repl_factor = 1
    pad_rep = n_local
    s_loc = 0
    if kind == DIST:
        tp = max(mesh_cfg.tp, 1)
        if meta.tp_dim is None:
            repl_factor = tp  # same FSDP shard on every model rank
        else:
            units = meta.tp_units or base[meta.tp_dim]
            repl_factor = 1 if units % tp == 0 else tp // units
        pad_rep = round_up(max(n_local, 1), mesh_cfg.dshards)
        s_loc = reps * (pad_rep // mesh_cfg.dshards)

    return LeafSpec(
        kind=kind,
        meta=meta,
        logical=base,
        local_logical=local,
        stacked=stacked,
        reps=reps,
        pad_rep=pad_rep,
        s_loc=s_loc,
        repl_factor=repl_factor,
    )


def mesh_coords(mesh_cfg: MeshCfg, rank: int) -> tuple[int, int]:
    """``(fsdp index, model index)`` of global rank ``rank`` in mesh order:
    the FSDP index is ``pod * dp + data``, the rank's place in its gather
    group."""
    if not 0 <= rank < mesh_cfg.dshards * mesh_cfg.tp:
        raise ValueError(f"rank {rank} outside the {mesh_cfg.shape} mesh")
    return rank // mesh_cfg.tp, rank % mesh_cfg.tp


def storage_shape(spec: LeafSpec, mesh_cfg: MeshCfg) -> tuple[int, ...]:
    """Shape of the whole storage array of a leaf (all ranks' blocks)."""
    lead = (spec.reps,) if spec.stacked else ()
    if mesh_cfg.trivial or spec.kind == REPL:
        return lead + spec.logical
    if spec.kind == TP_SMALL:
        return lead + (mesh_cfg.tp,) + spec.local_logical
    if spec.meta.tp_dim is not None:
        return lead + (mesh_cfg.tp, spec.pad_rep)
    return lead + (spec.pad_rep,)


def _tp_slice(x, spec: LeafSpec, rank: int, tp: int):
    """Model rank ``rank``'s TP-local logical slice of an unstacked
    logical leaf (a view)."""
    meta = spec.meta
    if meta.tp_dim is None or tp == 1:
        return x
    start = meta.tp_slice_index(rank, spec.logical, tp)
    return x.narrow(meta.tp_dim, start, spec.local_logical[meta.tp_dim])


def tp_slice(x, spec: LeafSpec, mesh_cfg: MeshCfg, model_rank: int):
    """Model rank ``model_rank``'s TP-local logical slice of a logical leaf
    (per repetition when stacked): what that rank's materialized weights
    hold. A view of an unstacked leaf, a copy of a stacked one."""
    if spec.meta.tp_dim is None or mesh_cfg.tp == 1:
        return x
    if spec.stacked:
        return torch.stack([_tp_slice(x[i], spec, model_rank, mesh_cfg.tp)
                            for i in range(spec.reps)])
    return _tp_slice(x, spec, model_rank, mesh_cfg.tp)


def leaf_to_storage(x, spec: LeafSpec, mesh_cfg: MeshCfg):
    """Lay one logical leaf out in storage form: the identity on the
    trivial mesh and for ``REPL`` leaves; a ``TP_SMALL`` leaf as its
    stacked per-rank slices; a ``DIST`` leaf TP-sliced, flattened and
    zero-padded to ``pad_rep`` (per layer repetition when stacked)."""
    if mesh_cfg.trivial or spec.kind == REPL:
        return x
    tp = mesh_cfg.tp

    def flat_pad(sl):
        flat = sl.reshape(-1)
        pad = spec.pad_rep - flat.shape[0]
        return torch.nn.functional.pad(flat, (0, pad)) if pad else flat.contiguous()

    def one(rep_x):
        if spec.kind == TP_SMALL:
            return torch.stack([_tp_slice(rep_x, spec, r, tp) for r in range(tp)])
        if spec.meta.tp_dim is not None:
            return torch.stack([flat_pad(_tp_slice(rep_x, spec, r, tp)) for r in range(tp)])
        return flat_pad(rep_x)

    if spec.stacked:
        return torch.stack([one(x[i]) for i in range(spec.reps)])
    return one(x)


def local_shard(x, spec: LeafSpec, mesh_cfg: MeshCfg, rank: int):
    """Global rank ``rank``'s block of a storage array (what the
    reference's ``leaf_partition_spec`` selects), a copy: a ``DIST``
    leaf's ``pad_rep / dshards`` flat elements at the rank's FSDP offset
    (per repetition), of its model rank's slice when TP-sliced (the
    ``tp`` dim kept, at size 1); a ``TP_SMALL`` leaf's model-rank slice
    (size-1 ``tp`` dim); a ``REPL`` leaf whole. The trivial mesh's storage
    is returned as it is."""
    if mesh_cfg.trivial:
        return x
    if spec.kind == REPL:
        return x.clone()
    f, m = mesh_coords(mesh_cfg, rank)
    lead = 1 if spec.stacked else 0
    if spec.kind == TP_SMALL:
        return x.narrow(lead, m, 1).clone()
    if spec.meta.tp_dim is not None:
        x = x.narrow(lead, m, 1)
    per = spec.pad_rep // mesh_cfg.dshards
    return x[..., f * per:(f + 1) * per].clone()


def storage_to_global(blocks_by_rank, spec: LeafSpec, mesh_cfg: MeshCfg):
    """The inverse of :func:`local_shard` over all ranks: the whole storage
    array of a leaf (the reference's global array, ``np.asarray`` of its
    sharded leaf) from ``blocks_by_rank[r]``, global rank ``r``'s block, in
    mesh order. A ``DIST`` leaf's flat shards are laid side by side at their
    FSDP offsets (per repetition; padding included), in their model rank's
    row when TP-sliced; a ``TP_SMALL`` leaf's slices are stacked at their
    model ranks; a ``REPL`` leaf is rank 0's. Where several ranks hold one
    block (a ``DIST`` leaf with no TP dim, a ``REPL`` leaf) the first
    rank's is taken. Tensors or numpy arrays; the result is of the blocks'
    kind (a fresh array, on the blocks' device)."""
    if mesh_cfg.trivial or spec.kind == REPL:
        return blocks_by_rank[0]
    lead = 1 if spec.stacked else 0
    tp = mesh_cfg.tp

    def cat(parts, axis):
        if isinstance(parts[0], torch.Tensor):
            return torch.cat(parts, axis)
        return np.concatenate(parts, axis)

    if spec.kind == TP_SMALL:
        return cat([blocks_by_rank[m] for m in range(tp)], lead)
    # DIST: rank f * tp + m holds FSDP block f of model row m
    rows = [cat([blocks_by_rank[f * tp + m] for f in range(mesh_cfg.dshards)], -1)
            for m in range(tp if spec.meta.tp_dim is not None else 1)]
    return cat(rows, lead) if spec.meta.tp_dim is not None else rows[0]


def tree_to_local(storage, spec_tree, mesh_cfg: MeshCfg, rank: int):
    """Rank ``rank``'s blocks of a whole storage tree."""
    return tree_map(lambda x, s: local_shard(x, s, mesh_cfg, rank), storage, spec_tree)


def leaf_to_local(x, spec: LeafSpec, mesh_cfg: MeshCfg, rank: int):
    """Rank ``rank``'s block of one logical leaf (``leaf_to_storage``, then
    ``local_shard``), so a caller can lay a model out one leaf at a time
    and free each whole leaf before the next."""
    return local_shard(leaf_to_storage(x, spec, mesh_cfg), spec, mesh_cfg, rank)


def materialize_leaf(
    x,
    spec: LeafSpec,
    mesh_cfg: MeshCfg,
    round_to,
    grad_round_to: int | None = None,
    *,
    key=None,
    group=None,
    index=None,
):
    """Rank-local storage -> TP-local logical weights at ``round_to`` (an
    int or a :class:`~repro_torch.transport.CompressionPolicy`), for one
    layer repetition (``x`` carries no repetition dim). On the trivial
    mesh a ``DIST`` leaf goes through the straight-through pack∘unpack;
    on a sharded mesh its flat shard goes through the compressed
    all-gather over ``group`` (the rank's FSDP group; ``None`` is the
    default group), whose backward reduce-scatters the gradient, and the
    padding is sliced off (with one FSDP rank: the straight-through
    quantize). A ``TP_SMALL`` block drops its size-1 ``tp`` dim; the rest
    are used as stored. ``key`` feeds stochastic rounding; ``index`` (a
    ``DIST`` leaf whose layout is not the reference's) the flat index of
    each element's noise: laid out as ``x`` on the trivial mesh, else
    ``(forward, backward)`` as :func:`~repro_torch.transport.transport.all_gather`
    takes it."""
    policy = policy_for(round_to, grad_round_to)
    if spec.kind == REPL or (mesh_cfg.trivial and spec.kind != DIST):
        return x
    if spec.kind == TP_SMALL:
        return x[0]
    with spans.span("transport.materialize"):
        if mesh_cfg.trivial:
            return _T.quantize(x, policy, key, index)
        flat = x.reshape(-1)
        if mesh_cfg.dshards > 1:
            full = _T.all_gather(flat, group, policy, 0, key, index)
        else:
            full = _T.quantize(flat, policy, key, None if index is None else index[0])
        n = spec.n_local
        if n != full.shape[0]:
            full = full[:n]
        return full.reshape(spec.local_logical)


def build_spec_tree(params, metas, mesh_cfg: MeshCfg):
    """Spec tree matching the LM's ``{"groups": [...], <top leaves>}``
    layout: group subtrees are layer-stacked (leading repetition dim),
    top-level leaves are not."""
    groups = [
        tree_map(lambda x, m: build_leaf_spec(x.shape, m, mesh_cfg, stacked=True), gp, gm)
        for gp, gm in zip(params["groups"], metas["groups"])
    ]
    top = {
        k: build_leaf_spec(params[k].shape, metas[k], mesh_cfg, stacked=False)
        for k in params if k != "groups"
    }
    return {"groups": groups, **top}


def dist_elems_per_group(spec_tree, mesh_cfg: MeshCfg, num_groups: int) -> list[int]:
    """Compressed (``DIST``) element count per precision group (of one
    model rank's slices) — the geometry
    :meth:`~repro_torch.plan.PrecisionPlan.wire_table` multiplies by a
    policy's bytes/element. The last group covers the top-level leaves
    (embedding / head), matching the ``round_tos`` layout."""
    elems = [0] * num_groups

    def visit(idx, leaves):
        for s in leaves:
            if s.kind == DIST:
                elems[idx] += s.s_loc * mesh_cfg.dshards

    for g, gs in enumerate(spec_tree["groups"]):
        visit(g, tree_leaves(gs))
    visit(num_groups - 1, [v for k, v in spec_tree.items() if k != "groups"])
    return elems


def tree_to_storage(params, spec_tree, mesh_cfg: MeshCfg):
    """Lay a parameter tree out in storage form (the identity on the
    trivial mesh: storage is the logical tensors themselves)."""
    if mesh_cfg.trivial:
        return params
    return tree_map(lambda x, s: leaf_to_storage(x, s, mesh_cfg), params, spec_tree)


# ---------------------------------------------------------------------------
# weight-stationary placement (serving)
# ---------------------------------------------------------------------------


def placed_leaf(x, spec: LeafSpec, mesh_cfg: MeshCfg, round_to, *, group=None):
    """Run the leaf's transfer ONCE, giving the rank's resident TP-local
    logical weights (stacked leaves keep their repetition dim, and go
    through the kernels as one tensor). Decode steps built with
    ``weight_stationary=True`` then move no weights at all.

    ``x`` is the rank's storage block. On the trivial mesh a ``DIST`` leaf
    is the straight-through quantize. On a sharded mesh a ``REPL`` leaf
    stays as it is, a ``TP_SMALL`` leaf drops its size-1 ``tp`` dim, and a
    ``DIST`` leaf's flat shard (per repetition) is gathered as planes over
    ``group``, the rank's FSDP group (the ``weights`` class), or quantized
    where it has one FSDP rank, then cut to ``n_local`` and shaped
    ``local_logical``."""
    policy = policy_for(round_to)
    if mesh_cfg.trivial:
        return _T.quantize(x, policy) if spec.kind == DIST else x
    if spec.kind == REPL:
        return x
    if spec.kind == TP_SMALL:
        return x[:, 0] if spec.stacked else x[0]
    axis = 1 if spec.stacked else 0
    flat = x.reshape((spec.reps, -1) if spec.stacked else (-1,))
    if mesh_cfg.dshards > 1:
        full = _T.all_gather(flat, group, policy, axis)
    else:
        full = _T.quantize(flat, policy)
    n = spec.n_local
    if n != full.shape[axis]:
        full = full.narrow(axis, 0, n)
    lead = (spec.reps,) if spec.stacked else ()
    return full.reshape(lead + spec.local_logical)


def materialize_placed_leaf(x, spec: LeafSpec, mesh_cfg: MeshCfg):
    """Placed weights are already TP-local and logical: the identity."""
    return x
