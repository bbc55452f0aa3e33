"""Storage layout of parameter leaves (the trivial-mesh part of
``repro.dist.spec``).

Every parameter leaf is classified into one of three storage *kinds*:

  * ``DIST`` — large / compressible (``meta.compress`` and at least
    ``compress_min_size`` elements): materialization moves its fp32
    master copy as byte planes through :mod:`repro_torch.transport`.
  * ``TP_SMALL`` — small but TP-sheared (only on meshes with ``tp > 1``).
  * ``REPL`` — small replicated leaves (biases, norm scales, and weights
    under ``compress_min_size``): stored and used as they are.

Kind assignment depends only on the logical shape, the
:class:`~repro_torch.models.meta.ParamMeta` and ``compress_min_size``,
never on the mesh geometry, exactly as in the reference.

The port runs on one device, the trivial mesh (``tp == 1 and
dshards == 1``): storage *is* the logical tensor and materialization of a
``DIST`` leaf is the straight-through format truncation (per use, or once
under weight-stationary serving, :func:`placed_leaf`). Sharded layouts
raise ``NotImplementedError`` until the data-parallel slice.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.models.meta import COMPRESS_MIN_SIZE, ParamMeta
from repro_torch.transport import policy_for
from repro_torch.transport import transport as _T
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


def _require_trivial(mesh_cfg: MeshCfg) -> None:
    if not mesh_cfg.trivial:
        raise NotImplementedError(
            f"only the trivial mesh is ported (got tp={mesh_cfg.tp}, "
            f"dshards={mesh_cfg.dshards})"
        )


def leaf_to_storage(x, spec: LeafSpec, mesh_cfg: MeshCfg):
    """Lay one logical leaf out in storage form (the identity on the
    trivial mesh)."""
    _require_trivial(mesh_cfg)
    return x


def materialize_leaf(
    x,
    spec: LeafSpec,
    mesh_cfg: MeshCfg,
    round_to,
    *,
    key=None,
):
    """Storage -> logical weights: ``DIST`` leaves go through the
    straight-through pack∘unpack at ``round_to`` (an int or a
    :class:`~repro_torch.transport.CompressionPolicy`); the rest are used
    as stored."""
    _require_trivial(mesh_cfg)
    if spec.kind == DIST:
        return _T.quantize(x, policy_for(round_to), key)
    return x


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
    """Compressed (``DIST``) element count per precision group — the
    geometry :meth:`~repro_torch.plan.PrecisionPlan.wire_table` multiplies
    by a policy's bytes/element. The last group covers the top-level
    leaves (embedding / head), matching the ``round_tos`` layout."""
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
    """Lay the LM tree out in storage form (the identity on the trivial
    mesh: storage is the logical tensors themselves)."""
    _require_trivial(mesh_cfg)
    return params


# ---------------------------------------------------------------------------
# weight-stationary placement (serving)
# ---------------------------------------------------------------------------


def placed_leaf(x, spec: LeafSpec, mesh_cfg: MeshCfg, round_to):
    """Run the leaf's transfer ONCE, giving resident logical weights
    (stacked leaves keep their repetition dim, and go through the kernels
    as one tensor). Decode steps built with ``weight_stationary=True``
    then move no weights at all."""
    _require_trivial(mesh_cfg)
    if spec.kind == DIST:
        return _T.quantize(x, policy_for(round_to))
    return x


def materialize_placed_leaf(x, spec: LeafSpec, mesh_cfg: MeshCfg):
    """Placed weights are already logical: the identity."""
    return x
