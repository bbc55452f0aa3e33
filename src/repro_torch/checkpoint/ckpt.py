"""Checkpoint entry points over :mod:`repro_torch.checkpoint.sharded`
(counterpart of ``repro.checkpoint.ckpt``).

* :func:`save_checkpoint` — writes the width-aware sharded directory
  ``<path>.ckpt/`` (``spec_tree=`` / ``round_tos=`` store compressible
  fp32 leaves as width-sized wire tiers + residual tiers, ``extra=`` e.g.
  the data pipeline's position, ``async_ckpt=`` an
  :class:`~repro_torch.checkpoint.sharded.AsyncCheckpointer` to overlap
  the write with the next step);
* :func:`load_checkpoint` / :func:`load_storage` / :func:`load_plan` /
  :func:`load_extra` — read the sharded directory, or a legacy ``.npz``
  (one fp32 array ``a{i}`` a leaf in flatten order, and a ``__meta__``
  JSON string) if that is what is on disk.

On a sharded mesh (``mesh_cfg=`` and ``spec_tree=``; every rank calls
alike, its trees its blocks) a save gathers to rank 0, which writes the
global state, and a load (a legacy ``.npz`` too) reads on rank 0 and
scatters each rank its blocks
(:mod:`repro_torch.checkpoint.sharded`'s docstring). :func:`load_plan` and
:func:`load_extra` read ``meta.json`` where they are called.

Structure mismatches raise
:class:`~repro_torch.checkpoint.sharded.CheckpointError` naming the first
mismatching key path.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch.distributed as dist

from repro_torch.checkpoint.sharded import (
    AsyncCheckpointer,
    CheckpointError,
    awp_from_meta,
    checked_on_rank0,
    global_like,
    leaf_entries,
    load_sharded,
    read_meta,
    save_sharded,
    scatter_tree,
    to_like,
    tree_from_entries,
)
from repro_torch.plan import PrecisionPlan

__all__ = [
    "CheckpointError",
    "AsyncCheckpointer",
    "ckpt_dir",
    "save_checkpoint",
    "load_checkpoint",
    "load_storage",
    "load_plan",
    "load_extra",
]


def ckpt_dir(path: str) -> str:
    """The sharded directory of a user-given path: ``foo.npz`` (or bare
    ``foo``) maps to ``foo.ckpt``, so save and load agree on the name."""
    if path.endswith(".npz"):
        path = path[: -len(".npz")]
    if not path.endswith(".ckpt"):
        path = path + ".ckpt"
    return path


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_checkpoint(path: str, storage, opt_state, awp, step: int,
                    plan: PrecisionPlan | None = None, *, spec_tree=None, round_tos=None,
                    extra: dict | None = None, residuals: bool = True,
                    async_ckpt: AsyncCheckpointer | None = None, mesh_cfg=None):
    """Write the sharded checkpoint at ``ckpt_dir(path)``; returns the
    manifest. With ``async_ckpt`` the files are written on its worker
    thread and this returns ``None`` once the state is copied to the host
    (``async_ckpt.wait()`` before reading it back). Width-aware tiers need
    ``spec_tree`` and the AWP controller's *current* ``round_tos``; a save
    across ranks ``mesh_cfg`` and ``spec_tree`` (it returns the manifest on
    every rank)."""
    target = ckpt_dir(path)
    parent = os.path.dirname(target)
    if parent:
        os.makedirs(parent, exist_ok=True)
    kw = dict(plan=plan, spec_tree=spec_tree, round_tos=round_tos, extra=extra,
              residuals=residuals, mesh_cfg=mesh_cfg)
    if async_ckpt is not None:
        async_ckpt.save(target, storage, opt_state, awp, step, **kw)
        return None
    return save_sharded(target, storage, opt_state, awp, step, **kw)


# ---------------------------------------------------------------------------
# legacy .npz
# ---------------------------------------------------------------------------


def _legacy_load(path: str):
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["__meta__"]))
    return data, meta


def _check_count(meta, want, *, at_least: bool, target: str = "restore target"):
    n = meta["num_arrays"]
    if n < len(want) or (n > len(want) and not at_least):
        at = want[n][0] if n < len(want) else f"<checkpoint leaf {len(want)}>"
        raise CheckpointError(f"checkpoint holds {n} leaves, {target} has {len(want)} "
                              f"(first unmatched: {at})")


def _check_shapes(data, want):
    for i, (kpath, like) in enumerate(want):
        got = data[f"a{i}"].shape
        if tuple(like.shape) != tuple(got):
            raise CheckpointError(f"checkpoint shape mismatch at {kpath}: checkpoint "
                                  f"{tuple(got)} vs target {tuple(like.shape)}")


def _legacy_tree(path, like, check, spec_tree=None, mesh_cfg=None):
    """``(like's structure with the .npz's leaves, meta)``: ``check(data,
    meta, want)`` raises on a mismatch, ``want`` the target's entries (on a
    sharded mesh the global shapes, checked and read on rank 0, each rank
    given its blocks)."""
    if mesh_cfg is None or mesh_cfg.trivial:
        data, meta = _legacy_load(path)
        want = leaf_entries(like)
        check(data, meta, want)
        return tree_from_entries(like, {p: to_like(np.array(data[f"a{i}"]), x)
                                        for i, (p, x) in enumerate(want)}), meta
    state = {}

    def run():
        state["data"], state["meta"] = _legacy_load(path)
        check(state["data"], state["meta"], leaf_entries(global_like(like, spec_tree, mesh_cfg)))

    checked_on_rank0(run)
    meta = [state.get("meta")]
    dist.broadcast_object_list(meta, src=0)
    idx = {p: i for i, (p, _) in enumerate(leaf_entries(like))}
    tree = scatter_tree(like, spec_tree, mesh_cfg,
                        lambda p: np.array(state["data"][f"a{idx[p]}"]))
    return tree, meta[0]


def _legacy_checkpoint(path, storage_like, opt_like, awp, spec_tree=None, mesh_cfg=None):
    def check(data, meta, want):
        _check_count(meta, want, at_least=False)

    specs = (spec_tree, spec_tree) if spec_tree is not None else None
    (storage, opt_state), meta = _legacy_tree(path, (storage_like, opt_like), check, specs,
                                              mesh_cfg)
    awp_from_meta(awp, meta.get("awp"))
    return storage, opt_state, meta["step"]


def _legacy_storage(path, storage_like, spec_tree=None, mesh_cfg=None):
    def check(data, meta, want):
        _check_count(meta, want, at_least=True, target="storage target")
        _check_shapes(data, want)

    storage, meta = _legacy_tree(path, storage_like, check, spec_tree, mesh_cfg)
    return storage, meta["step"]


def _resolve(path: str) -> tuple[str, bool]:
    """``(location, is_sharded)`` of the checkpoint at ``path``: the sharded
    directory if there is one, else a legacy ``.npz``."""
    d = ckpt_dir(path)
    if os.path.isdir(d):
        return d, True
    npz = _npz_path(path)
    if os.path.isfile(npz):
        return npz, False
    raise CheckpointError(f"no checkpoint found at {d!r} or {npz!r}")


def load_checkpoint(path: str, storage_like, opt_like, awp=None, *, quality: str = "exact",
                    spec_tree=None, mesh_cfg=None):
    """Restore ``(storage, opt_state, step)`` (and the AWP controller's
    state, in place) into the structure and devices of the ``*_like``
    trees. ``quality`` as :func:`load_sharded`; a legacy ``.npz`` is
    always full precision. On a sharded mesh (``mesh_cfg``, ``spec_tree``)
    the ``*_like`` trees are the rank's blocks and every rank calls."""
    loc, sharded = _resolve(path)
    if not sharded:
        return _legacy_checkpoint(loc, storage_like, opt_like, awp, spec_tree, mesh_cfg)
    storage, opt_state, step, _ = load_sharded(loc, storage_like, opt_like, awp,
                                               quality=quality, spec_tree=spec_tree,
                                               mesh_cfg=mesh_cfg)
    return storage, opt_state, step


def load_storage(path: str, storage_like, *, quality: str = "exact", spec_tree=None,
                 mesh_cfg=None):
    """Weights-only restore for serving (no momentum tree is read);
    returns ``(storage, step)``. ``quality="wire"`` reads only the
    width-priced tiers, the truncated view a serving replica would get
    over the wire. Across ranks as :func:`load_checkpoint`."""
    loc, sharded = _resolve(path)
    if not sharded:
        return _legacy_storage(loc, storage_like, spec_tree, mesh_cfg)
    storage, _, step, _ = load_sharded(loc, storage_like, None, None, quality=quality,
                                       spec_tree=spec_tree, mesh_cfg=mesh_cfg)
    return storage, step


def load_plan(path: str) -> PrecisionPlan | None:
    """The PrecisionPlan saved with the checkpoint (``None`` without one)."""
    loc, sharded = _resolve(path)
    meta = read_meta(loc) if sharded else _legacy_load(loc)[1]
    plan = meta.get("plan")
    return PrecisionPlan.from_json_dict(plan) if plan is not None else None


def load_extra(path: str) -> dict:
    """The free-form ``extra`` state of a sharded checkpoint (e.g. the data
    pipeline's position); ``{}`` for a legacy ``.npz``."""
    loc, sharded = _resolve(path)
    if not sharded:
        return {}
    return read_meta(loc).get("extra") or {}
