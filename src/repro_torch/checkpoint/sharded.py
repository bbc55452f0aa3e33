"""Width-aware async sharded checkpoints (counterpart of
``repro.checkpoint.sharded``; the directory is byte-equal to the
reference's for the same state, and each package reads the other's).

  * **per-leaf shards** — every storage / optimizer leaf is its own file,
    written through :mod:`repro_torch.utils.planes` (MSB-first byte
    planes, the transport's);
  * **width-aware tiers** — a compressible (``DIST``) fp32 leaf of a
    precision group at ``rt`` bytes is split at the AWP controller's
    width: the *wire tier* (``leaf.w.bin``) holds planes ``[0, rt)``,
    exactly ``elems · rt`` bytes, and the *residual tier* (``leaf.r.bin``)
    planes ``[rt, 4)``. Both tiers read back bitwise fp32 (a resume is
    exact under any AWP trajectory); the wire tier alone is the
    transport's truncation (the serving restore, and ``residuals=False``
    exports, move and keep only the width-priced bytes);
  * **async overlap** — :class:`AsyncCheckpointer` copies the state to the
    host and snapshots the AWP state synchronously, then splits planes
    and writes the files on a worker thread while the next train step
    runs.

Leaves are flattened as the reference's ``jax.tree_util`` flattens them
(:func:`leaf_entries`: dict keys sorted, lists and tuples by index, key
paths joined with ``/``), so the manifest's leaf order, its file numbers
(``storage_00012.w.bin``) and its key paths are the reference's whatever
order the port's dicts were built in.

``meta.json`` records the step, the
:class:`~repro_torch.plan.PrecisionPlan`, the AWP controller state, free-form
``extra`` state (the data pipeline's resumable position rides here) and a
per-leaf manifest (key path, dtype, shape, width, tier byte sizes) —
the numbers :func:`repro_torch.roofline.analysis.train_checkpoint_bytes`
gives analytically.

The codec is numpy on the host. Loading gives fresh, writable, contiguous
tensors on the device of the restore target's leaves. Structure mismatches
raise :class:`CheckpointError` naming the key path.

Across ranks (``mesh_cfg`` a sharded mesh, every rank of the default
process group calling alike, ``spec_tree`` given): a save gathers each
leaf's blocks to rank 0, which rebuilds the reference's global storage
array (:func:`~repro_torch.dist.spec.storage_to_global`), encodes and
writes it and frees it before the next leaf, so that rank 0 never holds
the whole state; the directory is the reference's ``save_sharded`` of the
same global state at the same mesh. A load reads each leaf on rank 0 and
scatters each rank its block (:func:`~repro_torch.dist.spec.local_shard`),
after rank 0 has checked the manifest against the global shapes the mesh
gives the restore target (the reference's check: a directory written at
another mesh's layout raises as the reference's does). The gathers and
scatters are logged in ``dist.comm.LOG`` under the ``checkpoint`` class,
which no wire table prices. The step, the AWP state and ``extra`` must be
the same on every rank (checked: a save raises otherwise).
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.utils.planes import plane_join, plane_split

META = "meta.json"
FP32 = np.dtype(np.float32)
VALID_QUALITIES = ("exact", "wire")


class CheckpointError(Exception):
    """Checkpoint structure / format mismatch."""


# ---------------------------------------------------------------------------
# tree walking
# ---------------------------------------------------------------------------


def np_dtype(leaf) -> np.dtype:
    """The numpy dtype of a tensor's or an array's elements."""
    if isinstance(leaf, torch.Tensor):
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return np.dtype(leaf.dtype)


def _walk(tree, prefix: tuple):
    """``(key path parts, leaf)`` in the reference's flatten order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, prefix + (str(i),))
    else:
        yield prefix, tree


def leaf_entries(tree) -> list[tuple[str, object]]:
    """Flatten a tree of nested dicts / lists / tuples to ``[(key_path,
    leaf), ...]`` in ``jax.tree_util``'s order: the manifest's leaf order
    and the unit of the structure check."""
    return [("/".join(parts), leaf) for parts, leaf in _walk(tree, ())]


def tree_from_entries(like, leaves: dict):
    """``like``'s structure (its own dict order) with each leaf replaced by
    ``leaves[key_path]``."""
    def build(node, prefix):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(v, prefix + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, prefix + (str(i),)) for i, v in enumerate(node))
        return leaves["/".join(prefix)]

    return build(like, ())


def assign_widths(storage_like, spec_tree, round_tos) -> dict[str, int]:
    """Per-leaf on-disk width (bytes an element) at the controller's
    current formats: compressible (``DIST``) fp32 leaves take their
    precision group's ``round_to`` (group ``g`` for ``groups[g]``, the last
    entry for top-level leaves, the layout of ``dist_elems_per_group``);
    everything else stays at full width. The writer and the analytic byte
    model share it."""
    from repro_torch.dist.spec import DIST, LeafSpec

    rts = tuple(int(r) for r in round_tos)
    widths: dict[str, int] = {}

    def visit(prefix, sub_storage, sub_spec, rt):
        for (path, leaf), (_, spec) in zip(leaf_entries(sub_storage), leaf_entries(sub_spec)):
            dt = np_dtype(leaf)
            w = dt.itemsize
            if isinstance(spec, LeafSpec) and spec.kind == DIST and dt == FP32:
                w = min(rt, dt.itemsize)
            # a bare leaf flattens to an empty key path: the key is the prefix
            widths["/".join(p for p in (prefix, path) if p)] = w

    for g, gs in enumerate(storage_like["groups"]):
        visit(f"groups/{g}", gs, spec_tree["groups"][g], rts[g])
    for k in storage_like:
        if k != "groups":
            visit(k, storage_like[k], spec_tree[k], rts[-1])
    return widths


def host_array(leaf, *, copy: bool = False) -> np.ndarray:
    """A leaf on the host as a numpy array. ``copy`` makes it a snapshot
    on every device: on the CPU ``Tensor.numpy()`` shares the tensor's
    memory, which an in-place optimizer step overwrites."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        return (t.to("cpu", copy=True) if copy else t.cpu()).numpy()
    return np.array(leaf, copy=True) if copy else np.asarray(leaf)


# ---------------------------------------------------------------------------
# AWP state <-> manifest meta
# ---------------------------------------------------------------------------


def awp_to_meta(awp) -> dict | None:
    """An AWPController's host-mutable state as plain JSON. The async path
    calls it before its worker starts (the controller changes every step).
    A dict passes through (already a snapshot), as does ``None``."""
    if awp is None or isinstance(awp, dict):
        return awp
    return {
        "bits": awp.state.bits.tolist(),
        "counters": awp.state.counters.tolist(),
        "prev_norms": (awp.state.prev_norms.tolist()
                       if awp.state.prev_norms is not None else None),
        "step": awp.state.step,
        "history": [[s, list(b)] for s, b in awp.history],
    }


def awp_from_meta(awp, meta: dict | None) -> None:
    if awp is None or not meta:
        return
    awp.state.bits = np.asarray(meta["bits"], np.int64)
    awp.state.counters = np.asarray(meta["counters"], np.int64)
    awp.state.prev_norms = (np.asarray(meta["prev_norms"])
                            if meta["prev_norms"] is not None else None)
    awp.state.step = meta["step"]
    awp.history = [(s, tuple(b)) for s, b in meta["history"]]


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------


def encode_leaf(arr: np.ndarray, width: int, residuals: bool):
    """One leaf -> ``(wire, res, info)``: the tier byte strings and the
    manifest entry's fields. The wire tier of a tiered fp32 leaf is planes
    ``[0, width)`` plane-major, exactly ``elems · width`` bytes; ``res`` is
    ``None`` for untiered leaves or ``residuals=False``. The one tier codec
    of the checkpoint writer (and of the fleet fabric's weight parcels)."""
    if tiered_at(arr.dtype, width):
        return _tiers(plane_split(arr, None if residuals else width), arr.shape, width,
                      residuals)
    wire = np.ascontiguousarray(arr).tobytes()
    return wire, None, _info(arr.dtype, arr.shape, arr.dtype.itemsize, wire, None, False)


def tiered_at(dtype, width: int) -> bool:
    """Whether a leaf of ``dtype`` is stored as planes at ``width``: fp32
    below full width."""
    return np.dtype(dtype) == FP32 and width < FP32.itemsize


def _tiers(planes: np.ndarray, shape, width: int, residuals: bool):
    """An fp32 leaf's ``(wire, res, info)`` from its planes ``(k, n)``
    (``k`` at least ``width``, all 4 with ``residuals``)."""
    wire = planes[:width].tobytes()
    res = planes[width:].tobytes() if residuals else None
    return wire, res, _info(FP32, shape, width, wire, res, True)


def _info(dtype, shape, width, wire, res, tiered) -> dict:
    return {
        "dtype": np.dtype(dtype).str,
        "shape": list(shape),
        "width": int(width),
        "bytes": len(wire),
        "residual_bytes": len(res) if res is not None else 0,
        "tiered": bool(tiered),
    }


def encode_gathered(leaf, spec, mesh_cfg, width: int, residuals: bool):
    """:func:`encode_leaf` of a leaf's global storage array (the reference's
    ``np.asarray`` of its sharded leaf) from this rank's block ``leaf``, on
    every rank (every rank calls): a tiered leaf's block is split into
    planes on each rank and only the planes its tiers keep are all-gathered
    (``comm`` traffic ``checkpoint``), then laid out plane by plane by
    ``storage_to_global``; an untiered leaf's blocks are gathered whole."""
    from repro_torch.dist import comm
    from repro_torch.dist.spec import storage_shape, storage_to_global

    arr = host_array(leaf)
    if not tiered_at(arr.dtype, width):
        blocks = comm.all_gather(torch.from_numpy(arr)[None], traffic="checkpoint")
        return encode_leaf(storage_to_global([b.numpy() for b in blocks], spec, mesh_cfg),
                           width, residuals)
    keep = FP32.itemsize if residuals else width
    planes = torch.from_numpy(plane_split(arr, keep).reshape(keep, *arr.shape))
    blocks = comm.all_gather(planes[None], traffic="checkpoint")  # (ranks, keep, *block)
    del planes
    glob = np.stack([storage_to_global([b[k].numpy() for b in blocks], spec, mesh_cfg).reshape(-1)
                     for k in range(keep)])
    return _tiers(glob, storage_shape(spec, mesh_cfg), width, residuals)


def decode_leaf(wire: bytes, e: dict, quality: str, res: bytes | None = None, *,
                where: str = "checkpoint", select=None) -> np.ndarray:
    """Inverse of :func:`encode_leaf`: tier bytes + manifest entry -> a
    fresh, writable, contiguous array. ``quality="exact"`` needs the
    residual tier of a tiered leaf; ``"wire"`` zero-fills the dropped
    planes (the transport's truncation). ``select`` (an array of the
    leaf's shape -> a fresh array of a part of it, such as a rank's block)
    decodes that part only: it is applied to each plane before the join."""
    dtype = np.dtype(e["dtype"])
    shape = tuple(e["shape"])
    wire_u8 = np.frombuffer(wire, np.uint8)
    if not e["tiered"]:
        arr = wire_u8.view(dtype).reshape(shape)
        return arr.copy() if select is None else select(arr)
    n = int(np.prod(shape)) if shape else 1
    planes = wire_u8.reshape(e["width"], n)
    if quality == "exact":
        if res is None:
            raise CheckpointError(
                f"exact restore of {e['path']} needs the residual tier, but this {where} "
                f"was written residuals=False (width {e['width']}); use quality='wire'")
        planes = np.concatenate([
            planes, np.frombuffer(res, np.uint8).reshape(FP32.itemsize - e["width"], n)])
    if select is not None:
        parts = [select(p.reshape(shape)) for p in planes]
        shape = parts[0].shape
        planes = np.stack([p.reshape(-1) for p in parts])
    return plane_join(planes, dtype, shape)


def _write_leaf(arr: np.ndarray, width: int, base: str, residuals: bool) -> dict:
    wire, res, info = encode_leaf(arr, width, residuals)
    with open(base + ".w.bin", "wb") as f:
        f.write(wire)
    if res is not None:
        with open(base + ".r.bin", "wb") as f:
            f.write(res)
    return info


def _across_ranks(mesh_cfg) -> bool:
    return mesh_cfg is not None and not mesh_cfg.trivial


def _host_leaves(tree):
    """``(key path, host array)`` of each leaf of a one-device tree."""
    for kpath, leaf in leaf_entries(tree):
        yield kpath, host_array(leaf)  # the device->host copy happens here


def _gathered_leaves(tree, spec_tree, mesh_cfg):
    """``(key path, global storage array)`` of each leaf, gathered to rank 0
    one leaf at a time (``None`` on the other ranks, which only send)."""
    from repro_torch.dist import comm
    from repro_torch.dist.spec import storage_to_global

    specs = dict(leaf_entries(spec_tree))
    for kpath, leaf in leaf_entries(tree):
        blocks = comm.gather(leaf.detach(), traffic="checkpoint")
        arr = (None if blocks is None else
               storage_to_global([b.numpy() for b in blocks], specs[kpath], mesh_cfg))
        del blocks
        yield kpath, arr


def _write_dir(path: str, sources, widths: dict, residuals: bool, head: dict) -> dict:
    """Write ``sources`` (``(tree name, leaves)``, leaves yielding ``(key
    path, host array)``) at ``path`` through a ``.tmp.<pid>`` sibling, one
    leaf at a time; returns the manifest."""
    tmp = path + f".tmp.{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    trees = {}
    for tree_name, leaves in sources:
        entries = []
        for i, (kpath, arr) in enumerate(leaves):
            width = (widths.get(kpath, arr.dtype.itemsize) if tree_name == "storage"
                     else arr.dtype.itemsize)
            info = _write_leaf(arr, width, os.path.join(tmp, f"{tree_name}_{i:05d}"), residuals)
            del arr
            info["path"] = kpath
            info["file"] = f"{tree_name}_{i:05d}"
            entries.append(info)
        trees[tree_name] = entries
    meta = {**head, "residuals": bool(residuals), "trees": trees}
    with open(os.path.join(tmp, META), "w") as f:
        json.dump(meta, f)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    return meta


def _same_on_ranks(what: str, value) -> None:
    """Raise unless ``value`` (JSON) is the same on every rank."""
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, json.dumps(value, sort_keys=True))
    bad = [r for r, v in enumerate(got) if v != got[0]]
    if bad:
        raise CheckpointError(f"checkpoint {what} differs on ranks {bad} from rank 0's")


def _gather_trees(storage, opt_state, spec_tree, mesh_cfg, head: dict):
    """The checks and the gathers of a save across ranks: ``(storage,
    opt)`` leaf sources (global arrays on rank 0, ``None`` elsewhere)."""
    if spec_tree is None:
        raise CheckpointError("a save across ranks needs spec_tree (the storage layout)")
    _same_on_ranks("step, AWP state and extra", [head["step"], head["awp"], head["extra"]])
    return (("storage", _gathered_leaves(storage, spec_tree, mesh_cfg)),
            ("opt", _gathered_leaves(opt_state, spec_tree, mesh_cfg)))


def save_sharded(path: str, storage, opt_state, awp, step: int, *, plan=None, spec_tree=None,
                 round_tos=None, extra: dict | None = None, residuals: bool = True,
                 mesh_cfg=None) -> dict:
    """Write the sharded checkpoint directory at ``path`` atomically (a
    ``.tmp.<pid>`` sibling renamed over it). ``round_tos`` + ``spec_tree``
    give width-aware tiers (pass the controller's *current* formats);
    without them every leaf is full width. ``residuals=False`` drops the
    residual tiers: a width-priced export (the serving hand-off) that
    restores only at ``quality="wire"``. ``awp`` is an ``AWPController``
    or a snapshotted meta dict. Leaves may be tensors on any device or
    numpy arrays. With ``mesh_cfg`` a sharded mesh, ``storage`` and
    ``opt_state`` are each rank's blocks, every rank calls, and rank 0
    writes the global state (module docstring). Returns the manifest (on
    every rank)."""
    head = {
        "version": 1,
        "format": "sharded-v1",
        "step": int(step),
        "plan": plan.to_json_dict() if plan is not None else None,
        "awp": awp_to_meta(awp),
        "extra": extra or {},
    }
    widths: dict[str, int] = {}
    if round_tos is not None:
        if spec_tree is None:
            raise CheckpointError("width-aware save needs spec_tree alongside round_tos")
        widths = assign_widths(storage, spec_tree, round_tos)
    if not _across_ranks(mesh_cfg):
        return _write_dir(path, (("storage", _host_leaves(storage)),
                                 ("opt", _host_leaves(opt_state))), widths, residuals, head)
    sources = _gather_trees(storage, opt_state, spec_tree, mesh_cfg, head)
    meta = None
    if dist.get_rank() == 0:
        meta = _write_dir(path, sources, widths, residuals, head)
    else:
        for _, leaves in sources:
            for _ in leaves:  # send each leaf's block in turn
                pass
    out = [meta]
    dist.broadcast_object_list(out, src=0)  # the directory is in place
    return out[0]


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------


def read_meta(path: str) -> dict:
    mp = os.path.join(path, META)
    if not os.path.isfile(mp):
        raise CheckpointError(f"no sharded checkpoint at {path!r}")
    with open(mp) as f:
        return json.load(f)


def _check_structure(entries: list[dict], like, tree_name: str):
    """Manifest against the restore target; names the first mismatching
    key path."""
    want = leaf_entries(like)
    if len(entries) != len(want):
        extra_path = (want[len(entries)][0] if len(want) > len(entries)
                      else entries[len(want)]["path"])
        raise CheckpointError(
            f"checkpoint {tree_name} tree holds {len(entries)} leaves, restore target has "
            f"{len(want)} (first unmatched: {tree_name}/{extra_path})")
    for e, (kpath, leaf) in zip(entries, want):
        if e["path"] != kpath:
            raise CheckpointError(f"checkpoint structure mismatch at {tree_name}/{kpath}: "
                                  f"checkpoint has {tree_name}/{e['path']}")
        if tuple(e["shape"]) != tuple(leaf.shape):
            raise CheckpointError(
                f"checkpoint shape mismatch at {tree_name}/{kpath}: checkpoint "
                f"{tuple(e['shape'])} vs target {tuple(leaf.shape)}")
        if np.dtype(e["dtype"]) != np_dtype(leaf):
            raise CheckpointError(
                f"checkpoint dtype mismatch at {tree_name}/{kpath}: checkpoint "
                f"{np.dtype(e['dtype'])} vs target {np_dtype(leaf)}")


def _read_leaf(path: str, e: dict, quality: str) -> np.ndarray:
    base = os.path.join(path, e["file"])
    with open(base + ".w.bin", "rb") as f:
        wire = f.read()
    res = None
    if e["tiered"] and quality == "exact":
        rpath = base + ".r.bin"
        if os.path.isfile(rpath):
            with open(rpath, "rb") as f:
                res = f.read()
    return decode_leaf(wire, e, quality, res)


def to_like(arr: np.ndarray, like):
    """A decoded array as the restore target's leaf: a tensor on the
    target's device (fresh: ``arr`` is a private copy), or the array."""
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(arr).to(like.device)
    return arr


def _load_tree(path: str, entries: list[dict], like, quality: str):
    likes = dict(leaf_entries(like))
    return tree_from_entries(like, {
        e["path"]: to_like(_read_leaf(path, e, quality), likes[e["path"]]) for e in entries})


def global_like(like, spec_tree, mesh_cfg):
    """The shapes and dtypes of the global storage arrays of a rank's
    restore target ``like`` (its blocks) on ``mesh_cfg``: what the
    reference's restore target holds, and what a manifest is checked
    against."""
    from types import SimpleNamespace

    from repro_torch.dist.spec import storage_shape

    specs = dict(leaf_entries(spec_tree))
    return tree_from_entries(like, {
        p: SimpleNamespace(shape=storage_shape(specs[p], mesh_cfg), dtype=np_dtype(x))
        for p, x in leaf_entries(like)})


def checked_on_rank0(check) -> None:
    """Run ``check()`` on rank 0 and raise its :class:`CheckpointError` on
    every rank (the others would wait for rank 0's scatters otherwise)."""
    err = [None]
    if dist.get_rank() == 0:
        try:
            check()
        except CheckpointError as e:
            err[0] = str(e)
    dist.broadcast_object_list(err, src=0)
    if err[0] is not None:
        raise CheckpointError(err[0])


def scatter_tree(like, spec_tree, mesh_cfg, read):
    """``like``'s structure with each leaf this rank's block of a global
    storage array that ``read(key path)`` gives on rank 0 (called there
    only, leaf by leaf): rank 0 cuts every rank's block and scatters them.
    Blocks land on the device of ``like``'s leaves."""
    from repro_torch.dist import comm
    from repro_torch.dist.spec import local_shard

    specs = dict(leaf_entries(spec_tree))
    root, world = dist.get_rank() == 0, dist.get_world_size()
    out = {}
    for kpath, leaf in leaf_entries(like):
        blocks = None
        if root:
            whole = torch.from_numpy(read(kpath))
            blocks = [local_shard(whole, specs[kpath], mesh_cfg, r) for r in range(world)]
            del whole
        out[kpath] = comm.scatter(blocks, leaf, traffic="checkpoint")
        del blocks
    return tree_from_entries(like, out)


def _load_tree(path: str, entries: list[dict], like, quality: str, spec_tree=None,
               mesh_cfg=None):
    by_path = {e["path"]: e for e in entries}
    if _across_ranks(mesh_cfg):
        return scatter_tree(like, spec_tree, mesh_cfg,
                            lambda p: _read_leaf(path, by_path[p], quality))
    likes = dict(leaf_entries(like))
    return tree_from_entries(like, {
        p: to_like(_read_leaf(path, e, quality), likes[p]) for p, e in by_path.items()})


def load_sharded(path: str, storage_like, opt_like=None, awp=None, *, quality: str = "exact",
                 spec_tree=None, mesh_cfg=None):
    """Restore ``(storage, opt_state, step, meta)`` from a sharded dir into
    the structure and devices of ``storage_like`` / ``opt_like`` (whose
    values are not read). ``quality="exact"`` reads wire + residual tiers
    (bitwise fp32, resume-grade); ``"wire"`` only the width-priced tiers
    (the transport's truncation, serving-grade, the only mode a
    ``residuals=False`` export supports). ``opt_like=None`` skips the
    optimizer tree. With ``mesh_cfg`` a sharded mesh (and ``spec_tree``)
    the ``*_like`` trees are each rank's blocks, every rank calls, rank 0
    reads and each rank gets its blocks (module docstring)."""
    if quality not in VALID_QUALITIES:
        raise CheckpointError(f"quality must be in {VALID_QUALITIES}")
    trees = [("storage", storage_like)] + ([("opt", opt_like)] if opt_like is not None else [])
    if _across_ranks(mesh_cfg):
        if spec_tree is None:
            raise CheckpointError("a load across ranks needs spec_tree (the storage layout)")
        meta = [None]

        def check():
            meta[0] = read_meta(path)
            for name, like in trees:
                _check_structure(meta[0]["trees"][name],
                                 global_like(like, spec_tree, mesh_cfg), name)

        checked_on_rank0(check)
        dist.broadcast_object_list(meta, src=0)
        meta = meta[0]
    else:
        meta = read_meta(path)
        for name, like in trees:
            _check_structure(meta["trees"][name], like, name)
    loaded = [_load_tree(path, meta["trees"][name], like, quality, spec_tree, mesh_cfg)
              for name, like in trees]
    storage, opt_state = loaded[0], (loaded[1] if opt_like is not None else None)
    awp_from_meta(awp, meta.get("awp"))
    return storage, opt_state, meta["step"], meta


def manifest_bytes(meta: dict) -> dict:
    """On-disk byte totals of a sharded checkpoint from its manifest:
    ``wire`` (width-priced tiers), ``residual``, ``total``."""
    wire = residual = 0
    for entries in meta["trees"].values():
        for e in entries:
            wire += e["bytes"]
            residual += e["residual_bytes"]
    return {"wire": wire, "residual": residual, "total": wire + residual}


# ---------------------------------------------------------------------------
# async
# ---------------------------------------------------------------------------


class AsyncCheckpointer:
    """Write checkpoints on a worker thread, overlapped with the next train
    step.

    One save in flight at a time: a new :meth:`save` first joins the last
    one (host memory stays at ~one checkpoint). :meth:`save` copies every
    leaf to the host *synchronously*: the port's optimizers update
    storage and momentum in place, so a reference to a tensor is no
    snapshot, on the card or on the CPU (where ``Tensor.numpy()`` shares
    memory). The AWP state and ``extra`` are snapshotted up front too.
    What overlaps the next step is everything after the copy: plane
    splits, tier writes, the manifest. Failures surface on the next
    :meth:`save` / :meth:`wait` as :class:`CheckpointError`.

    Across ranks (``mesh_cfg=`` a sharded mesh, with ``spec_tree=``) the
    copy is the gather of every leaf to rank 0, on the calling thread and
    in the same order on every rank, so that it never interleaves with a
    step's collectives: rank 0 then holds the global state on the host (as
    one device holds its copy) and only its worker thread encodes and
    writes, issuing no collective. The other ranks have no worker; at the
    next :meth:`save` or at :meth:`wait`, which every rank calls alike,
    they wait for rank 0's writer to finish and raise its failure too."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._exc: BaseException | None = None
        self._ranks = False  # the save in flight is across ranks
        self.saves = 0

    @property
    def in_flight(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def save(self, path, storage, opt_state, awp, step, **kw):
        self.wait()
        mesh_cfg = kw.pop("mesh_cfg", None)
        awp_meta = json.loads(json.dumps(awp_to_meta(awp)))
        extra = json.loads(json.dumps(kw.pop("extra", None) or {}))
        if _across_ranks(mesh_cfg):
            self._ranks = True
            self.saves += 1
            sources = _gather_trees(storage, opt_state, kw.get("spec_tree"), mesh_cfg,
                                    {"step": int(step), "awp": awp_meta, "extra": extra})
            snaps = [dict(leaves) for _, leaves in sources]  # every leaf, now
            if dist.get_rank() != 0:
                return
            host_storage = tree_from_entries(storage, snaps[0])
            host_opt = tree_from_entries(opt_state, snaps[1]) if opt_state is not None else None
        else:
            snap = {p: host_array(x, copy=True) for p, x in leaf_entries(storage)}
            host_storage = tree_from_entries(storage, snap)
            host_opt = None
            if opt_state is not None:
                snap = {p: host_array(x, copy=True) for p, x in leaf_entries(opt_state)}
                host_opt = tree_from_entries(opt_state, snap)
            self.saves += 1

        def work():
            try:
                save_sharded(path, host_storage, host_opt, awp_meta, step, extra=extra, **kw)
            except BaseException as e:  # raised again by wait()
                self._exc = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        exc, self._exc = self._exc, None
        if self._ranks:  # every rank learns how rank 0's writer ended
            self._ranks = False
            msg = [None if exc is None else f"{type(exc).__name__}: {exc}"]
            dist.broadcast_object_list(msg, src=0)
            if msg[0] is not None:
                raise CheckpointError(f"async checkpoint failed on rank 0: {msg[0]}") from exc
        elif exc is not None:
            raise CheckpointError(f"async checkpoint failed: {exc}") from exc
