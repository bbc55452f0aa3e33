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
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

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
    dt = arr.dtype
    tiered = dt == FP32 and width < FP32.itemsize
    if tiered:
        planes = plane_split(arr)
        wire = planes[:width].tobytes()
        res = planes[width:].tobytes() if residuals else None
    else:
        width = dt.itemsize
        wire = np.ascontiguousarray(arr).tobytes()
        res = None
    info = {
        "dtype": dt.str,
        "shape": list(arr.shape),
        "width": int(width),
        "bytes": len(wire),
        "residual_bytes": len(res) if res is not None else 0,
        "tiered": bool(tiered),
    }
    return wire, res, info


def decode_leaf(wire: bytes, e: dict, quality: str, res: bytes | None = None, *,
                where: str = "checkpoint") -> np.ndarray:
    """Inverse of :func:`encode_leaf`: tier bytes + manifest entry -> a
    fresh, writable, contiguous array. ``quality="exact"`` needs the
    residual tier of a tiered leaf; ``"wire"`` zero-fills the dropped
    planes (the transport's truncation)."""
    dtype = np.dtype(e["dtype"])
    shape = tuple(e["shape"])
    wire_u8 = np.frombuffer(wire, np.uint8)
    if not e["tiered"]:
        return wire_u8.view(dtype).reshape(shape).copy()
    n = int(np.prod(shape)) if shape else 1
    planes = wire_u8.reshape(e["width"], n)
    if quality == "exact":
        if res is None:
            raise CheckpointError(
                f"exact restore of {e['path']} needs the residual tier, but this {where} "
                f"was written residuals=False (width {e['width']}); use quality='wire'")
        planes = np.concatenate([
            planes, np.frombuffer(res, np.uint8).reshape(FP32.itemsize - e["width"], n)])
    return plane_join(planes, dtype, shape)


def _write_leaf(arr: np.ndarray, width: int, base: str, residuals: bool) -> dict:
    wire, res, info = encode_leaf(arr, width, residuals)
    with open(base + ".w.bin", "wb") as f:
        f.write(wire)
    if res is not None:
        with open(base + ".r.bin", "wb") as f:
            f.write(res)
    return info


def save_sharded(path: str, storage, opt_state, awp, step: int, *, plan=None, spec_tree=None,
                 round_tos=None, extra: dict | None = None, residuals: bool = True) -> dict:
    """Write the sharded checkpoint directory at ``path`` atomically (a
    ``.tmp.<pid>`` sibling renamed over it). ``round_tos`` + ``spec_tree``
    give width-aware tiers (pass the controller's *current* formats);
    without them every leaf is full width. ``residuals=False`` drops the
    residual tiers: a width-priced export (the serving hand-off) that
    restores only at ``quality="wire"``. ``awp`` is an ``AWPController``
    or a snapshotted meta dict. Leaves may be tensors on any device or
    numpy arrays. Returns the manifest."""
    awp_meta = awp_to_meta(awp)
    widths: dict[str, int] = {}
    if round_tos is not None:
        if spec_tree is None:
            raise CheckpointError("width-aware save needs spec_tree alongside round_tos")
        widths = assign_widths(storage, spec_tree, round_tos)

    tmp = path + f".tmp.{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    trees = {}
    for tree_name, tree in (("storage", storage), ("opt", opt_state)):
        entries = []
        for i, (kpath, leaf) in enumerate(leaf_entries(tree)):
            arr = host_array(leaf)  # the device->host copy happens here
            width = (widths.get(kpath, arr.dtype.itemsize) if tree_name == "storage"
                     else arr.dtype.itemsize)
            info = _write_leaf(arr, width, os.path.join(tmp, f"{tree_name}_{i:05d}"), residuals)
            info["path"] = kpath
            info["file"] = f"{tree_name}_{i:05d}"
            entries.append(info)
        trees[tree_name] = entries
    meta = {
        "version": 1,
        "format": "sharded-v1",
        "step": int(step),
        "plan": plan.to_json_dict() if plan is not None else None,
        "awp": awp_meta,
        "extra": extra or {},
        "residuals": bool(residuals),
        "trees": trees,
    }
    with open(os.path.join(tmp, META), "w") as f:
        json.dump(meta, f)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    return meta


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


def load_sharded(path: str, storage_like, opt_like=None, awp=None, *, quality: str = "exact"):
    """Restore ``(storage, opt_state, step, meta)`` from a sharded dir into
    the structure and devices of ``storage_like`` / ``opt_like`` (whose
    values are not read). ``quality="exact"`` reads wire + residual tiers
    (bitwise fp32, resume-grade); ``"wire"`` only the width-priced tiers
    (the transport's truncation, serving-grade, the only mode a
    ``residuals=False`` export supports). ``opt_like=None`` skips the
    optimizer tree."""
    if quality not in VALID_QUALITIES:
        raise CheckpointError(f"quality must be in {VALID_QUALITIES}")
    meta = read_meta(path)
    _check_structure(meta["trees"]["storage"], storage_like, "storage")
    storage = _load_tree(path, meta["trees"]["storage"], storage_like, quality)
    opt_state = None
    if opt_like is not None:
        _check_structure(meta["trees"]["opt"], opt_like, "opt")
        opt_state = _load_tree(path, meta["trees"]["opt"], opt_like, quality)
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
    :meth:`save` / :meth:`wait` as :class:`CheckpointError`."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._exc: BaseException | None = None
        self.saves = 0

    @property
    def in_flight(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def save(self, path, storage, opt_state, awp, step, **kw):
        self.wait()
        awp_meta = json.loads(json.dumps(awp_to_meta(awp)))
        extra = json.loads(json.dumps(kw.pop("extra", None) or {}))
        snap = {p: host_array(x, copy=True) for p, x in leaf_entries(storage)}
        host_storage = tree_from_entries(storage, snap)
        host_opt = None
        if opt_state is not None:
            snap = {p: host_array(x, copy=True) for p, x in leaf_entries(opt_state)}
            host_opt = tree_from_entries(opt_state, snap)

        def work():
            try:
                save_sharded(path, host_storage, host_opt, awp_meta, step, extra=extra, **kw)
            except BaseException as e:  # raised again by wait()
                self._exc = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        self.saves += 1

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise CheckpointError(f"async checkpoint failed: {exc}") from exc
