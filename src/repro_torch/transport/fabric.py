"""Inter-replica fabric: the metered channel of the fleet's parcels
(counterpart of ``repro.transport.fabric``).

The serving fleet (:mod:`repro_torch.fleet`) moves two classes of bytes
between replicas, both as byte planes:

  * ``kv_migration`` — a prefill worker's freshly written KV pool pages,
    plane-split (:mod:`repro_torch.utils.planes`, MSB-first) and shipped
    at :meth:`~repro_torch.transport.CompressionPolicy.kv_wire_width`
    bytes an element: an uncompressed policy pads every element to raw
    fp32 words, a compressing one drops exactly the pad planes and never
    a resident byte, so the destination pool is bit-equal to a local
    prefill's (int8 pools ship 1 byte an element, bf16 pools 2, fp32
    leaves and int8 scale rows 4);
  * ``weight_publish`` — trainer->replica weight parcels, each leaf
    encoded by the sharded checkpointer's tier codec
    (:func:`repro_torch.checkpoint.sharded.encode_leaf`) at the
    controller's current widths, so a parcel is byte-equal to a
    ``save_sharded`` directory: wire tiers only under a compressing
    publish policy (replicas restore at the transport's truncation), wire
    + residual under an uncompressed one (bitwise fp32).

Leaves are ordered as the reference's ``jax.tree_util`` flattens them
(:func:`~repro_torch.checkpoint.sharded.leaf_entries`: dict keys sorted,
lists by index), so entry *i* of a parcel is entry *i* of the reference's
for the same tree, byte for byte, and each package unpacks the other's
bytes. A parcel's ``structure`` is the tree's own nesting of dicts and
lists with each leaf replaced by its entry index. bf16 leaves travel as
their 16-bit patterns under the dtype name ``"bfloat16"`` (numpy has no
bfloat16 here). :class:`FabricChannel` is the accounting boundary: every
parcel crosses through :meth:`FabricChannel.send`, which logs one hop,
the measured side of :func:`repro_torch.roofline.analysis.fleet_migration_bytes`.

The codec is numpy on the host; an unpacked KV parcel lands as tensors on
the caller's ``device``, a weight parcel on the device of its restore
target's leaves.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from repro_torch.transport.policy import CompressionPolicy
from repro_torch.utils.planes import plane_join, plane_split

#: the two PrecisionPlan traffic classes priced on the fabric
FABRIC_CLASSES = ("kv_migration", "weight_publish")


class FabricError(Exception):
    """Fabric parcel or channel misuse."""


def _skeleton(tree):
    """``tree``'s nesting with each leaf replaced by its index in
    ``leaf_entries`` order."""
    from repro_torch.checkpoint.sharded import leaf_entries, tree_from_entries

    return tree_from_entries(tree, {p: i for i, (p, _) in enumerate(leaf_entries(tree))})


def _fill(structure, leaves):
    """Inverse of :func:`_skeleton`: index ``i`` -> ``leaves[i]``."""
    from repro_torch.checkpoint.sharded import leaf_entries, tree_from_entries

    return tree_from_entries(structure, {p: leaves[i] for p, i in leaf_entries(structure)})


def _host_leaf(leaf) -> tuple[np.ndarray, str]:
    """A leaf on the host and its dtype's name; a bf16 tensor as its
    uint16 bit patterns under ``"bfloat16"``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.uint16), "bfloat16"
        return t.cpu().numpy(), str(t.dtype).removeprefix("torch.")
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, name: str, device) -> torch.Tensor:
    """A fresh, writable tensor on ``device`` (a 1-byte leaf's planes
    rejoin without a copy, as a read-only view of the parcel)."""
    if not arr.flags.writeable:
        arr = arr.copy()
    if name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


# ---------------------------------------------------------------------------
# KV page parcels (prefill -> decode migration)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KVPageParcel:
    """Plane-packed KV pages: one ``(wire, info)`` entry per pool leaf,
    the tree's ``structure``, and free-form routing ``meta`` (request id,
    page count, first token: metadata, not priced wire bytes)."""

    entries: tuple[tuple[bytes, dict], ...]
    structure: object
    meta: dict

    @property
    def nbytes(self) -> int:
        return sum(len(wire) for wire, _ in self.entries)


def pack_kv_pages(pages, policy: CompressionPolicy, *, meta: dict | None = None) -> KVPageParcel:
    """Pack a tree (dicts, lists) of KV page tensors or arrays into a
    parcel: each leaf plane-split and shipped at
    ``policy.kv_wire_width(itemsize)`` bytes an element, all-zero MSB pad
    planes prepended where that exceeds the leaf's itemsize. Lossless by
    construction."""
    from repro_torch.checkpoint.sharded import leaf_entries

    entries = []
    for _, leaf in leaf_entries(pages):
        arr, name = _host_leaf(leaf)
        it = arr.dtype.itemsize
        width = policy.kv_wire_width(it)
        planes = plane_split(arr)
        if width > it:
            planes = np.concatenate([np.zeros((width - it, planes.shape[1]), np.uint8), planes])
        entries.append((planes.tobytes(),
                        {"dtype": name, "shape": list(arr.shape), "width": int(width)}))
    return KVPageParcel(entries=tuple(entries), structure=_skeleton(pages),
                        meta=dict(meta or {}))


def unpack_kv_pages(parcel: KVPageParcel, device="cpu"):
    """Inverse of :func:`pack_kv_pages`, bitwise: drop the pad planes,
    rejoin the leaf's own planes; the tree of tensors on ``device``."""
    leaves = []
    for wire, e in parcel.entries:
        name, shape, width = e["dtype"], tuple(e["shape"]), int(e["width"])
        dtype = np.dtype(np.uint16 if name == "bfloat16" else name)
        n = int(np.prod(shape)) if shape else 1
        if len(wire) != width * n:
            raise FabricError(f"KV parcel leaf carries {len(wire)} bytes, expected "
                              f"{width}x{n} (width x elements)")
        planes = np.frombuffer(wire, np.uint8).reshape(width, n)
        arr = plane_join(planes[width - dtype.itemsize:], dtype, shape)
        leaves.append(_from_host(arr, name, device))
    return _fill(parcel.structure, leaves)


# ---------------------------------------------------------------------------
# weight parcels (trainer -> replica publish)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WeightParcel:
    """Tier-encoded storage tree: ``(wire, res, info)`` a leaf in
    ``leaf_entries`` order, the in-memory twin of a ``save_sharded``
    directory. ``version`` is the publish sequence number replicas key
    their installs on."""

    entries: tuple[tuple[bytes, bytes | None, dict], ...]
    structure: object
    version: int
    step: int
    residuals: bool

    @property
    def nbytes(self) -> int:
        return sum(len(wire) + (len(res) if res is not None else 0)
                   for wire, res, _ in self.entries)

    def manifest_meta(self) -> dict:
        """A manifest-shaped view, so that
        :func:`~repro_torch.checkpoint.sharded.manifest_bytes` prices a
        parcel as it prices a directory."""
        return {"trees": {"storage": [info for _, _, info in self.entries]}}


def pack_weight_parcel(storage, *, spec_tree, round_tos, policy: CompressionPolicy,
                       version: int, step: int = 0, mesh_cfg=None) -> WeightParcel:
    """Encode ``storage`` (tensors on any device, or arrays) at the
    ``round_tos`` widths with the checkpoint tier codec: wire tiers only
    under a compressing ``policy``, wire + residual under an uncompressed
    one. With ``mesh_cfg`` a sharded mesh ``storage`` is this rank's
    blocks, every rank calls, and every rank gets the parcel of the mesh's
    global storage (:func:`~repro_torch.checkpoint.sharded.encode_gathered`),
    as the reference's publisher encodes its global arrays."""
    from repro_torch.checkpoint.sharded import (
        assign_widths,
        encode_gathered,
        encode_leaf,
        host_array,
        leaf_entries,
        np_dtype,
    )

    across = mesh_cfg is not None and not mesh_cfg.trivial
    specs = dict(leaf_entries(spec_tree)) if across else {}
    widths = assign_widths(storage, spec_tree, round_tos)
    residuals = not policy.compresses
    entries = []
    for kpath, leaf in leaf_entries(storage):
        width = widths.get(kpath, np_dtype(leaf).itemsize)
        if across:
            wire, res, info = encode_gathered(leaf, specs[kpath], mesh_cfg, width, residuals)
        else:
            wire, res, info = encode_leaf(host_array(leaf), width, residuals)
        info["path"] = kpath
        entries.append((wire, res, info))
    return WeightParcel(entries=tuple(entries), structure=_skeleton(storage),
                        version=int(version), step=int(step), residuals=residuals)


def unpack_weight_parcel(parcel: WeightParcel, storage_like, *, spec_tree=None,
                         mesh_cfg=None, rank=None):
    """Decode a parcel against a structure-matching restore target: the
    tree of ``storage_like``'s structure with fresh tensors on its leaves'
    device. Residual-bearing parcels restore bitwise (quality
    ``"exact"``), wire-only ones at the transport's truncation
    (``"wire"``), as a ``residuals=False`` checkpoint export loads. With
    ``mesh_cfg`` a sharded mesh (and ``spec_tree`` and the global
    ``rank``) ``storage_like`` is that rank's blocks and the parcel holds
    the mesh's global storage (a publish across ranks): each leaf's planes
    are cut to the rank's block (``dist.spec.local_shard``) and only the
    block is joined; every rank decodes on its own, no collective."""
    from repro_torch.checkpoint.sharded import (
        decode_leaf,
        global_like,
        leaf_entries,
        to_like,
        tree_from_entries,
    )
    from repro_torch.dist.spec import local_shard

    across = mesh_cfg is not None and not mesh_cfg.trivial
    if across and (spec_tree is None or rank is None):
        raise FabricError("a weight parcel restored across ranks needs spec_tree and rank")
    want = leaf_entries(storage_like)
    shapes = dict(leaf_entries(global_like(storage_like, spec_tree, mesh_cfg))) if across else {}
    specs = dict(leaf_entries(spec_tree)) if across else {}
    if len(want) != len(parcel.entries):
        raise FabricError(f"weight parcel holds {len(parcel.entries)} leaves, restore "
                          f"target has {len(want)}")
    quality = "exact" if parcel.residuals else "wire"
    out = {}
    for (wire, res, info), (kpath, leaf) in zip(parcel.entries, want):
        if info["path"] != kpath:
            raise FabricError(f"weight parcel structure mismatch at {kpath}: parcel has "
                              f"{info['path']}")
        shape = tuple(shapes[kpath].shape) if across else tuple(leaf.shape)
        if tuple(info["shape"]) != shape:
            raise FabricError(f"weight parcel shape mismatch at {kpath}: parcel "
                              f"{tuple(info['shape'])} vs target {shape}")
        select = None
        if across:
            def select(a, spec=specs[kpath]):
                with warnings.catch_warnings():  # a view of the parcel's bytes, only read
                    warnings.simplefilter("ignore", UserWarning)
                    return local_shard(torch.from_numpy(a), spec, mesh_cfg, rank).numpy()
        out[kpath] = to_like(decode_leaf(wire, info, quality, res, where="parcel",
                                         select=select), leaf)
    return tree_from_entries(storage_like, out)


# ---------------------------------------------------------------------------
# the channel (the per-hop measured log)
# ---------------------------------------------------------------------------


class FabricChannel:
    """The one priced way to move a parcel between replicas. Each
    :meth:`send` appends ``{"cls", "src", "dst", "bytes"}`` to
    :attr:`hops`, which ``fleet_migration_bytes`` must equal exactly; the
    caller hands the returned parcel to the destination."""

    def __init__(self):
        self.hops: list[dict] = []

    def send(self, parcel, *, cls: str, src: str, dst: str):
        if cls not in FABRIC_CLASSES:
            raise FabricError(f"unknown fabric traffic class {cls!r} (valid: {FABRIC_CLASSES})")
        nbytes = getattr(parcel, "nbytes", None)
        if nbytes is None:
            raise FabricError(f"fabric parcels must expose .nbytes, got {type(parcel)}")
        self.hops.append({"cls": cls, "src": str(src), "dst": str(dst), "bytes": int(nbytes)})
        return parcel

    def wire_summary(self) -> dict:
        """Per-class measured totals and hop counts."""
        out = {cls: 0 for cls in FABRIC_CLASSES}
        counts = {cls: 0 for cls in FABRIC_CLASSES}
        for h in self.hops:
            out[h["cls"]] += h["bytes"]
            counts[h["cls"]] += 1
        out["hops"] = dict(counts)
        out["total"] = sum(out[cls] for cls in FABRIC_CLASSES)
        return out
