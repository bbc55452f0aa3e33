"""Tokenized record shards with tiered (progressive) per-record
compression (counterpart of ``repro.data.shards``; the manifest and every
shard file are byte-equal to the reference's for the same arguments).

  * records are stored as MSB-first **byte planes**
    (:mod:`repro_torch.utils.planes`), so a reader can stop after the
    most significant ``quality`` planes of every float payload: one file
    serves every fidelity, lower tiers read fewer bytes;
  * integer payloads (token ids, labels) are lossless: all-zero most
    significant planes are trimmed at write time, and the remaining
    planes are always read in full whatever ``quality`` says;
  * each plane is optionally zlib-compressed (level 6); the manifest
    records every stored plane size, so the byte accounting is manifest
    arithmetic — :func:`repro_torch.roofline.analysis.train_ingest_bytes`
    and the reader's measured counter come from the same numbers;
  * the order is deterministic and resumable: epoch ``e`` of a reader
    seeded ``s`` visits a permutation drawn from ``SeedSequence([s, e])``,
    and :meth:`ShardReader.state` is a small JSON-serializable dict from
    which a restored reader replays the exact record stream.

On-disk layout (``manifest.json`` + ``shard_*.bin``)::

    out_dir/
      manifest.json        # format/meta + per-record plane-size index
      shard_00000.bin      # records back to back, planes back to back
      shard_00001.bin ...

A record is a ``{field: np.ndarray}`` dict. For each field the manifest
keeps ``lead_skip`` (trimmed zero MSB planes), the stored size of each
plane and the dtype and shape: enough to read any tier of any record with
one seek.
"""
from __future__ import annotations

import dataclasses
import json
import os
import zlib
from typing import Iterator

import numpy as np

from repro_torch.utils.planes import lead_zero_planes, plane_join, plane_split

MANIFEST = "manifest.json"
VALID_CODECS = ("raw", "zlib")
# float dtypes degrade gracefully under plane truncation; everything else
# (ids, labels, masks) must round-trip exactly and ignores ``quality``
_FLOAT_KINDS = ("f",)


def _is_tiered(dtype: np.dtype) -> bool:
    return dtype.kind in _FLOAT_KINDS


def _encode(plane: np.ndarray, codec: str) -> bytes:
    b = plane.tobytes()
    return zlib.compress(b, 6) if codec == "zlib" else b


def _decode(buf: bytes, codec: str) -> np.ndarray:
    b = zlib.decompress(buf) if codec == "zlib" else buf
    return np.frombuffer(b, np.uint8)


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------


class ShardWriter:
    """Write records into ``records_per_shard``-sized shard files.

    ``meta`` is free-form run metadata (vocab size, sequence length,
    generator seed) kept verbatim in the manifest; the launcher checks it
    against the run before training."""

    def __init__(self, out_dir: str, *, kind: str, meta: dict | None = None,
                 codec: str = "zlib", records_per_shard: int = 64):
        if codec not in VALID_CODECS:
            raise ValueError(f"codec must be in {VALID_CODECS}")
        if records_per_shard < 1:
            raise ValueError("records_per_shard must be >= 1")
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.kind = kind
        self.meta = dict(meta or {})
        self.codec = codec
        self.records_per_shard = records_per_shard
        self._shards: list[dict] = []
        self._cur_file = None
        self._cur_records: list[dict] = []
        self._cur_off = 0
        self._closed = False

    def _open_shard(self):
        name = f"shard_{len(self._shards):05d}.bin"
        self._shards.append({"file": name, "records": []})
        self._cur_file = open(os.path.join(self.out_dir, name), "wb")
        self._cur_records = self._shards[-1]["records"]
        self._cur_off = 0

    def append(self, record: dict) -> None:
        if self._closed:
            raise ValueError("writer is closed")
        if self._cur_file is None or len(self._cur_records) >= self.records_per_shard:
            if self._cur_file is not None:
                self._cur_file.close()
            self._open_shard()
        fields = {}
        for name in sorted(record):
            arr = np.asarray(record[name])
            planes = plane_split(arr)
            skip = 0
            if not _is_tiered(arr.dtype):
                skip = lead_zero_planes(planes)
                planes = planes[skip:]
            sizes = []
            for p in planes:
                buf = _encode(p, self.codec)
                self._cur_file.write(buf)
                sizes.append(len(buf))
            fields[name] = {
                "dtype": arr.dtype.str,
                "shape": list(arr.shape),
                "lead_skip": skip,
                "plane_sizes": sizes,
            }
        rec = {"offset": self._cur_off, "fields": fields}
        self._cur_off += sum(s for f in fields.values() for s in f["plane_sizes"])
        self._cur_records.append(rec)

    def close(self) -> dict:
        """Flush, write the manifest (atomically), return it."""
        if self._closed:
            raise ValueError("writer is closed")
        self._closed = True
        if self._cur_file is not None:
            self._cur_file.close()
        manifest = {
            "version": 1,
            "kind": self.kind,
            "codec": self.codec,
            "meta": self.meta,
            "records_per_shard": self.records_per_shard,
            "shards": self._shards,
        }
        tmp = os.path.join(self.out_dir, MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, os.path.join(self.out_dir, MANIFEST))
        return manifest


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------


def _epoch_order(seed: int, epoch: int, n: int) -> np.ndarray:
    """Epoch ``epoch``'s permutation of ``n`` records: a ``Generator`` from
    the entropy words ``[seed, epoch]``, both mapped bijectively to
    non-negative ints, so distinct (seed, epoch) pairs shuffle
    independently and identically across processes and restarts."""
    ent = [int(np.uint64(np.int64(seed))), int(np.uint64(np.int64(epoch)))]
    return np.random.default_rng(ent).permutation(n)


@dataclasses.dataclass
class _RecordRef:
    shard: int
    offset: int
    fields: dict


class ShardReader:
    """Deterministic, resumable, tier-aware reader over a shard directory.

    ``quality``: float payloads read only their ``quality`` most
    significant planes (1..4 for fp32); integer payloads always read every
    stored plane. ``seed`` drives the epoch permutations. :meth:`state` /
    :meth:`load_state` round-trip the position through a JSON-serializable
    dict."""

    def __init__(self, path: str, *, quality: int = 4, seed: int = 0):
        if quality < 1:
            raise ValueError("quality must be >= 1")
        self.path = path
        self.quality = int(quality)
        self.seed = int(seed)
        with open(os.path.join(path, MANIFEST)) as f:
            self.manifest = json.load(f)
        self.kind = self.manifest["kind"]
        self.codec = self.manifest["codec"]
        self.meta = self.manifest.get("meta", {})
        self._refs: list[_RecordRef] = [
            _RecordRef(si, rec["offset"], rec["fields"])
            for si, sh in enumerate(self.manifest["shards"]) for rec in sh["records"]
        ]
        if not self._refs:
            raise ValueError(f"no records under {path!r}")
        self._files: dict[int, object] = {}
        self.epoch = 0
        self.pos = 0
        self._order = _epoch_order(self.seed, 0, len(self._refs))
        self.bytes_read = 0  # measured ingest counter (stored bytes)

    # -- geometry ------------------------------------------------------
    @property
    def num_records(self) -> int:
        return len(self._refs)

    def _planes_kept(self, field: dict) -> int:
        """Stored planes a ``quality``-tier read takes of one field: the one
        formula of the read path and of the byte accounting."""
        stored = len(field["plane_sizes"])
        if not _is_tiered(np.dtype(field["dtype"])):
            return stored
        # stored plane i is logical plane lead_skip + i; keep logical
        # planes [0, quality)
        return max(0, min(stored, self.quality - field["lead_skip"]))

    def record_stored_bytes(self, rid: int) -> int:
        """Stored bytes a read of record ``rid`` moves at this quality
        (manifest arithmetic, no file I/O)."""
        return sum(sum(f["plane_sizes"][: self._planes_kept(f)])
                   for f in self._refs[rid].fields.values())

    def planned_bytes(self, count: int) -> int:
        """Stored bytes the next ``count`` records will read from the
        current position, epoch wraps included; does not advance."""
        total = 0
        epoch, pos, order = self.epoch, self.pos, self._order
        for _ in range(count):
            if pos >= len(order):
                epoch += 1
                pos = 0
                order = _epoch_order(self.seed, epoch, len(self._refs))
            total += self.record_stored_bytes(int(order[pos]))
            pos += 1
        return total

    # -- state ---------------------------------------------------------
    def state(self) -> dict:
        """The position as a JSON-serializable dict: a reader restored from
        it replays the exact record stream from here."""
        return {"seed": self.seed, "epoch": self.epoch, "pos": self.pos,
                "quality": self.quality}

    def load_state(self, state: dict) -> "ShardReader":
        self.seed = int(state["seed"])
        self.epoch = int(state["epoch"])
        self.pos = int(state["pos"])
        self.quality = int(state["quality"])
        self._order = _epoch_order(self.seed, self.epoch, len(self._refs))
        return self

    # -- reading -------------------------------------------------------
    def _file(self, shard: int):
        f = self._files.get(shard)
        if f is None:
            name = self.manifest["shards"][shard]["file"]
            f = open(os.path.join(self.path, name), "rb")
            self._files[shard] = f
        return f

    def read_record(self, rid: int) -> tuple[dict, int]:
        """Record ``rid`` at this quality -> ``(arrays, stored_bytes)``."""
        ref = self._refs[rid]
        f = self._file(ref.shard)
        out = {}
        nbytes = 0
        off = ref.offset
        for name in sorted(ref.fields):
            fld = ref.fields[name]
            keep = self._planes_kept(fld)
            planes = []
            for i, sz in enumerate(fld["plane_sizes"]):
                if i < keep:
                    f.seek(off)
                    planes.append(_decode(f.read(sz), self.codec))
                    nbytes += sz
                off += sz
            n = int(np.prod(fld["shape"])) if fld["shape"] else 1
            stack = np.stack(planes) if planes else np.zeros((0, n), np.uint8)
            out[name] = plane_join(stack, np.dtype(fld["dtype"]), tuple(fld["shape"]),
                                   lead_skip=fld["lead_skip"])
        self.bytes_read += nbytes
        return out, nbytes

    def next_record(self) -> tuple[dict, int]:
        """The next record in the deterministic order (a wrap draws the
        next epoch's permutation) -> ``(arrays, stored_bytes)``."""
        if self.pos >= len(self._order):
            self.epoch += 1
            self.pos = 0
            self._order = _epoch_order(self.seed, self.epoch, len(self._refs))
        rid = int(self._order[self.pos])
        self.pos += 1
        return self.read_record(rid)

    def __iter__(self) -> Iterator[tuple[dict, int]]:
        while True:
            yield self.next_record()

    def close(self):
        for f in self._files.values():
            f.close()
        self._files.clear()


# ---------------------------------------------------------------------------
# batching
# ---------------------------------------------------------------------------


def batches(reader: ShardReader, batch_size: int):
    """Group records into training batches: yields ``(host_batch,
    stored_bytes, state_after)``, the stacked numpy arrays, the shard
    bytes the batch read, and the reader's state *after* the batch — what
    a checkpoint written after the matching train step persists, so that a
    restored run resumes at the next batch (whatever the prefetcher has
    read ahead). LM shards store each record's stream of ``seq+1`` ids
    once; the prefetcher slices tokens and labels from it on the
    device."""
    if batch_size < 1:
        raise ValueError("batch_size must be >= 1")
    while True:
        recs, nbytes = [], 0
        for _ in range(batch_size):
            r, b = reader.next_record()
            recs.append(r)
            nbytes += b
        batch = {k: np.stack([r[k] for r in recs]) for k in sorted(recs[0])}
        yield batch, nbytes, reader.state()


# ---------------------------------------------------------------------------
# synthetic -> shards
# ---------------------------------------------------------------------------


def write_lm_shards(out_dir: str, *, vocab: int, seq: int, num_records: int, seed: int = 0,
                    codec: str = "zlib", records_per_shard: int = 64) -> dict:
    """The synthetic k-gram LM stream as shards: one record a sequence, its
    ``seq+1`` ids stored once."""
    from repro_torch.data.pipeline import synthetic_lm_batch

    w = ShardWriter(out_dir, kind="lm", codec=codec, records_per_shard=records_per_shard,
                    meta={"vocab": int(vocab), "seq": int(seq), "seed": int(seed)})
    for step in range(num_records):
        toks, labels = synthetic_lm_batch(vocab, 1, seq, step, seed=seed, device="cpu")
        stream = np.concatenate([toks[0].numpy(), labels[0, -1:].numpy()]).astype(np.int32)
        w.append({"stream": stream})
    return w.close()


def write_feature_shards(out_dir: str, *, dim: int, vocab: int, seq: int, num_records: int,
                         seed: int = 0, codec: str = "zlib",
                         records_per_shard: int = 64) -> dict:
    """Frame-embedding records (the audio family): float features carry
    the tiered planes the quality knob trades off, labels stay
    lossless."""
    from repro_torch.data.pipeline import synthetic_feature_batch

    w = ShardWriter(out_dir, kind="feature", codec=codec, records_per_shard=records_per_shard,
                    meta={"dim": int(dim), "vocab": int(vocab), "seq": int(seq),
                          "seed": int(seed)})
    for step in range(num_records):
        feats, labels = synthetic_feature_batch(dim, vocab, 1, seq, step, seed=seed,
                                                device="cpu")
        w.append({"features": feats[0].numpy(), "labels": labels[0].numpy()})
    return w.close()
