"""Double-buffered host->device batch prefetcher (counterpart of
``repro.data.prefetch``).

A background thread walks the shard reader (disk reads, plane decode and
the staging pack, all numpy) while the device runs the current step; the
calling thread only moves the staged arrays onto the device and unpacks
them there, so with a ``depth``-deep queue the ingest work hides behind
the step whenever a batch's host work is cheaper than a train step.

Staged bytes follow the plan's ``host_device``
:class:`~repro_torch.transport.CompressionPolicy`, as the serve engine's
token staging does:

  * integer fields (token streams, labels) are packed into lossless byte
    planes at ``CompressionPolicy.token_wire_width`` (an id of the
    151,936-token vocabulary crosses as 3 bytes under a compressing
    policy, raw int32 under an uncompressed one);
  * float fields cross raw (fp32): lossy staging of training inputs
    would change the optimization problem.

Every batch comes with an ``io_log`` dict: ``shard_read`` (stored bytes
the reader moved off disk), ``host_device`` (bytes staged across the
boundary) and ``data_state`` (the reader's state after this batch, what a
checkpoint written after the matching step persists). The trainer keeps
it per step as ``StepRecord.io_by_entry``, and
:func:`repro_torch.roofline.analysis.train_ingest_bytes` gives both byte
terms analytically.

On a mesh every rank runs its own reader and prefetcher over the same
shards (deterministic from ``seed`` and the data state), so each rank
stages the whole global batch and the train step takes the rank's rows
(``train.step``'s ``P(dp)`` slice, as the reference's step slices its
global batch). Its ``io_log`` bytes are per rank, each rank's equal to
``train_ingest_bytes`` of the global batch: what the reference reckons per
step, where one host reads the batch.
"""
from __future__ import annotations

import queue
import threading

import numpy as np

from repro_torch.transport.hostdev import pack_tokens_host, stage, unpack_tokens
from repro_torch.transport.policy import CompressionPolicy


def resolve_policy(plan_or_policy) -> CompressionPolicy:
    """A plan's first ``host_device`` policy, a policy as given, or the
    uncompressed default for ``None``."""
    pol = plan_or_policy
    if pol is None:
        return CompressionPolicy()
    if hasattr(pol, "host_device_policies"):  # a PrecisionPlan
        return pol.host_device_policies()[0]
    return pol


def staged_ids_per_batch(kind: str, batch: int, seq: int) -> int:
    """Integer ids staged host->device a batch: the geometry term the
    analytic ingest model shares with the measured pack (LM stages each
    row's ``seq+1`` stream once, covering tokens AND labels)."""
    if kind == "lm":
        return batch * (seq + 1)
    if kind == "feature":
        return batch * seq  # labels
    raise ValueError(f"unknown shard kind {kind!r}")


class Prefetcher:
    """Iterate ``(device_batch, io_log)`` over a shard-batch iterator.

    ``batch_iter`` yields ``(host_batch, stored_bytes, state_after)``
    (:func:`repro_torch.data.shards.batches`). ``kind`` ``lm`` slices the
    staged stream into ``tokens`` / ``labels`` on the device; ``feature``
    passes ``features`` / ``labels`` through. Batches land on ``device``
    (the card unless the caller asks for the CPU)."""

    def __init__(self, batch_iter, *, kind: str, vocab: int, plan=None, depth: int = 2,
                 device="cuda"):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        if kind not in ("lm", "feature"):
            raise ValueError(f"unknown shard kind {kind!r}")
        self.kind = kind
        self.vocab = int(vocab)
        self.device = device
        self.policy = resolve_policy(plan)
        self.width = self.policy.token_wire_width(self.vocab)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._err: BaseException | None = None
        self._thread = threading.Thread(target=self._worker, args=(batch_iter,), daemon=True)
        self._thread.start()

    # -- host side (worker thread) -------------------------------------
    def _stage(self, host_batch: dict) -> tuple[dict, int]:
        """Pack one host batch for the crossing; returns the staged arrays
        and their byte count."""
        staged, nbytes = {}, 0
        for name in sorted(host_batch):
            arr = np.asarray(host_batch[name])
            if arr.dtype.kind in ("i", "u"):
                arr = pack_tokens_host(arr, self.width)
            else:
                arr = np.ascontiguousarray(arr)
            staged[name] = arr
            nbytes += arr.nbytes
        return staged, nbytes

    def _worker(self, batch_iter):
        try:
            for host_batch, stored_bytes, state in batch_iter:
                if self._stop.is_set():
                    return
                staged, h2d = self._stage(host_batch)
                log = {"shard_read": stored_bytes, "host_device": h2d, "data_state": state}
                while not self._stop.is_set():
                    try:
                        self._q.put((staged, log), timeout=0.1)
                        break
                    except queue.Full:
                        continue
            self._q.put(None)  # a finite iterator ran out
        except BaseException as e:  # raised again on the consumer's side
            self._err = e
            self._q.put(None)

    # -- device side (calling thread) ----------------------------------
    def next(self) -> tuple[dict, dict]:
        item = self._q.get()
        if item is None:
            err = self._err
            raise err if err is not None else StopIteration()
        staged, log = item
        batch = {}
        for name, v in staged.items():
            x = stage(v, self.device)
            batch[name] = unpack_tokens(x) if v.dtype == np.uint8 else x
        if self.kind == "lm":
            stream = batch.pop("stream")
            batch["tokens"] = stream[:, :-1]
            batch["labels"] = stream[:, 1:]
        return batch, log

    def __iter__(self):
        while True:
            yield self.next()

    def close(self):
        self._stop.set()
        # drain, so that a worker blocked in put() sees the stop flag
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
