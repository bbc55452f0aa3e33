"""The port's trace spans and work counters, off unless turned on.

A span is a ``torch.profiler.record_function`` range at a layer boundary
of the train step, so it shares the profiler's clock with the device's
kernels (under a CUDA profiler the same range also appears on the device
as an annotation). A counter adds up work where it happens, in memory.
Both are off by default: :func:`span` then hands back one shared no-op
context and :func:`add` returns at once, so an untraced step pays a call
and a flag test per boundary.

    with spans.enabled(), torch.profiler.profile(...) as prof:
        trainer.run_step(...)
    # prof.events() holds the ranges named in SPANS; spans.counters() the counts

| span | where |
|---|---|
| ``train.step`` | ``Trainer.run_step``, the whole call |
| ``train.loss_sync`` | the step's ``float(loss)``: the host waits for the device |
| ``train.forward`` | the forward and loss of the LM and CNN steps |
| ``model.loss`` | the LM's ``lm_loss``; the CNN's log-softmax and NLL |
| ``train.backward`` | the steps' ``torch.autograd.grad`` (the remat forward runs in it) |
| ``transport.materialize`` | a ``DIST`` leaf through ``dist.spec.materialize_leaf`` |
| ``optim.sgd`` | ``optim.sgd.sgd_update`` |
| ``awp.monitor`` | the AWP monitor's Σw² (``train.step.awp_group_norms``, the CNN step's) |

Counter ``transport.bytes``: the bytes Bitpack and Bitunpack read and
write (``kernels.ops``), ``n × (4 + round_to)`` a call each way. Counters
``attention.flash_train`` and ``attention.tiled_train``: the train-mode
attention calls (``models.attention.mha``, the remat forward's included)
that take the flash kernels and those that take ``attend_tiled``.
"""
from __future__ import annotations

import contextlib
import threading

import torch

SPANS = (
    "train.step",
    "train.loss_sync",
    "train.forward",
    "model.loss",
    "train.backward",
    "transport.materialize",
    "optim.sgd",
    "awp.monitor",
)
COUNTERS = ("transport.bytes", "attention.flash_train", "attention.tiled_train")

_OFF = contextlib.nullcontext()
_on = False
_counts: dict[str, int] = {}
# the remat forward adds from autograd's device thread
_lock = threading.Lock()


def span(name: str):
    """A ``record_function`` range named ``name`` (one of :data:`SPANS`)
    when tracing is on, else one shared no-op context."""
    if not _on:
        return _OFF
    if name not in SPANS:
        raise ValueError(f"unknown span {name!r}; spans are {SPANS}")
    return torch.profiler.record_function(name)


def add(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` (one of :data:`COUNTERS`) when tracing
    is on."""
    if not _on:
        return
    if name not in COUNTERS:
        raise ValueError(f"unknown counter {name!r}; counters are {COUNTERS}")
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def counters() -> dict[str, int]:
    """The counts added since the last :func:`reset`."""
    with _lock:
        return dict(_counts)


def reset() -> None:
    with _lock:
        _counts.clear()


@contextlib.contextmanager
def enabled(on: bool = True):
    """Tracing on (or off) inside the block; the previous state after it."""
    global _on
    prev, _on = _on, on
    try:
        yield
    finally:
        _on = prev
