"""``input_specs()`` — stand-ins for every model input (counterpart of
``repro.configs.shapes``).

The reference returns ``jax.ShapeDtypeStruct``s; here each input is a
tensor on the ``meta`` device: shape and dtype, no storage, nothing
allocated. The dense LM takes token ids (the reference's audio and vision
stubs come with their model families).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import InputShape, ModelConfig


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """``{name: meta tensor}`` of one step's inputs at ``shape``: train
    ``tokens`` and ``labels`` ``(B, S)``; prefill ``tokens`` ``(B, S)``;
    decode ``tokens`` ``(B, 1)`` and a 0-d ``pos``; all int32."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"tokens": _spec((B, S), torch.int32), "labels": _spec((B, S), torch.int32)}
    if shape.kind == "prefill":
        return {"tokens": _spec((B, S), torch.int32)}
    if shape.kind == "decode":
        return {"tokens": _spec((B, 1), torch.int32), "pos": _spec((), torch.int32)}
    raise ValueError(shape.kind)


def applicable(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """Whether this (arch, shape) combo runs, with the recorded reason."""
    if shape.kind == "decode" and not cfg.causal:
        return False, "encoder-only: no decode step (DESIGN.md §5)"
    return True, ""
