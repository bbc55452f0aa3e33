"""``input_specs()`` — stand-ins for every model input (counterpart of
``repro.configs.shapes``).

The reference returns ``jax.ShapeDtypeStruct``s; here each input is a
tensor on the ``meta`` device: shape and dtype, no storage, nothing
allocated. The modality frontends are stubs, as in the reference: audio
supplies frame embeddings, VLM supplies patch embeddings.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import InputShape, ModelConfig


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """``{name: meta tensor}`` of one step's inputs at ``shape``: train
    ``tokens`` (or, under the input stub, fp32 ``features`` ``(B, S,
    vision_dim)``) and ``labels`` ``(B, S)``; prefill the same without
    labels; a VLM's train and prefill also fp32 ``image_features`` ``(B,
    num_image_tokens, vision_dim)``; decode ``tokens`` ``(B, 1)`` and a
    0-d ``pos``; ids int32."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        if cfg.embed_is_input_stub:
            batch = {"features": _spec((B, S, cfg.vision_dim), torch.float32)}
        else:
            batch = {"tokens": _spec((B, S), torch.int32)}
        if shape.kind == "train":
            batch["labels"] = _spec((B, S), torch.int32)
        if cfg.num_image_tokens:
            batch["image_features"] = _spec((B, cfg.num_image_tokens, cfg.vision_dim),
                                            torch.float32)
        return batch
    if shape.kind == "decode":
        return {"tokens": _spec((B, 1), torch.int32), "pos": _spec((), torch.int32)}
    raise ValueError(shape.kind)


def applicable(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """Whether this (arch, shape) combo runs, with the recorded reason."""
    if shape.kind == "decode" and not cfg.causal:
        return False, "encoder-only: no decode step (DESIGN.md §5)"
    return True, ""
