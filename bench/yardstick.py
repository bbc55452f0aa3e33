"""The benchmark's own arithmetic, frozen here so that a change to the
program cannot move it: the card's published peaks, the model FLOPs of a
training step, and the bytes the weight transfer needs.

Peaks: NVIDIA H100 SXM data sheet, dense: 67 TFLOP/s fp32 outside the
tensor cores (the configurations turn TF32 off), 3.35 TB/s of HBM.
"""
from __future__ import annotations

import math

from bench import inputs

PEAK_FLOPS_FP32 = 67e12
HBM_BYTES_PER_S = 3.35e12
FP32_BYTES = 4


def cnn_forward_flops(doc: dict) -> list[float]:
    """Forward FLOPs of one image, layer by layer (2 a multiply-add): a
    direct convolution's ``2 k^2 Cin Cout H' W'``, a dense layer's
    ``2 in out``."""
    out = []
    for _, kind, shape, fan_in, hw in inputs.cnn_layers(doc):
        if kind == "conv":
            out.append(2.0 * fan_in * shape[0] * hw * hw)
        else:
            out.append(2.0 * shape[0] * shape[1])
    return out


def cnn_step_flops(doc: dict, batch: int) -> float:
    """A training step's model FLOPs: forward, the weight gradient and the
    input gradient of every layer but the first (the images need none)."""
    fwd = cnn_forward_flops(doc)
    return batch * (3.0 * sum(fwd) - fwd[0])


def lm_params(doc: dict) -> int:
    """The matrices' parameters: attention projections, the SwiGLU and
    the embedding (once when the head is tied to it); no norm scales."""
    d, hd, ff = doc["hidden_size"], doc["head_dim"], doc["intermediate_size"]
    h, kv = doc["num_attention_heads"], doc["num_key_value_heads"]
    layer = d * hd * h + 2 * d * hd * kv + hd * h * d + 3 * d * ff
    embed = doc["vocab_size"] * d * (1 if doc["tie_word_embeddings"] else 2)
    return doc["num_hidden_layers"] * layer + embed


def lm_step_flops(doc: dict, tokens: int) -> float:
    """6 N D: a training step's model FLOPs over ``tokens`` tokens, without
    attention's score products and without the recomputed forward."""
    return 6.0 * lm_params(doc) * tokens


def cnn_dist_elems(doc: dict) -> int:
    """Elements of the weights that cross the transfer: every layer's
    weight of at least ``compress_min_size`` elements."""
    sizes = [math.prod(shape) for _, _, shape, _, _ in inputs.cnn_layers(doc)]
    return sum(n for n in sizes if n >= doc["compress_min_size"])


def lm_dist_elems(doc: dict) -> int:
    """Elements of the matrices that cross the transfer (each layer's
    projections and the embedding, every one over ``compress_min_size``)."""
    shapes = inputs.lm_shapes(doc)
    big = doc["compress_min_size"]
    per_layer = [math.prod(shapes[k]) for k in inputs.LM_KINDS]
    n = doc["num_hidden_layers"] * sum(x for x in per_layer if x >= big)
    embed = math.prod(shapes["embed"])
    return n + (embed if embed >= big else 0)


def transport_bytes(dist_elems: int, round_to: int) -> float:
    """Bytes one step's transfer needs: each weight read as fp32 and its
    ``round_to`` planes written (Bitpack), the planes read and fp32 written
    (Bitunpack); once a step, whatever the program repeats. 0 at
    ``round_to`` 4, where nothing is packed."""
    if round_to >= FP32_BYTES:
        return 0.0
    return float(dist_elems) * 2 * (FP32_BYTES + round_to)
