"""What the benchmark makes from ``--seed`` and hands to both sides: the
weights, the batch pool and the dropout keys.

Weights are drawn on the device by one ``torch.Generator`` seeded with the
seed, in one ``randn`` call over every random leaf, then scaled slice by
slice; the batches come from a second generator (seed + 2**40) in one call
a tensor. The program and the reference call the same functions, so they
start from the same bits; neither function reads anything of the program.

Leaf names: a CNN's ``<layer>.w`` / ``<layer>.b`` with layers named as the
config's list runs (``conv<n>``, ``fc<n>``, ``head``, ``n`` counted over
convolutions and dense layers); an LM's ``embed``, ``final_norm`` and
per-kind stacks ``<kind>`` of shape ``(layers, ...)``.
"""
from __future__ import annotations

import math

import torch

DATA_SEED_OFFSET = 2**40
LM_KINDS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
LM_NORMS = ("attn_ln", "q_norm", "k_norm", "mix_ln")


def _gen(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def cnn_layers(doc: dict) -> list[tuple[str, str, tuple, int, int]]:
    """``(name, kind, w shape, fan_in, spatial size after)`` of every layer
    with weights, in order, from the config's layer list (``conv``:
    ``[out, kernel, stride]``; ``pool``; ``fc``: ``[width]``), then the
    classifier ``head``. Convolutions are OIHW, dense layers ``(in, out)``;
    the first dense layer takes the NCHW flatten of the last feature map."""
    hw, ch, n, out = doc["image_size"], doc["in_channels"], 0, []
    for spec in doc["layers"]:
        if spec[0] == "conv":
            _, cout, k, s = spec
            hw = max(1, math.ceil(hw / s))
            out.append((f"conv{n}", "conv", (cout, ch, k, k), k * k * ch, hw))
            ch, n = cout, n + 1
        elif spec[0] == "pool":
            hw = max(1, hw // 2)
        elif spec[0] == "fc":
            cin = ch * hw * hw
            out.append((f"fc{n}", "fc", (cin, spec[1]), cin, 1))
            ch, hw, n = spec[1], 1, n + 1
        else:
            raise ValueError(f"unknown layer {spec!r}")
    cin = ch * hw * hw
    out.append(("head", "fc", (cin, doc["num_classes"]), cin, 1))
    return out


def init_std(doc: dict, shape: tuple, fan_in: int) -> float:
    """A weight's standard deviation under Glorot & Bengio (2010)'s
    normal initialisation, ``sqrt(2 / (fan_in + fan_out))``."""
    if doc["init"] != "glorot":
        raise ValueError(f"unknown init {doc['init']!r}")
    fan_out = fan_in // shape[1] * shape[0] if len(shape) == 4 else shape[1]
    return math.sqrt(2.0 / (fan_in + fan_out))


def cnn_weights(doc: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """``{"<layer>.w", "<layer>.b"}``: normal weights of the standard
    deviation :func:`init_std` gives, zero biases."""
    layers = cnn_layers(doc)
    total = sum(math.prod(shape) for _, _, shape, _, _ in layers)
    buf = torch.randn(total, generator=_gen(device, seed), device=device)
    out, off = {}, 0
    for name, _, shape, fan_in, _ in layers:
        n = math.prod(shape)
        out[f"{name}.w"] = buf[off:off + n].view(shape) * init_std(doc, shape, fan_in)
        out[f"{name}.b"] = torch.zeros(shape[0] if len(shape) == 4 else shape[1],
                                       device=device)
        off += n
    return out


def lm_shapes(doc: dict) -> dict[str, tuple]:
    """Per-layer shapes of the LM's stacked kinds and norms, plus the
    embedding and the final norm."""
    d, hd = doc["hidden_size"], doc["head_dim"]
    h, kv, ff = doc["num_attention_heads"], doc["num_key_value_heads"], doc["intermediate_size"]
    return {
        "wq": (d, h * hd), "wk": (d, kv * hd), "wv": (d, kv * hd), "wo": (h * hd, d),
        "w_gate": (d, ff), "w_up": (d, ff), "w_down": (ff, d),
        "attn_ln": (d,), "q_norm": (hd,), "k_norm": (hd,), "mix_ln": (d,),
        "embed": (doc["vocab_size"], d), "final_norm": (d,),
    }


def lm_weights(doc: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """``{"embed", "final_norm", <kind>: (L, ...)}``: normal std 0.02, the
    residual outputs (``wo``, ``w_down``) 0.02 / sqrt(2 L), norm scales one."""
    L = doc["num_hidden_layers"]
    shapes = lm_shapes(doc)
    per = {k: math.prod(shapes[k]) for k in LM_KINDS}
    n_embed = math.prod(shapes["embed"])
    buf = torch.randn(n_embed + L * sum(per.values()), generator=_gen(device, seed),
                      device=device)
    out = {"embed": buf[:n_embed].view(shapes["embed"]) * 0.02}
    off = n_embed
    for k in LM_KINDS:
        std = 0.02 / math.sqrt(2 * L) if k in ("wo", "w_down") else 0.02
        block = buf[off:off + L * per[k]].view(L, *shapes[k])
        out[k] = block * std
        off += L * per[k]
    del buf
    for k in LM_NORMS:
        out[k] = torch.ones((L, *shapes[k]), device=device)
    out["final_norm"] = torch.ones(shapes["final_norm"], device=device)
    return out


def cnn_batches(doc: dict, batch: int, pool: int, seed: int, device):
    """``(images (P, B, H, W, C), labels (P, B))``: unit normal pixels,
    uniform labels."""
    g = _gen(device, seed + DATA_SEED_OFFSET)
    hw, c = doc["image_size"], doc["in_channels"]
    images = torch.randn((pool, batch, hw, hw, c), generator=g, device=device)
    labels = torch.randint(0, doc["num_classes"], (pool, batch), generator=g, device=device)
    return images, labels


def lm_batches(doc: dict, sequences: int, seq_len: int, pool: int, seed: int, device):
    """``(tokens, labels)``, each ``(P, B, S)``: uniform token ids, the
    labels the next token of one drawn row of ``S + 1``."""
    g = _gen(device, seed + DATA_SEED_OFFSET)
    rows = torch.randint(0, doc["vocab_size"], (pool, sequences, seq_len + 1), generator=g,
                         device=device)
    return rows[..., :-1].contiguous(), rows[..., 1:].contiguous()


def dropout_key_seed(seed: int) -> int:
    """The int32 seed of the run's dropout keys (step ``i`` uses
    ``fold_in(PRNGKey(this), i)``)."""
    return int(seed) % 2**31
