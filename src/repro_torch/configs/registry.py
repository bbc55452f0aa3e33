"""--arch registry + reduced (smoke) variants (counterpart of
``repro.configs.registry``).

The port has all ten of the reference's archs: it trains and serves the
dense and MoE attention archs, the recurrent families (xlstm-1.3b,
recurrentgemma-9b) and vision cross-attention (llama-3.2-vision-90b, on
the static serving path), and trains the hubert-xlarge encoder (no decode
path). ``UNPORTED_ARCHS`` names an arch whose family is not ported yet and
the ROADMAP item that ports it (none is left).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (
    arctic_480b,
    chatglm3_6b,
    hubert_xlarge,
    llama_3_2_vision_90b,
    mixtral_8x7b,
    qwen2_5_14b,
    qwen3_1_7b,
    qwen3_14b,
    recurrentgemma_9b,
    xlstm_1_3b,
)
from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        qwen3_14b.CONFIG,
        mixtral_8x7b.CONFIG,
        llama_3_2_vision_90b.CONFIG,
        chatglm3_6b.CONFIG,
        qwen3_1_7b.CONFIG,
        hubert_xlarge.CONFIG,
        arctic_480b.CONFIG,
        qwen2_5_14b.CONFIG,
        xlstm_1_3b.CONFIG,
        recurrentgemma_9b.CONFIG,
    ]
}
# the reference's --arch ids whose families are not ported yet, and the
# ROADMAP item that ports each
UNPORTED_ARCHS: dict[str, str] = {}


def get_config(name: str) -> ModelConfig:
    if name in UNPORTED_ARCHS:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet (ported: {sorted(ARCHS)}; ROADMAP item "
            f"{UNPORTED_ARCHS[name]})"
        )
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> InputShape:
    if name not in INPUT_SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(INPUT_SHAPES)}")
    return INPUT_SHAPES[name]


def reduced(cfg: ModelConfig, *, layers: int | None = None) -> ModelConfig:
    """Smoke-test variant of the same family, as the reference shrinks it:
    one repetition of the pattern, at least 2 layers (or ``layers``),
    d_model <= 256, <= 4 heads, d_ff <= 512, vocab <= 512, <= 4 experts,
    top_k <= 2, a 256-wide dense residual, an RG-LRU as wide as d_model,
    16 image tokens of width 32 (and 32-wide input features under the
    stub), no layer scan and no activation checkpointing. A block pattern
    sets the depth whatever ``layers`` says: two repetitions of a pattern
    up to 4 long, else of its distinct kinds in order of first
    appearance."""
    pat = len(cfg.pattern)
    num_heads = min(cfg.num_heads, 4)
    num_kv = max(1, min(cfg.num_kv_heads, num_heads))
    while num_heads % num_kv:
        num_kv -= 1
    d_model = min(cfg.d_model, 256)
    changes = dict(
        num_layers=layers if layers is not None else max(pat, 2 if pat == 1 else pat),
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=num_kv,
        head_dim=max(8, d_model // num_heads),
        d_ff=0 if cfg.d_ff == 0 else min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 512),
        num_experts=min(cfg.num_experts, 4),
        top_k=min(cfg.top_k, 2),
        moe_dense_ff=0 if cfg.moe_dense_ff == 0 else 256,
        num_image_tokens=0 if cfg.num_image_tokens == 0 else 16,
        vision_dim=0 if cfg.vision_dim == 0 else 32,
        lru_dim=0 if cfg.lru_dim == 0 else d_model,
        sliding_window=None if cfg.sliding_window is None else 32,
        num_precision_groups=min(cfg.num_precision_groups, 2),
        scan_layers=False,
        remat=False,
    )
    if cfg.block_pattern:
        if len(cfg.block_pattern) > 4:
            base = tuple(dict.fromkeys(cfg.block_pattern))  # distinct kinds, in order
            changes["block_pattern"] = base
            changes["num_layers"] = len(base) * 2
        else:
            changes["num_layers"] = len(cfg.block_pattern) * 2
    if cfg.embed_is_input_stub:
        changes["vision_dim"] = 32
    return dataclasses.replace(cfg, **changes)
