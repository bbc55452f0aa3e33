"""--arch registry + reduced (smoke) variants (counterpart of
``repro.configs.registry``).

The port serves qwen3-1.7b; the reference's other architectures raise
``NotImplementedError`` until their model families are ported.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import qwen3_1_7b
from repro_torch.configs.base import ModelConfig

ARCHS: dict[str, ModelConfig] = {c.name: c for c in [qwen3_1_7b.CONFIG]}
# the reference's other --arch ids, whose families are not ported yet
UNPORTED_ARCHS = (
    "arctic-480b", "chatglm3-6b", "hubert-xlarge", "llama-3.2-vision-90b",
    "mixtral-8x7b", "qwen2.5-14b", "qwen3-14b", "recurrentgemma-9b",
    "xlstm-1.3b",
)


def get_config(name: str) -> ModelConfig:
    if name in UNPORTED_ARCHS:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet (ported: {sorted(ARCHS)})"
        )
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test variant of the same family, as the reference shrinks it:
    2 layers, d_model <= 256, <= 4 heads, d_ff <= 512, vocab <= 512, and
    no activation checkpointing."""
    num_heads = min(cfg.num_heads, 4)
    num_kv = max(1, min(cfg.num_kv_heads, num_heads))
    while num_heads % num_kv:
        num_kv -= 1
    d_model = min(cfg.d_model, 256)
    return dataclasses.replace(
        cfg,
        num_layers=2,
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=num_kv,
        head_dim=max(8, d_model // num_heads),
        d_ff=0 if cfg.d_ff == 0 else min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 512),
        sliding_window=None if cfg.sliding_window is None else 32,
        num_precision_groups=min(cfg.num_precision_groups, 2),
        remat=False,
    )
