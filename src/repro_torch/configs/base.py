"""Model configuration (counterpart of ``repro.configs.base``, the
dense-attention fields).

``ModelConfig`` describes one decoder: widths, the attention flavour, and
the precision-group layout that AWP and the ADT transfer read. The port
runs the ``attn`` block pattern only; the reference's MoE, recurrent,
cross-attention and audio fields come with their slice. ``InputShape``
and ``INPUT_SHAPES`` are the assigned workload geometries
(``configs.shapes`` gives their input stand-ins).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

ArchType = Literal["dense"]


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One assigned (workload) input geometry."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]
    window: int | None = None  # decode window override for long-context


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode", window=4_096),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: ArchType
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- attention flavour -------------------------------------------------
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e4
    rotary_pct: float = 1.0
    sliding_window: int | None = None
    causal: bool = True

    # --- embeddings / output -------------------------------------------------
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    # --- AWP ----------------------------------------------------------------
    num_precision_groups: int = 4    # AWP group granularity (paper: block level)
    # the reference scans a group's layers (one traced body a group); the
    # port runs them as a loop, and the flag decides only whether the
    # layers of a group share their stochastic-rounding keys (train.step)
    scan_layers: bool = True
    remat: bool = True               # activation checkpointing per layer (train)

    def __post_init__(self):
        if self.arch_type != "dense":
            raise NotImplementedError(
                f"{self.name}: arch_type {self.arch_type!r} is not ported "
                "(only dense attention models; ROADMAP item 11)"
            )
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError("num_heads must be divisible by num_kv_heads")

    @property
    def pattern(self) -> tuple[str, ...]:
        return ("attn",)

    @property
    def layers_per_group(self) -> int:
        """Layers per precision group (AWP granularity)."""
        pat = len(self.pattern)
        groups = min(self.num_precision_groups, self.num_layers // pat)
        return self.num_layers // (groups * pat) * pat

    @property
    def num_groups(self) -> int:
        return self.num_layers // self.layers_per_group

    def total_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        h, kv = self.num_heads, self.num_kv_heads
        attn = d * hd * h + 2 * d * hd * kv + hd * h * d  # q, k, v, o
        per_layer = attn + 3 * d * self.d_ff
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.num_layers * per_layer + embed
