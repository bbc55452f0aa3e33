"""Model configuration (counterpart of ``repro.configs.base``).

``ModelConfig`` describes one model: widths, the attention flavour
(causal, or bidirectional for the hubert encoder), the channel mixer (a
SwiGLU, hubert's GeLU MLP, or top-k experts with an optional dense
residual), the block pattern (``mlstm`` / ``slstm`` for xLSTM, ``rglru``
/ ``local`` for RecurrentGemma; ``cross_attn_every`` makes every k-th
layer a gated ``cross`` block over ``num_image_tokens`` image embeddings
of width ``vision_dim``), the input stub (``embed_is_input_stub``: the
inputs are ``vision_dim``-wide frame embeddings, not token ids) and the
precision-group layout that AWP and the ADT transfer read. ``InputShape``
and ``INPUT_SHAPES`` are the assigned workload geometries
(``configs.shapes`` gives their input stand-ins).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

ArchType = Literal["dense", "moe", "vlm", "ssm", "hybrid", "audio"]


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
    causal: bool = True              # False -> encoder-only (hubert)
    cross_attn_every: int = 0        # VLM: every k-th layer cross-attends
    num_image_tokens: int = 0
    vision_dim: int = 0              # stub frontend embedding width

    # --- channel mixer -----------------------------------------------------
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_dense_ff: int = 0            # arctic: parallel dense residual MLP
    moe_impl: Literal["tp", "ep"] = "tp"

    # --- recurrent families --------------------------------------------------
    # block_pattern: cycle of per-layer mixer kinds; "attn" | "local" |
    # "cross" | "mlstm" | "slstm" | "rglru".  Empty -> all "attn".
    block_pattern: tuple[str, ...] = ()
    lru_dim: int = 0                 # RG-LRU recurrence width (0 -> d_model)
    conv1d_width: int = 4            # temporal conv in RG-LRU block
    mlstm_proj_factor: float = 2.0   # xLSTM up-projection factor

    # --- embeddings / output -------------------------------------------------
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    embed_is_input_stub: bool = False  # audio/vlm-frontend: inputs are embeddings

    # --- AWP ----------------------------------------------------------------
    num_precision_groups: int = 4    # AWP group granularity (paper: block level)
    # the reference scans a group's layers (one traced body a group); the
    # port runs them as a loop, and the flag decides only whether the
    # layers of a group share their stochastic-rounding keys (train.step)
    scan_layers: bool = True
    remat: bool = True               # activation checkpointing per layer (train)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError("num_heads must be divisible by num_kv_heads")
        if self.block_pattern:
            if self.num_layers % len(self.block_pattern):
                raise ValueError(
                    f"{self.name}: num_layers ({self.num_layers}) must be a "
                    f"multiple of the block pattern ({len(self.block_pattern)})"
                )

    @property
    def pattern(self) -> tuple[str, ...]:
        if self.block_pattern:
            return self.block_pattern
        if self.cross_attn_every:
            return ("attn",) * (self.cross_attn_every - 1) + ("cross",)
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

    @property
    def is_decoder(self) -> bool:
        return self.causal

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode (a recurrent state or a window variant);
        encoder-only archs do not decode at all."""
        return self.is_decoder

    def active_params(self) -> int:
        """Approximate active parameter count (MoE: ``top_k`` experts)."""
        return self._param_count(active_only=True)

    def total_params(self) -> int:
        return self._param_count(active_only=False)

    def _param_count(self, active_only: bool) -> int:
        """The reference's count, term for term: attention projections,
        experts (``top_k`` of them when ``active_only``) and the dense
        residual, the recurrent blocks' terms, embeddings; no norm scales,
        router, biases, gates, ``embed_in`` or ``img_proj``. Its mLSTM and
        sLSTM terms undercount those blocks' leaves, and it prices a
        SwiGLU on every cross block (which has no mixer) and three
        matrices for hubert's two-matrix GeLU MLP (``models.init`` has
        the true sizes)."""
        d, hd = self.d_model, self.head_dim
        h, kv = self.num_heads, self.num_kv_heads
        counts = {}
        for kind in self.pattern:
            counts[kind] = counts.get(kind, 0) + 1
        reps = self.num_layers // len(self.pattern)
        total = 0
        for kind, n in counts.items():
            n *= reps
            if kind in ("attn", "local", "cross"):
                total += n * (d * hd * h + 2 * d * hd * kv + hd * h * d)  # q, k, v, o
                if self.num_experts:
                    e = self.top_k if active_only else self.num_experts
                    total += n * (3 * d * self.d_ff * e)
                    if self.moe_dense_ff:
                        total += n * 3 * d * self.moe_dense_ff
                elif self.d_ff:
                    total += n * 3 * d * self.d_ff
            elif kind == "mlstm":
                dv = int(self.mlstm_proj_factor * d)
                total += n * (d * dv * 3 + dv * d + 3 * d * dv // hd)
            elif kind == "slstm":
                total += n * (8 * d * d // max(1, self.num_heads))
            elif kind == "rglru":
                dr = self.lru_dim or d
                total += n * (2 * d * dr + dr * d + 2 * dr)
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return total + embed
