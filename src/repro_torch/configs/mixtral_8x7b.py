"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attn  [arXiv:2401.04088].

8 experts < 16 TP shards, so EP over the model axis does not divide; the
TP-MoE mapping (every expert's d_ff sharded over `model`, local dispatch)
is used instead (DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    arch_type="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    num_experts=8,
    top_k=2,
    sliding_window=4096,
    moe_impl="tp",
    rope_theta=1e6,
    num_precision_groups=4,
)
