"""arctic-480b [moe] — 128 experts top-2 + dense residual  [hf:Snowflake/snowflake-arctic-base].

Dense-MoE hybrid: every MoE layer also has a parallel dense SwiGLU residual
branch. Experts are expert-parallel over the model axis (128 / 16 = 8
experts per shard) — the all-to-all dispatch pattern is one of the three
hillclimb targets (EXPERIMENTS.md §Perf).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    arch_type="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    num_experts=128,
    top_k=2,
    moe_dense_ff=4864,  # parallel dense residual branch (arctic model card)
    moe_impl="ep",
    rope_theta=1e6,
    num_precision_groups=5,
)
