"""qwen2.5-14b [dense] — GQA + QKV bias  [hf:Qwen/Qwen2.5-0.5B family]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    arch_type="dense",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
    num_precision_groups=4,
)
