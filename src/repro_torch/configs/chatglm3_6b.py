"""chatglm3-6b [dense] — 2d (partial) RoPE + GQA kv=2  [arXiv:2406.12793].

ChatGLM applies rotary embedding to half of each head's dims ("2d RoPE");
modelled here as rotary_pct=0.5.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    arch_type="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    rotary_pct=0.5,
    rope_theta=1e4,
    num_precision_groups=4,
)
