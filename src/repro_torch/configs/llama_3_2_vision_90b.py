"""llama-3.2-vision-90b [vlm] — cross-attn image layers  [hf:meta-llama/Llama-3.2-11B-Vision].

100 decoder layers; every 5th layer is a gated cross-attention layer over
vision-patch embeddings. The ViT frontend is a stub per the assignment:
``input_specs()`` supplies precomputed patch embeddings (B, 4096, 1280)
which a linear projector maps into d_model.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    arch_type="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    cross_attn_every=5,
    num_image_tokens=4096,
    vision_dim=1280,
    rope_theta=5e5,
    num_precision_groups=5,
)
