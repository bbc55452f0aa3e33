"""hubert-xlarge [audio] — encoder-only (w2v2 backbone)  [arXiv:2106.07447].

The mel/conv feature extractor is a stub per the assignment:
``input_specs()`` supplies precomputed frame embeddings (B, T, 1280).
Encoder-only => no decode step; decode_32k and long_500k are skipped
(DESIGN.md §5). Training objective: masked frame classification over the
504-unit codebook (HuBERT-style cluster targets).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    arch_type="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    embed_is_input_stub=True,
    vision_dim=1280,  # frontend embedding width (frames)
    rope_theta=1e4,
    num_precision_groups=4,
)
