"""xlstm-1.3b [ssm] — alternating mLSTM / sLSTM blocks  [arXiv:2405.04517].

Attention-free: O(1) decode state => long_500k runs natively. d_ff=0 per
the assignment: the blocks carry their own up/down projections
(mlstm_proj_factor). AWP/ADT applies unchanged — it compresses the weight
gathers, not attention (DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    arch_type="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm", "slstm"),
    mlstm_proj_factor=2.0,
    num_precision_groups=4,
)
