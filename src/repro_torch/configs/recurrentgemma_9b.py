"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 2:1  [arXiv:2402.19427].

Griffin block pattern: two RG-LRU recurrent blocks then one local
(sliding-window 2048) MQA attention block. 38 layers: we use 36 pattern
layers + 2 trailing recurrent layers folded in by repeating the pattern is
not possible (38 % 3 != 0), so the config rounds the pattern to 38 with a
('rglru','rglru','local') cycle x12 + ('rglru','rglru') tail modelled as
pattern length 19: ('rglru','rglru','local') x 6 + ('rglru',) — instead we
keep it simple and exact: pattern of length 19 repeated twice.
"""
from repro_torch.configs.base import ModelConfig

_PATTERN = ("rglru", "rglru", "local") * 6 + ("rglru",)  # 19 layers, x2 = 38

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    arch_type="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=_PATTERN,
    sliding_window=2048,
    lru_dim=4096,
    conv1d_width=4,
    rope_theta=1e4,
    num_precision_groups=2,  # pattern is 19 layers long -> 2 groups of 19
)
