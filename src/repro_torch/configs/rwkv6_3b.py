"""RWKV6 "Finch" 3B [arXiv:2404.05892] — attention-free, data-dependent decay.

32 layers, d_model 2560, vocab 65536; 40 heads of dim 64; channel-mix hidden
3.5x = 8960. Same values as ``repro/configs/rwkv6_3b.py``.
"""
from repro_torch.configs._smoke import make_smoke
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    layer_pattern=("rwkv6:none",),
    ssm_heads=40,          # head_dim 64
    source="arXiv:2404.05892",
)

SMOKE = make_smoke(CONFIG)
