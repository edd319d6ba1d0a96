"""Zamba2 1.2B [arXiv:2411.15242].

38 layers, d_model 2048, Mamba2 backbone (state 64) with interleaved
attention blocks (32 heads, kv=32, d_ff 8192), vocab 32000. As in the
reference, each interleaved attention block has its own parameters (the
released model shares one block with per-use LoRA). Pattern: five Mamba2
layers then one attention+MLP block, cycled. Same values as
``repro/configs/zamba2_1p2b.py``.
"""
from repro_torch.configs._smoke import make_smoke
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    layer_pattern=("mamba2:none",) * 5 + ("attn:dense",),
    ssm_state_dim=64,
    ssm_heads=64,          # d_inner 4096 / head_dim 64
    ssm_expand=2,
    ssm_conv=4,
    source="arXiv:2411.15242",
)

SMOKE = make_smoke(CONFIG, layer_pattern=("mamba2:none", "attn:dense"))
