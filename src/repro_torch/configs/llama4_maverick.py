"""Llama 4 Maverick 400B-A17B [hf:meta-llama/Llama-4-Scout-17B-16E family].

48 layers, d_model 5120, 40 heads (GQA kv=8, head_dim 128), vocab 202048.
MoE: 128 routed experts, top-1, per-expert hidden 8192, plus one shared
expert; MoE interleaved every other layer.  Attention is iRoPE-style:
chunked-local (chunk 8192) with every 4th layer global, and qk-norm.
Same values as ``repro/configs/llama4_maverick.py``.
"""
from repro_torch.configs._smoke import make_smoke
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    layer_pattern=(
        "attn_chunked:moe",
        "attn_chunked:dense",
        "attn_chunked:moe",
        "attn:dense",
    ),
    chunk_size=8192,
    num_experts=128,
    num_shared_experts=1,
    experts_per_token=1,
    moe_d_ff=8192,
    rope_theta=5e5,
    qk_norm=True,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)

SMOKE = make_smoke(CONFIG)
