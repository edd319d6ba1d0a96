"""Gemma 2 9B [arXiv:2408.00118].

42 layers, d_model 3584, 16 heads (GQA kv=8, head_dim 256), d_ff 14336,
vocab 256000; alternating local (window 4096) / global attention; attention
softcap 50, final-logit softcap 30; tied embeddings; RoPE theta 10000.
Same values as ``repro/configs/gemma2_9b.py``.
"""
from repro_torch.configs._smoke import make_smoke
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    layer_pattern=("attn_local:dense", "attn:dense"),
    window_size=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    rope_theta=10000.0,
    tie_embeddings=True,
    embed_scale=True,
    source="arXiv:2408.00118",
)

SMOKE = make_smoke(CONFIG)
