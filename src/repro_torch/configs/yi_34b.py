"""Yi-34B [arXiv:2403.04652] — llama-architecture GQA dense model.

60 layers, d_model 7168, 56 heads (GQA kv=8, head_dim 128), d_ff 20480,
vocab 64000, RoPE theta 5e6.
Same values as ``repro/configs/yi_34b.py``.
"""
from repro_torch.configs._smoke import make_smoke
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    layer_pattern=("attn:dense",),
    rope_theta=5e6,
    source="arXiv:2403.04652",
)

SMOKE = make_smoke(CONFIG)
