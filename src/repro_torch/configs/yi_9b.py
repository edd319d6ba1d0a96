"""Yi-9B [arXiv:2403.04652] — llama-architecture GQA dense model.

48 layers, d_model 4096, 32 heads (GQA kv=4, head_dim 128), d_ff 11008,
vocab 64000.
Same values as ``repro/configs/yi_9b.py``.
"""
from repro_torch.configs._smoke import make_smoke
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    layer_pattern=("attn:dense",),
    rope_theta=5e6,
    source="arXiv:2403.04652",
)

SMOKE = make_smoke(CONFIG)
