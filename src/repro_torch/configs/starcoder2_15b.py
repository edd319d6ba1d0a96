"""StarCoder2-15B [arXiv:2402.19173].

40 layers, d_model 6144, 48 heads (GQA kv=4, head_dim 128), d_ff 24576,
vocab 49152; RoPE; sliding-window attention (w=4096) per the StarCoder2
training recipe — which is what makes long_500k serving feasible for this
otherwise-dense architecture.
Same values as ``repro/configs/starcoder2_15b.py``.
"""
from repro_torch.configs._smoke import make_smoke
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    layer_pattern=("attn_local:dense",),
    window_size=4096,
    rope_theta=1e5,
    source="arXiv:2402.19173",
)

SMOKE = make_smoke(CONFIG)
