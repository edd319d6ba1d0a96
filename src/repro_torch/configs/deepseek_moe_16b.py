"""DeepSeekMoE 16B [arXiv:2401.06066] — fine-grained experts.

28 layers, d_model 2048, 16 heads (kv=16), vocab 102400.  Layer 0 uses a
dense FFN (d_ff 10944); layers 1..27 use MoE with 64 routed experts
(per-expert hidden 1408, top-6) + 2 shared experts.
Same values as ``repro/configs/deepseek_moe_16b.py``.
"""
from repro_torch.configs._smoke import make_smoke
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=10944,
    vocab_size=102400,
    layer_pattern=("attn:dense",) + ("attn:moe",) * 27,
    num_experts=64,
    num_shared_experts=2,
    experts_per_token=6,
    moe_d_ff=1408,
    source="arXiv:2401.06066",
)

SMOKE = make_smoke(CONFIG, layer_pattern=("attn:dense", "attn:moe"))
