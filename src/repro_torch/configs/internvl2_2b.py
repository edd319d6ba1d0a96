"""InternVL2-2B [arXiv:2404.16821] — InternViT-300M + InternLM2-1.8B.

The LM backbone: 24 layers, d_model 2048, 16 heads (GQA kv=8), d_ff 8192,
vocab 92553.  The vision frontend is a stub, as in the reference: 256
patch embeddings of 1024 dims (one 448px tile after pixel-shuffle),
projected into the LM by a learned projector (``vision_proj``).
Same values as ``repro/configs/internvl2_2b.py``.
"""
from repro_torch.configs._smoke import make_smoke
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    layer_pattern=("attn:dense",),
    modality="vision",
    vision_tokens=256,
    vision_embed_dim=1024,
    rope_theta=1e6,
    source="arXiv:2404.16821",
)

SMOKE = make_smoke(CONFIG)
