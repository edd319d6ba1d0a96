"""MusicGen-medium [arXiv:2306.05284] — decoder-only over EnCodec tokens.

48 layers, d_model 1536, 24 heads (MHA, kv=24), d_ff 6144; 4 codebooks of
2048 entries with the delay interleave pattern.  The EnCodec codec is a
stub, as in the reference: inputs are precomputed frame tokens (B, K=4, T).
Same values as ``repro/configs/musicgen_medium.py``.
"""
from repro_torch.configs._smoke import make_smoke
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    layer_pattern=("attn:dense",),
    modality="audio_codec",
    num_codebooks=4,
    source="arXiv:2306.05284",
)

SMOKE = make_smoke(CONFIG, num_codebooks=4)
