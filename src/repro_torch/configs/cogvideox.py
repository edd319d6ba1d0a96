"""CogVideoX1.5-5B pipeline [arXiv:2408.06072 / Table 2].

Encode: T5 (12 x d1024, bidirectional); Diffuse: Cog-DiT (25 x d3072, 48
heads of 64); Decode: AE-KL-Cog (4 residual blocks a level). Video latents
(4x temporal compression at 16 fps), frames folded into the decoder's batch.
Steps 6. Same values as ``repro/configs/cogvideox.py``.
"""
import dataclasses

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.diffusion import DecoderConfig, DiTConfig
from repro_torch.models.pipeline import PipelineConfig

_ENCODER = ModelConfig(
    name="t5-enc-small", family="dense", num_layers=12, d_model=1024,
    num_heads=16, num_kv_heads=16, d_ff=4096, vocab_size=32128,
    layer_pattern=("attn_bidir:dense",), source="T5 [arXiv:1910.10683]")

_DIT = DiTConfig(name="cog-dit", num_layers=25, d_model=3072, num_heads=48,
                 d_ff=12288, latent_dim=64, cond_dim=1024,
                 source="zai-org/CogVideoX1.5-5B")

_DEC = DecoderConfig(name="ae-kl-cog", latent_channels=16, base_channels=512,
                     res_blocks=4,
                     source="AutoencoderKL-CogVideoX")

CONFIG = PipelineConfig(name="cogvideox", encoder=_ENCODER, dit=_DIT,
                        decoder=_DEC, num_steps=6, is_video=True,
                        source="zai-org/CogVideoX1.5-5B")

SMOKE = PipelineConfig(
    name="cogvideox-smoke",
    encoder=dataclasses.replace(_ENCODER, num_layers=2, d_model=128,
                                num_heads=4, num_kv_heads=4, head_dim=32,
                                d_ff=256, vocab_size=256, dtype=torch.float32,
                                name="t5-smoke"),
    dit=dataclasses.replace(_DIT, num_layers=2, d_model=128, num_heads=4,
                            d_ff=256, latent_dim=16, cond_dim=128,
                            dtype=torch.float32, name="cog-dit-smoke"),
    decoder=dataclasses.replace(_DEC, latent_channels=4, base_channels=32,
                                dtype=torch.float32, name="ae-smoke"),
    num_steps=2, is_video=True)
