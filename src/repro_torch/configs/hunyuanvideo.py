"""HunyuanVideo pipeline [arXiv:2412.03603 / Table 2].

Encode: a Llama-3-8B-style causal encoder (32 x d4096, 32 query heads over
8 KV heads of 128, RoPE theta 5e5); Diffuse: HYV-DiT (the released model is
20 double + 40 single blocks at d=3072; as in the reference, 64 uniform
joint blocks, 24 heads of 128); Decode: AE-KL-HYV (4 residual blocks a
level). Video latents, frames folded into the decoder's batch. Steps 6
(FastHunyuan). Same values as ``repro/configs/hunyuanvideo.py``; SMOKE's
encoder keeps the grouping, 4 query heads over 2 KV heads.
"""
import dataclasses

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.diffusion import DecoderConfig, DiTConfig
from repro_torch.models.pipeline import PipelineConfig

_ENCODER = ModelConfig(
    name="llama3-8b-enc", family="dense", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=128256,
    layer_pattern=("attn:dense",), rope_theta=5e5,
    source="Llama 3 [arXiv:2407.21783]")

_DIT = DiTConfig(name="hyv-dit", num_layers=64, d_model=3072, num_heads=24,
                 d_ff=12288, latent_dim=64, cond_dim=4096,
                 source="tencent/HunyuanVideo")

_DEC = DecoderConfig(name="ae-kl-hyv", latent_channels=16, base_channels=512,
                     res_blocks=4,
                     source="AutoencoderKL-HunyuanVideo")

CONFIG = PipelineConfig(name="hunyuanvideo", encoder=_ENCODER, dit=_DIT,
                        decoder=_DEC, num_steps=6, is_video=True,
                        source="tencent/HunyuanVideo")

SMOKE = PipelineConfig(
    name="hunyuanvideo-smoke",
    encoder=dataclasses.replace(_ENCODER, num_layers=2, d_model=128,
                                num_heads=4, num_kv_heads=2, head_dim=32,
                                d_ff=256, vocab_size=256, dtype=torch.float32,
                                name="llama-smoke"),
    dit=dataclasses.replace(_DIT, num_layers=2, d_model=128, num_heads=4,
                            d_ff=256, latent_dim=16, cond_dim=128,
                            dtype=torch.float32, name="hyv-dit-smoke"),
    decoder=dataclasses.replace(_DEC, latent_channels=4, base_channels=32,
                                dtype=torch.float32, name="ae-smoke"),
    num_steps=2, is_video=True)
