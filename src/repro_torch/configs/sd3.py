"""Stable Diffusion 3 Medium pipeline [arXiv:2403.03206 / Table 2].

Encode: T5-XXL-style bidirectional encoder (~4.9B); Diffuse: SD3-DiT
(~1.0B here); Decode: AE-KL. Denoising steps 20 (Table 5). SMOKE is the
CPU-runnable reduced pipeline. Same values as ``repro/configs/sd3.py``.
"""
import dataclasses

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.diffusion import DecoderConfig, DiTConfig
from repro_torch.models.pipeline import PipelineConfig

_ENCODER = ModelConfig(
    name="t5-xxl-enc", family="dense", num_layers=24, d_model=4096,
    num_heads=64, num_kv_heads=64, d_ff=10240, vocab_size=32128,
    layer_pattern=("attn_bidir:dense",), source="T5-XXL [arXiv:1910.10683]")

_DIT = DiTConfig(name="sd3-dit", num_layers=24, d_model=1536, num_heads=24,
                 d_ff=6144, latent_dim=64, cond_dim=4096,
                 source="arXiv:2403.03206")

_DEC = DecoderConfig(name="ae-kl", latent_channels=16, base_channels=512,
                     source="AutoencoderKL")

CONFIG = PipelineConfig(name="sd3", encoder=_ENCODER, dit=_DIT, decoder=_DEC,
                        num_steps=20, source="stabilityai/stable-diffusion-3-medium")

SMOKE = PipelineConfig(
    name="sd3-smoke",
    encoder=dataclasses.replace(_ENCODER, num_layers=2, d_model=128,
                                num_heads=4, num_kv_heads=4, head_dim=32,
                                d_ff=256, vocab_size=256, dtype=torch.float32,
                                name="t5-smoke"),
    dit=dataclasses.replace(_DIT, num_layers=2, d_model=128, num_heads=4,
                            d_ff=256, latent_dim=16, cond_dim=128,
                            dtype=torch.float32, name="sd3-dit-smoke"),
    decoder=dataclasses.replace(_DEC, latent_channels=4, base_channels=32,
                                dtype=torch.float32, name="ae-smoke"),
    num_steps=3)
