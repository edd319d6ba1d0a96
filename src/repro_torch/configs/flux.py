"""Flux.1 pipeline [arXiv:2506.15742 / black-forest-labs/flux, Table 2].

Encode: T5-XXL (~4.9B); Diffuse: Flux-DiT (the released model is 19 double
+ 38 single MMDiT blocks at d=3072; as in the reference, 56 uniform joint
blocks at d=3072, 24 heads of 128: the same width, heads and FLOP scale,
single-stream); Decode: AE-KL. Denoising steps 4 (schnell schedule, Table
5). Same values as ``repro/configs/flux.py``.
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

_DIT = DiTConfig(name="flux-dit", num_layers=56, d_model=3072, num_heads=24,
                 d_ff=12288, latent_dim=64, cond_dim=4096,
                 source="black-forest-labs/FLUX.1-schnell")

_DEC = DecoderConfig(name="ae-kl", latent_channels=16, base_channels=512,
                     source="AutoencoderKL")

CONFIG = PipelineConfig(name="flux", encoder=_ENCODER, dit=_DIT, decoder=_DEC,
                        num_steps=4, source="black-forest-labs/flux")

SMOKE = PipelineConfig(
    name="flux-smoke",
    encoder=dataclasses.replace(_ENCODER, num_layers=2, d_model=128,
                                num_heads=4, num_kv_heads=4, head_dim=32,
                                d_ff=256, vocab_size=256, dtype=torch.float32,
                                name="t5-smoke"),
    dit=dataclasses.replace(_DIT, num_layers=2, d_model=128, num_heads=4,
                            d_ff=256, latent_dim=16, cond_dim=128,
                            dtype=torch.float32, name="flux-dit-smoke"),
    decoder=dataclasses.replace(_DEC, latent_channels=4, base_channels=32,
                                dtype=torch.float32, name="ae-smoke"),
    num_steps=2)
