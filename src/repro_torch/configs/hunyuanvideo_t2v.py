"""HunyuanVideo T2V 720p as released [tencent/HunyuanVideo, arXiv:2412.03603].

A port-only configuration (the reference's ``hunyuanvideo`` runs 64 uniform
joint blocks). Encode: the Llama-3-8B text encoder's first 30 of 32 layers
(d 4096, 32 query heads over 8 KV heads of 128, RoPE theta 5e5, SwiGLU
14336), causal, handing on layer 30's states with no final norm and no LM
head. Diffuse: HunyuanVideo's DiT (``models/mmdit.py``): 20 dual-stream and
40 single-stream blocks at d 3072, 24 heads of 128, QK-norm, 3D RoPE over
(t, h, w) with head-dim axes 16/56/56 and theta 256, a 2-block token
refiner over the text states and an embedded-guidance input at 6.0.
Decode: AE-KL-HYV as ``configs/hunyuanvideo.py``. 6 DDIM steps.

SMOKE: 2 dual + 2 single blocks at d 128, 4 heads of 32, RoPE axes
(8, 12, 12); the encoder keeps the grouping, 4 query heads over 2 KV heads.
"""
import dataclasses

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.diffusion import DecoderConfig, DiTConfig
from repro_torch.models.pipeline import PipelineConfig

_ENCODER = ModelConfig(
    name="llama3-8b-enc-l30", family="dense", num_layers=30, d_model=4096,
    num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=128256,
    layer_pattern=("attn:dense",), rope_theta=5e5, norm_eps=1e-5,
    tie_embeddings=True, final_norm=False,
    source="Llama 3 [arXiv:2407.21783], hidden state after layer 30")

_DIT = DiTConfig(name="hyv-t2v-dit", num_layers=60, double_layers=20, d_model=3072,
                 num_heads=24, d_ff=12288, latent_dim=64, cond_dim=4096,
                 rope_axes=(16, 56, 56), rope_theta=256.0, refiner_layers=2, guidance=6.0,
                 source="tencent/HunyuanVideo hunyuan-video-t2v-720p")

_DEC = DecoderConfig(name="ae-kl-hyv", latent_channels=16, base_channels=512,
                     res_blocks=4, source="AutoencoderKL-HunyuanVideo")

CONFIG = PipelineConfig(name="hunyuanvideo-t2v", encoder=_ENCODER, dit=_DIT,
                        decoder=_DEC, num_steps=6, is_video=True,
                        source="tencent/HunyuanVideo")

SMOKE = PipelineConfig(
    name="hunyuanvideo-t2v-smoke",
    encoder=dataclasses.replace(_ENCODER, num_layers=2, d_model=128,
                                num_heads=4, num_kv_heads=2, head_dim=32,
                                d_ff=256, vocab_size=256, dtype=torch.float32,
                                name="llama-l30-smoke"),
    dit=dataclasses.replace(_DIT, num_layers=4, double_layers=2, d_model=128,
                            num_heads=4, d_ff=512, latent_dim=16, cond_dim=128,
                            rope_axes=(8, 12, 12), dtype=torch.float32,
                            name="hyv-t2v-dit-smoke"),
    decoder=dataclasses.replace(_DEC, latent_channels=4, base_channels=32,
                                dtype=torch.float32, name="ae-smoke"),
    num_steps=2, is_video=True)
