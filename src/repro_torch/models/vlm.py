"""VLM support (InternVL2): the stubbed vision front end and the LM glue.

Counterpart of ``repro/models/vlm.py``. As there, the ViT and its projector
are a stub: ``vision_stub_embeds`` gives patch embeddings of the right shape
(InternViT-300M: 1024-d, 256 tokens per 448 px tile after pixel-shuffle),
and the model is the InternLM2 backbone that takes them through
``vision_proj`` in front of the text [arXiv:2404.16821].
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import Transformer


def vision_stub_embeds(cfg: ModelConfig, batch: int, generator: Optional[torch.Generator] = None,
                       device=None) -> torch.Tensor:
    """Stand-in patch embeddings (B, vision_tokens, vision_embed_dim), f32:
    zeros, or N(0, 1) x 0.02 drawn from ``generator`` (on its device)."""
    shape = (batch, cfg.vision_tokens, cfg.vision_embed_dim)
    if generator is None:
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=generator.device) * 0.02


def vlm_forward(model: Transformer, tokens: torch.Tensor, patch_embeds: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cache-less pass over [vision prefix; text tokens]."""
    return model.forward(tokens, prefix_embeds=patch_embeds)


def vlm_prefill(model: Transformer, tokens: torch.Tensor, patch_embeds: torch.Tensor,
                max_len: int):
    """Prefill of [vision prefix; text tokens]; the offset counts both."""
    return model.prefill(tokens, max_len, prefix_embeds=patch_embeds)
