"""MusicGen support: the codebook-interleaved decoder over EnCodec tokens.

Counterpart of ``repro/models/audio.py``. As there, the EnCodec codec is a
stub: inputs are precomputed frame tokens (B, K, T) over K = 4 codebooks of
2048 entries; the model is the decoder-only transformer with per-codebook
embeddings and heads and the delay interleave pattern [arXiv:2306.05284].
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import Transformer


def codec_stub_tokens(cfg: ModelConfig, batch: int, frames: int,
                      generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
    """Stand-in EnCodec tokens (B, K, T), int64: zeros, or uniform in
    [0, vocab_size) drawn from ``generator`` (on its device)."""
    shape = (batch, cfg.num_codebooks, frames)
    if generator is None:
        return torch.zeros(shape, dtype=torch.long, device=device)
    return torch.randint(0, cfg.vocab_size, shape, generator=generator,
                         device=generator.device)


def apply_delay_pattern(tokens: torch.Tensor, pad_id: int = 0) -> torch.Tensor:
    """MusicGen's delay interleave: codebook k is shifted right by k frames,
    so one decode step predicts one frame across all codebooks causally."""
    out = torch.full_like(tokens, pad_id)
    t = tokens.shape[-1]
    for i in range(tokens.shape[1]):
        out[:, i, i:] = tokens[:, i, :t - i]
    return out


def undo_delay_pattern(tokens: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(tokens)
    t = tokens.shape[-1]
    for i in range(tokens.shape[1]):
        out[:, i, :t - i] = tokens[:, i, i:]
    return out


def audio_forward(model: Transformer, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, K, T) delayed codec tokens -> (logits (B, T, K, V), aux)."""
    return model.forward(tokens)


def audio_prefill(model: Transformer, tokens: torch.Tensor, max_len: int):
    return model.prefill(tokens, max_len)
