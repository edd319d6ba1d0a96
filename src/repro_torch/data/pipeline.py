"""Synthetic data pipeline.

Counterpart of ``repro/data/pipeline.py``: deterministic per-step token
batches (a Zipfian unigram stream with local repeats, so that losses fall),
plus the modality extras of the zoo (vision patch embeddings, audio codebook
tokens). Batches are host-local numpy, drawn exactly as the reference draws
them; ``to_tensors`` puts one on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch: int
    seq_len: int
    seed: int = 0


def _zipf_tokens(rng: np.random.Generator, vocab: int, shape) -> np.ndarray:
    """Zipf-ish unigram distribution (bounded to vocab)."""
    ranks = rng.zipf(1.3, size=shape)
    return (ranks % vocab).astype(np.int32)


def synthetic_batch(cfg: ModelConfig, dcfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Step ``step``'s batch: ``tokens`` and ``labels`` (B, L) int32, or (B,
    K, L) codebook tokens for ``audio_codec``; a vision model's batch adds
    ``patch_embeds`` (B, Tv, Dv) float32."""
    rng = np.random.default_rng(dcfg.seed * 100_003 + step)
    if cfg.modality == "audio_codec":
        toks = _zipf_tokens(rng, cfg.vocab_size,
                            (dcfg.batch, cfg.num_codebooks, dcfg.seq_len + 1))
        batch = {"tokens": toks[:, :, :-1], "labels": toks[:, :, 1:]}
    else:
        toks = _zipf_tokens(rng, cfg.vocab_size, (dcfg.batch, dcfg.seq_len + 1))
        # learnable bigram structure: token[t+1] == token[t] sometimes
        rep = rng.random((dcfg.batch, dcfg.seq_len + 1)) < 0.3
        for b in range(dcfg.batch):
            idx = np.nonzero(rep[b][1:])[0] + 1
            toks[b][idx] = toks[b][idx - 1]
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.modality == "vision":
        batch["patch_embeds"] = rng.standard_normal(
            (dcfg.batch, cfg.vision_tokens, cfg.vision_embed_dim), dtype=np.float32) * 0.02
    return batch


def iterator(cfg: ModelConfig, dcfg: DataConfig) -> Iterator[Dict[str, np.ndarray]]:
    step = 0
    while True:
        yield synthetic_batch(cfg, dcfg, step)
        step += 1


class Spec(NamedTuple):
    """A batch entry's shape and dtype."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def batch_spec(cfg: ModelConfig, dcfg: DataConfig) -> Dict[str, Spec]:
    """The shapes and dtypes of ``synthetic_batch``'s entries, without
    drawing one."""
    if cfg.modality == "audio_codec":
        shape = (dcfg.batch, cfg.num_codebooks, dcfg.seq_len)
    else:
        shape = (dcfg.batch, dcfg.seq_len)
    out = {"tokens": Spec(shape, torch.int32), "labels": Spec(shape, torch.int32)}
    if cfg.modality == "vision":
        out["patch_embeds"] = Spec((dcfg.batch, cfg.vision_tokens, cfg.vision_embed_dim),
                                   torch.float32)
    return out


def to_tensors(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device``: token ids as int64 (what
    ``torch.gather`` takes), the patch embeddings as float32."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                device, torch.int64 if v.dtype.kind == "i" else torch.float32)
            for k, v in batch.items()}
