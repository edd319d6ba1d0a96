"""Batched serving engine for the ported LLM architectures.

Counterpart of ``repro/serving/engine.py``: ``prefill_step`` (the full
prompt -> last-token logits and caches), ``serve_step`` (ONE token against
the caches) and ``ServeEngine``, which groups queued requests into
left-padded batches and runs greedy generation: text prompts (L,),
musicgen's codebook prompts (K, L), and text behind a vision prefix, which
the reference's engine does not take. It runs eagerly on the
model's device (there is no ``jit`` counterpart), and times each group's
prefill and decode there (CUDA events on the card, the host clock elsewhere).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import StageTimer
from repro_torch.models.transformer import Transformer


def prefill_step(model: Transformer, tokens: torch.Tensor, max_len: int, prefix_embeds=None):
    return model.prefill(tokens, max_len, prefix_embeds)


def serve_step(model: Transformer, tokens: torch.Tensor, caches: list, offset: int):
    """ONE new token per sequence against the caches."""
    return model.decode_step(tokens, caches, offset)


@dataclasses.dataclass
class GenRequest:
    rid: int
    prompt: np.ndarray            # (L,) int  [or (K, L) audio]
    max_new: int = 16
    # a vision model's stub patch embeddings (Tv, Dv), put in front of the prompt
    prefix: Optional[np.ndarray] = None
    done: bool = False
    output: Optional[np.ndarray] = None
    # set when served: the group's prefill ms, its decode ms per token, its size
    prefill_ms: float = 0.0
    decode_ms_per_token: float = 0.0
    group_size: int = 0


class ServeEngine:
    """Greedy batched generation over padded same-length groups."""

    def __init__(self, model: Transformer, max_batch: int = 8, max_len: int = 256):
        self.model = model
        self.cfg = model.cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.device = model.embed.device
        self.queue: List[GenRequest] = []

    def submit(self, req: GenRequest) -> None:
        self.queue.append(req)

    def _pad_group(self) -> Tuple[List[GenRequest], np.ndarray, Optional[np.ndarray]]:
        group = self.queue[: self.max_batch]
        self.queue = self.queue[self.max_batch:]
        lmax = max(r.prompt.shape[-1] for r in group)
        padded = []
        for r in group:
            width = [(0, 0)] * (r.prompt.ndim - 1) + [(lmax - r.prompt.shape[-1], 0)]
            padded.append(np.pad(r.prompt, width))                   # left-pad the last axis
        prefixes = None if group[0].prefix is None else np.stack([r.prefix for r in group])
        return group, np.stack(padded), prefixes

    @torch.no_grad()
    def step(self) -> List[GenRequest]:
        """Serve one batch group to completion; returns finished requests.
        A request's output is (max_new,) tokens, or (max_new, K) frames for
        ``audio_codec``. Requests with a ``prefix`` (a vision model's) get
        it in front of their left-padded prompts, every request of a group
        one."""
        if not self.queue:
            return []
        group, prompts, prefixes = self._pad_group()
        n = len(group)
        if prefixes is not None:
            prefixes = torch.from_numpy(prefixes).to(self.device)
        with StageTimer(self.device) as t_prefill:
            logits, cache, offset = prefill_step(
                self.model, torch.from_numpy(prompts).long().to(self.device), self.max_len,
                prefixes)
        max_new = max(r.max_new for r in group)
        outs = []
        tok = torch.argmax(logits[:, -1], dim=-1)
        with StageTimer(self.device) as t_decode:
            for _ in range(max_new):
                outs.append(tok.cpu().numpy())
                step_tok = (tok.reshape(n, self.cfg.num_codebooks, 1)
                            if self.cfg.modality == "audio_codec" else tok.reshape(n, 1))
                logits, cache = serve_step(self.model, step_tok, cache, offset)
                offset += 1
                tok = torch.argmax(logits[:, -1], dim=-1)
        gen = np.stack(outs, axis=1)
        prefill_ms, decode_ms = t_prefill.ms(), t_decode.ms() / max(1, max_new)
        for i, r in enumerate(group):
            r.output = gen[i, : r.max_new]
            r.done = True
            r.prefill_ms, r.decode_ms_per_token, r.group_size = prefill_ms, decode_ms, n
        return group
