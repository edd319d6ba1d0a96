"""Batched serving engine for the ported LLM architectures.

Counterpart of ``repro/serving/engine.py``: ``prefill_step`` (the full
prompt -> last-token logits and caches), ``serve_step`` (ONE token against
the caches) and ``ServeEngine``, which groups queued requests into
left-padded batches and runs greedy generation. It runs eagerly on the
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


def prefill_step(model: Transformer, tokens: torch.Tensor, max_len: int):
    return model.prefill(tokens, max_len)


def serve_step(model: Transformer, tokens: torch.Tensor, caches: list, offset: int):
    """ONE new token per sequence against the caches."""
    return model.decode_step(tokens, caches, offset)


@dataclasses.dataclass
class GenRequest:
    rid: int
    prompt: np.ndarray            # (L,) int
    max_new: int = 16
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

    def _pad_group(self) -> Tuple[List[GenRequest], np.ndarray]:
        group = self.queue[: self.max_batch]
        self.queue = self.queue[self.max_batch:]
        lmax = max(r.prompt.shape[-1] for r in group)
        padded = [np.pad(r.prompt, (lmax - r.prompt.shape[-1], 0)) for r in group]  # left-pad
        return group, np.stack(padded)

    @torch.no_grad()
    def step(self) -> List[GenRequest]:
        """Serve one batch group to completion; returns finished requests."""
        if not self.queue:
            return []
        group, prompts = self._pad_group()
        n = len(group)
        with StageTimer(self.device) as t_prefill:
            logits, cache, offset = prefill_step(
                self.model, torch.from_numpy(prompts).long().to(self.device), self.max_len)
        max_new = max(r.max_new for r in group)
        outs = []
        tok = torch.argmax(logits[:, -1], dim=-1)
        with StageTimer(self.device) as t_decode:
            for _ in range(max_new):
                outs.append(tok.cpu().numpy())
                logits, cache = serve_step(self.model, tok.reshape(n, 1), cache, offset)
                offset += 1
                tok = torch.argmax(logits[:, -1], dim=-1)
        gen = np.stack(outs, axis=1)
        prefill_ms, decode_ms = t_prefill.ms(), t_decode.ms() / max(1, max_new)
        for i, r in enumerate(group):
            r.output = gen[i, : r.max_new]
            r.done = True
            r.prefill_ms, r.decode_ms_per_token, r.group_size = prefill_ms, decode_ms, n
        return group
