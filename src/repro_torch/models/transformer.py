"""The transformer's encoder half: the bidirectional text encoder of stage E.

Counterpart of ``repro/models/transformer.py`` for the ``"train"``-mode pass
over ``attn_bidir:dense`` layers (the T5-style encoder of the diffusion
pipelines). One ``nn.Module`` per layer, where the reference stacks the
layers under ``params["blocks"][0][0]`` with a leading repeat dimension.
The causal mixers, caches, SSM and MoE layers are not ported yet.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import common
from repro_torch.models.common import ATTN_BIDIR, FFN_DENSE, ModelConfig, param


class EncoderLayer(nn.Module):
    """One ``attn_bidir:dense`` layer: pre-norm attention, then pre-norm SwiGLU."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, dh, dt = cfg.d_model, cfg.resolved_head_dim, cfg.dtype
        self.cfg = cfg
        self.ln1 = param((d,), torch.float32, device)
        self.wq = param((d, cfg.num_heads * dh), dt, device)
        self.wk = param((d, cfg.num_kv_heads * dh), dt, device)
        self.wv = param((d, cfg.num_kv_heads * dh), dt, device)
        self.wo = param((cfg.num_heads * dh, d), dt, device)
        self.ln2 = param((d,), torch.float32, device)
        self.w_gate = param((d, cfg.d_ff), dt, device)
        self.w_up = param((d, cfg.d_ff), dt, device)
        self.w_down = param((cfg.d_ff, d), dt, device)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        scale_o = 1.0 / max(1, self.cfg.num_layers) ** 0.5
        self.ln1.zero_()
        self.ln2.zero_()
        for w in (self.wq, self.wk, self.wv, self.w_gate, self.w_up):
            common.dense_init_(w, gen)
        common.dense_init_(self.wo, gen, scale=scale_o)
        common.dense_init_(self.w_down, gen, scale=scale_o)

    def _project_qkv(self, x: torch.Tensor, positions: torch.Tensor):
        cfg = self.cfg
        b, l, _ = x.shape
        dh = cfg.resolved_head_dim
        q = (x @ self.wq).reshape(b, l, cfg.num_heads, dh)
        k = (x @ self.wk).reshape(b, l, cfg.num_kv_heads, dh)
        v = (x @ self.wv).reshape(b, l, cfg.num_kv_heads, dh)
        # as in the reference, RoPE applies to the bidirectional encoder too
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
        return q, k, v

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, l, _ = x.shape
        h = common.rms_norm(x, self.ln1, cfg.norm_eps)
        q, k, v = self._project_qkv(h, positions)
        n_rep = cfg.num_heads // cfg.num_kv_heads
        k = k.repeat_interleave(n_rep, dim=2)
        v = v.repeat_interleave(n_rep, dim=2)
        pos = positions[0]
        mask = common.make_attention_mask(pos, pos, ATTN_BIDIR)
        out = common.attention(q, k, v, mask, cfg.attn_softcap)
        x = x + out.reshape(b, l, cfg.num_heads * cfg.resolved_head_dim) @ self.wo
        h = common.rms_norm(x, self.ln2, cfg.norm_eps)
        return x + common.swiglu(h, self.w_gate, self.w_up, self.w_down)


class Transformer(nn.Module):
    """Token embedding, the encoder layers, the final norm and the LM head.

    ``encode`` never reads ``lm_head``; it is kept because the profiler
    counts it, as the reference's does."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        for kind in cfg.layer_kinds():
            if kind != (ATTN_BIDIR, FFN_DENSE):
                raise NotImplementedError(f"layer kind {kind} is not ported yet")
        self.cfg = cfg
        self.embed = param((cfg.vocab_size, cfg.d_model), cfg.dtype, device)
        self.final_norm = param((cfg.d_model,), torch.float32, device)
        if not cfg.tie_embeddings:
            self.lm_head = param((cfg.d_model, cfg.vocab_size), cfg.dtype, device)
        self.layers = nn.ModuleList(EncoderLayer(cfg, device) for _ in range(cfg.num_layers))

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        common.embed_init_(self.embed, gen)
        self.final_norm.zero_()
        if not self.cfg.tie_embeddings:
            common.dense_init_(self.lm_head, gen)
        for layer in self.layers:
            layer.init_(gen)

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: (B, L) integer -> (B, L, D)."""
        return self.embed[tokens]

    def run_layers(self, x: torch.Tensor) -> torch.Tensor:
        """The ``"train"``-mode pass over every layer, positions 0..L-1."""
        b, l, _ = x.shape
        positions = torch.arange(l, dtype=torch.int32, device=x.device)[None].expand(b, l)
        for layer in self.layers:
            x = layer(x, positions)
        return x

    def apply_final_norm(self, x: torch.Tensor) -> torch.Tensor:
        return common.rms_norm(x, self.final_norm, self.cfg.norm_eps)
