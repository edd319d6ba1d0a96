"""Shared helper to derive reduced same-family smoke variants.

Counterpart of ``repro/configs/_smoke.py``, with the fields the port's
``ModelConfig`` has.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.common import ModelConfig


def make_smoke(cfg: ModelConfig, **overrides) -> ModelConfig:
    """d_model 128, 4 heads of 32, <= 4 experts, <= 8 vision tokens of <= 64
    dims, f32; 2 layers, or one cycle of a longer pattern (up to 8); same
    layer family/pattern."""
    heads = min(cfg.num_heads, 4)
    kv = max(1, min(cfg.num_kv_heads, heads))
    while heads % kv:
        kv -= 1
    upd = dict(
        d_model=128,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=32,
        d_ff=256,
        vocab_size=min(cfg.vocab_size, 512),
        window_size=min(cfg.window_size, 16),
        chunk_size=min(cfg.chunk_size, 16),
        num_experts=min(cfg.num_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        moe_d_ff=min(cfg.moe_d_ff, 64) if cfg.moe_d_ff else 0,
        ssm_state_dim=min(cfg.ssm_state_dim, 16),
        ssm_heads=4 if cfg.resolved_ssm_heads else 0,
        vision_tokens=min(cfg.vision_tokens, 8),
        vision_embed_dim=min(cfg.vision_embed_dim, 64) if cfg.vision_embed_dim else 0,
        dtype=torch.float32,
        name=cfg.name + "-smoke",
    )
    upd.update(overrides)
    if len(cfg.layer_pattern) <= 2:
        upd["num_layers"] = 2
    else:
        upd["num_layers"] = len(cfg.layer_pattern) if len(cfg.layer_pattern) <= 8 else 2
        if upd["num_layers"] == 2:
            upd["layer_pattern"] = cfg.layer_pattern[:2]
    return dataclasses.replace(cfg, **upd)
