"""Mixture-of-Experts FFN (DeepSeek-MoE fine-grained experts).

Counterpart of ``repro/models/moe.py``: GShard-style grouped routing with a
capacity per group and expert, top-k gates renormalised over the k chosen
experts, tokens past an expert's capacity dropped (in token order, slot by
slot), shared experts run densely on every token, and the Switch
load-balance loss. Where the reference dispatches through one-hot
(G, S, E, C) einsums, this gathers each expert's kept tokens into a
(E, G * C, D) batch and multiplies expert by expert with ``bmm``; the kept
tokens and the combine weights are the same. Plain torch on every device:
the reference has no kernel for it.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import common
from repro_torch.models.common import ModelConfig, param

GROUP_SIZE = 1024   # routing-group length (GShard-style); bounds capacity


def _group_size(t: int) -> int:
    g = min(GROUP_SIZE, t)
    while t % g:
        g -= 1
    return g


def capacity(cfg: ModelConfig, group: int) -> int:
    """Slots per expert in a routing group of ``group`` tokens."""
    return max(4, int(cfg.capacity_factor * cfg.experts_per_token * group / cfg.num_experts) + 1)


class MoE(nn.Module):
    """The router (float32), the routed experts' stacked SwiGLU weights
    ``w_gate``/``w_up`` (E, D, F) and ``w_down`` (E, F, D), and the shared
    experts' ``shared_*`` as one SwiGLU of width ``num_shared_experts * F``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, f = cfg.d_model, cfg.moe_d_ff or cfg.d_ff
        e, se, dt = cfg.num_experts, cfg.num_shared_experts, cfg.dtype
        self.cfg = cfg
        self.router = param((d, e), torch.float32, device)
        self.w_gate = param((e, d, f), dt, device)
        self.w_up = param((e, d, f), dt, device)
        self.w_down = param((e, f, d), dt, device)
        if se:
            self.shared_gate = param((d, se * f), dt, device)
            self.shared_up = param((d, se * f), dt, device)
            self.shared_down = param((se * f, d), dt, device)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        for w in (self.router, self.w_gate, self.w_up):
            common.dense_init_(w, gen)
        common.dense_init_(self.w_down, gen, scale=1.0 / max(1, self.cfg.num_layers) ** 0.5)
        if self.cfg.num_shared_experts:
            for w in (self.shared_gate, self.shared_up, self.shared_down):
                common.dense_init_(w, gen)


def route(cfg: ModelConfig, router: torch.Tensor, xg: torch.Tensor):
    """Routing of the groups xg (G, S, D): (probs (G, S, E) f32, expert index
    (G, S, k), gates (G, S, k) f32, zero where dropped, slot in the expert's
    buffer (G, S, k), kept (G, S, k))."""
    g_n, s, _ = xg.shape
    k, e = cfg.experts_per_token, cfg.num_experts
    probs = torch.softmax(xg.float() @ router.float(), dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # a token's slot in its expert's buffer: tokens in order, the k choices of
    # each in slot order (the reference's cumsum over the flattened (S, k))
    onehot = F.one_hot(idx, e)                                   # (G, S, k, E)
    flat = onehot.reshape(g_n, s * k, e)
    pos = ((torch.cumsum(flat, 1) - flat).reshape(g_n, s, k, e) * onehot).sum(-1)
    keep = pos < capacity(cfg, s)
    return probs, idx, gates * keep, pos, keep


def moe_ffn(cfg: ModelConfig, layer: MoE, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, L, D) -> (out (B, L, D), load-balance aux loss (f32 scalar))."""
    b, l, d = x.shape
    t = b * l
    e = cfg.num_experts
    s = _group_size(t)
    g_n = t // s
    cap = capacity(cfg, s)
    xg = x.reshape(g_n, s, d)
    probs, idx, gates, pos, keep = route(cfg, layer.router, xg)

    # each (group, expert, slot) names its token; empty slots name a zero row
    gi = torch.arange(g_n, device=x.device)[:, None, None].expand_as(idx)
    si = torch.arange(s, device=x.device)[None, :, None].expand_as(idx)
    slot_token = torch.full((g_n * e * cap,), s, dtype=torch.long, device=x.device)
    slot_token[((gi * e + idx) * cap + pos)[keep]] = si[keep]
    rows = torch.cat([xg, xg.new_zeros((g_n, 1, d))], 1)          # (G, S + 1, D)
    xe = torch.gather(rows, 1, slot_token.view(g_n, e * cap, 1).expand(-1, -1, d))
    xe = xe.view(g_n, e, cap, d).transpose(0, 1).reshape(e, g_n * cap, d)
    gg = torch.bmm(xe, layer.w_gate)
    uu = torch.bmm(xe, layer.w_up)
    h = F.silu(gg.float()).to(xe.dtype) * uu
    del gg, uu, xe, rows            # free the expert batch before the combine (llama4's prefill)
    ye = torch.bmm(h, layer.w_down).view(e, g_n, cap, d)          # (E, G, C, D)
    del h

    # combine: each token's kept slots, weighted by its gates in x's dtype
    yk = ye[idx, gi, torch.clamp(pos, max=cap - 1)]              # (G, S, k, D)
    w = gates.to(x.dtype).float()[..., None]
    y = (yk.float() * w).sum(2).to(x.dtype)
    if cfg.num_shared_experts:
        y = y + common.swiglu(xg, layer.shared_gate, layer.shared_up, layer.shared_down)

    # load-balance auxiliary loss (Switch eq. 4)
    density = F.one_hot(idx[..., 0], e).float().mean(dim=(0, 1))
    aux = torch.sum(density * probs.mean(dim=(0, 1))) * e * cfg.router_aux_weight
    return y.reshape(b, l, d), aux
