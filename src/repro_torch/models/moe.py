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
from repro_torch.sharding import spmd

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


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(idx, n)`` by a comparison: the same int64 values, with no
    check of the indices' range (which reads them back on the CPU and has
    no ``meta`` counterpart), so every device runs the same ops."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


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
    onehot = _one_hot(idx, e)                                    # (G, S, k, E)
    flat = onehot.reshape(g_n, s * k, e)
    pos = ((torch.cumsum(flat, 1) - flat).reshape(g_n, s, k, e) * onehot).sum(-1)
    keep = pos < capacity(cfg, s)
    return probs, idx, gates * keep, pos, keep


def _dispatch(cfg: ModelConfig, xg: torch.Tensor, router: torch.Tensor):
    """Routing of the groups xg (G, S, D) -> (each group's expert slots
    (G, E * C, D), expert index (G, S, k), gates (G, S, k), slot (G, S, k),
    and the load-balance loss's two means over the groups' tokens, each
    (1, E): the top-1 expert's density and the router's probabilities)."""
    g_n, s, d = xg.shape
    e = cfg.num_experts
    cap = capacity(cfg, s)
    probs, idx, gates, pos, keep = route(cfg, router, xg)

    # each (group, expert, slot) names its token; empty slots name a zero row.
    # Dropped choices write to one spare slot past the end, so the write's
    # shape does not depend on the data (it runs on ``meta``)
    gi = torch.arange(g_n, device=xg.device)[:, None, None].expand_as(idx)
    si = torch.arange(s, device=xg.device)[None, :, None].expand_as(idx)
    n_slots = g_n * e * cap
    slot_token = torch.full((n_slots + 1,), s, dtype=torch.long, device=xg.device)
    target = torch.where(keep, (gi * e + idx) * cap + pos, n_slots)
    slot_token.index_put_((target.reshape(-1),), si.reshape(-1))
    slot_token = slot_token[:n_slots]
    rows = torch.cat([xg, xg.new_zeros((g_n, 1, d))], 1)          # (G, S + 1, D)
    xe = torch.gather(rows, 1, slot_token.view(g_n, e * cap, 1).expand(-1, -1, d))
    density = _one_hot(idx[..., 0], e).float().mean(dim=(0, 1))[None]
    return xe, idx, gates, pos, density, probs.mean(dim=(0, 1))[None]


def _combine(yg: torch.Tensor, idx: torch.Tensor, gates: torch.Tensor, pos: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """Each token's kept slots of yg (G, E, C, D), weighted by its gates in
    the activations' dtype -> (G, S, D)."""
    cap = yg.shape[2]
    gi = torch.arange(idx.shape[0], device=idx.device)[:, None, None].expand_as(idx)
    yk = yg[gi, idx, torch.clamp(pos, max=cap - 1)]              # (G, S, k, D)
    w = gates.to(dtype).float()[..., None]
    return (yk.float() * w).sum(2).to(dtype)


def moe_ffn(cfg: ModelConfig, layer: MoE, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, L, D) -> (out (B, L, D), load-balance aux loss (f32 scalar)).

    On a mesh the grouping, the routing and the combine (topk, cumsum, the
    boolean scatter and the gathers have no DTensor strategy) run on each
    rank's own groups where every batch shard of x holds whole groups (its
    tokens a multiple of the group length), else on the whole, replicated
    groups; the experts' products run on the expert-sharded weights (expert
    parallelism), and the load-balance loss takes its means over every
    group."""
    b, l, d = x.shape
    t = b * l
    e = cfg.num_experts
    s = _group_size(t)
    g_n = t // s
    cap = capacity(cfg, s)
    whole = (b // spmd.shards(x, 0)) * l % s != 0
    xg = spmd.local(lambda x_: x_.reshape(-1, s, d), x, whole=whole)
    xe, idx, gates, pos, density, pmean = spmd.local(
        lambda xg_, r_: _dispatch(cfg, xg_, r_), xg, layer.router, shared=(1,), whole=whole)
    xe = xe.view(g_n, e, cap, d).transpose(0, 1).reshape(e, g_n * cap, d)
    gg = torch.bmm(xe, layer.w_gate)
    uu = torch.bmm(xe, layer.w_up)
    h = F.silu(gg.float()).to(xe.dtype) * uu
    del gg, uu, xe                  # free the expert batch before the combine (llama4's prefill)
    ye = torch.bmm(h, layer.w_down).view(e, g_n, cap, d)          # (E, G, C, D)
    del h
    y = spmd.local(lambda *a: _combine(*a, x.dtype), ye.transpose(0, 1), idx, gates, pos,
                   whole=whole)
    if cfg.num_shared_experts:
        y = y + common.swiglu(xg, layer.shared_gate, layer.shared_up, layer.shared_down)

    # load-balance auxiliary loss (Switch eq. 4); each rank's means are over
    # as many tokens, so their mean is the mean over every group
    aux = torch.sum(density.mean(0) * pmean.mean(0)) * e * cfg.router_aux_weight
    return spmd.local(lambda y_: y_.reshape(-1, l, d), y, whole=whole), aux
