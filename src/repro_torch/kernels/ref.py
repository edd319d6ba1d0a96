"""Plain PyTorch versions of the port's kernels.

Each is the same function as its kernel, written with plain tensor ops. The
ops take them for tensors on the CPU; on the card they are what each kernel
is held against. Counterpart of ``repro/kernels/ref.py``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor] = None, softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Lq, H, D); k/v: (B, Lkv, H, D); mask (Lq, Lkv) True=attend."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    if mask is not None:
        s = torch.where(mask[None, None], s, torch.tensor(-1e30, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
    # the probabilities are rounded to v's dtype before the PV product
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def adaln_rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    """x: (B, L, D); scale/shift: (B, D) broadcast over L (AdaLN-Zero)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xn = xf * torch.rsqrt(var + eps)
    out = xn * (1.0 + scale.float()[:, None, :]) + shift.float()[:, None, :]
    return out.to(x.dtype)
