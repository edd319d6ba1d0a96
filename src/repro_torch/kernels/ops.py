"""The kernel ops the models call.

Each op chooses by the tensor's device: a CPU tensor goes to the plain
version in ``ref.py``; a CUDA tensor goes to the hand-written Hopper kernel,
which launches or raises (no fallback). ``LAUNCHES`` counts the kernel
launches of each op, so a run can show that its path went through them.
Counterpart of ``repro/kernels/ops.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import adaln_rmsnorm as _ar
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref

LAUNCHES = {"flash_attention": 0, "adaln_rmsnorm": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def attention_mask(lq: int, lkv: int, window: int, device: torch.device) -> torch.Tensor:
    """Causal (Lq, Lkv) mask, True=attend; queries sit at the end of the kv
    sequence, and a window keeps only the last ``window`` keys of each."""
    qpos = torch.arange(lq, device=device) + (lkv - lq)
    kpos = torch.arange(lkv, device=device)
    mask = kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Lq, H, D); k/v: (B, Lkv, H, D). GQA must be expanded upstream."""
    if q.device.type == "cpu":
        mask = None
        if causal or window:
            mask = attention_mask(q.shape[1], k.shape[1], window, q.device)
        return ref.attention_ref(q, k, v, mask, softcap)
    out = _fa.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)
    LAUNCHES["flash_attention"] += 1
    return out


def adaln_rmsnorm(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, *,
                  eps: float = 1e-6) -> torch.Tensor:
    """x: (B, L, D); scale/shift: (B, D)."""
    if x.device.type == "cpu":
        return ref.adaln_rmsnorm_ref(x, scale, shift, eps)
    out = _ar.adaln_rmsnorm(x, scale, shift, eps=eps)
    LAUNCHES["adaln_rmsnorm"] += 1
    return out
