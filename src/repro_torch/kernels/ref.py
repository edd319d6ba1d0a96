"""Plain PyTorch versions of the port's kernels.

Each is the same function as its kernel, written with plain tensor ops. The
ops take them for tensors on the CPU; on the card they are what each kernel
is held against. Counterpart of ``repro/kernels/ref.py``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.ssm_scan import MAX_NEG_LOGW


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor] = None, softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Lq, H, D); k/v: (B, Lkv, H, D); mask (Lq, Lkv) True=attend."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    if mask is not None:
        s = s.masked_fill(~mask[None, None], -1e30)
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


# ---------------------------------------------------------------------------
# Gated linear-attention scan (Mamba2 / RWKV6 shared recurrence)
#
#   S_t = diag(decay_t) @ S_{t-1} + k_t (outer) v_t
#   o_t = q_t @ (S_{t-1} + diag(bonus*k_t) applied current step)   [rwkv6]
#   o_t = q_t @ S_t                                                 [mamba2]
# ---------------------------------------------------------------------------

def linear_scan_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, decay: torch.Tensor,
                    bonus: Optional[torch.Tensor] = None,
                    initial_state: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential oracle, in f32. q/k/decay: (B, H, L, K); v: (B, H, L, V)
    -> out (B, H, L, V) in v's dtype, S (B, H, K, V) f32."""
    b, h, l, dk = q.shape
    dv = v.shape[-1]
    qf, kf, vf, wf = (t.float() for t in (q, k, v, decay))
    s = (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device)
         if initial_state is None else initial_state.float())
    bn = None if bonus is None else bonus.float()[None, :, :, None]
    outs = []
    for t in range(l):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]
        if bn is not None:
            read = s + bn * kv
            s = wf[:, :, t, :, None] * s + kv
        else:
            s = wf[:, :, t, :, None] * s + kv
            read = s
        outs.append(torch.einsum("bhk,bhkv->bhv", qf[:, :, t], read))
    out = torch.stack(outs, 2) if outs else vf.new_zeros((b, h, 0, dv))
    return out.to(v.dtype), s


def clamp_decay(decay: torch.Tensor) -> torch.Tensor:
    """Per-step log-decay clamped at -MAX_NEG_LOGW, as K3 clamps it."""
    logw = torch.log(torch.clamp(decay.float(), min=1e-30))
    return torch.exp(torch.clamp(logw, min=-MAX_NEG_LOGW))


def ssm_scan_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, decay: torch.Tensor,
                 bonus: Optional[torch.Tensor] = None,
                 initial_state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's plain version: the sequential oracle on clamped decays."""
    return linear_scan_ref(q, k, v, clamp_decay(decay), bonus, initial_state)


def linear_scan_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           decay: torch.Tensor, state: torch.Tensor,
                           bonus: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrent step. q/k/decay: (B, H, K); v: (B, H, V);
    state: (B, H, K, V) -> (out (B, H, V), new_state)."""
    qf, kf, vf, wf = (t.float() for t in (q, k, v, decay))
    sf = state.float()
    kv = kf[..., :, None] * vf[..., None, :]
    new = wf[..., :, None] * sf + kv
    read = new if bonus is None else sf + bonus.float()[None, :, :, None] * kv
    out = torch.einsum("bhk,bhkv->bhv", qf, read)
    return out.to(v.dtype), new
