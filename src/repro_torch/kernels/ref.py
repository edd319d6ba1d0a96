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


TRAIN_CHUNK = 16   # the chunk the training pass runs (see chunked_linear_scan_ref)


def chunked_linear_scan_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            decay: torch.Tensor, bonus: Optional[torch.Tensor] = None,
                            initial_state: Optional[torch.Tensor] = None,
                            chunk: int = TRAIN_CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's chunked parallel form of the scan (O(L*C) work, O(L/C)
    sequential steps), in f32, differentiable by autograd: the models'
    training pass runs it on every device, as the reference's training does.

    Within a chunk, with cumulative decays D_t = prod_{s<=t} w_s:
      S_t    = D_t * (S_0 + sum_{s<=t} (k_s / D_s) x v_s)
      o_t    = (q_t * D_t) @ S_0 + sum_{s<=t or <t} A[t, s] v_s
      A[t,s] = (q_t * D_t / D_s) . k_s          (strict past when bonus given)

    The chunk defaults to 16, where the reference's default is 32. The
    models clamp each step's log-decay at -MAX_NEG_LOGW (5.4), so 1 / D_s
    reaches exp(5.4 * C): exp(86.4) fits float32 at C = 16, while exp(172.8)
    at C = 32 overflows and the scan gives NaN at the floor decay. Off the
    floor the two chunks agree to float32 rounding. At the floor, chunk 16
    still loses precision at each chunk's last positions, where q_t * D_t
    and k_s / D_s reach the ends of float32's range (the reference's F3:
    errors of up to 1.73 on outputs of up to 25.7), and its backward
    overflows where the output's gradient is of the order of 1 (without a
    bonus, where A's diagonal multiplies it by k_C / D_C): a mean loss's
    gradients, of the order of 1 / (B L), pass.
    """
    b, h, l, dk = q.shape
    dv = v.shape[-1]
    if l % chunk:
        pad = chunk - l % chunk
        zq = q.new_zeros((b, h, pad, dk))
        q = torch.cat([q, zq], 2)
        k = torch.cat([k, zq.to(k.dtype)], 2)
        v = torch.cat([v, v.new_zeros((b, h, pad, dv))], 2)
        decay = torch.cat([decay, decay.new_ones((b, h, pad, dk))], 2)
    n = q.shape[2] // chunk

    qf = q.float().reshape(b, h, n, chunk, dk)
    kf = k.float().reshape(b, h, n, chunk, dk)
    vf = v.float().reshape(b, h, n, chunk, dv)
    wf = decay.float().reshape(b, h, n, chunk, dk)

    logw = torch.log(torch.clamp(wf, min=1e-12))
    cum = torch.cumsum(logw, dim=3)                   # log D_t (inclusive of w_t)
    d_tot = torch.exp(cum[..., -1, :])                # full-chunk decay (B, H, N, K)
    if bonus is None:
        q_in = qf * torch.exp(cum)                    # q_t * D_t   (reads S_t)
    else:
        q_in = qf * torch.exp(cum - logw)             # q_t * D_{t-1} (reads S_{t-1})
    k_out = kf * torch.exp(cum[..., -1:, :] - cum)    # k_s * D_C / D_s (state update)
    k_in = kf * torch.exp(-cum)                       # k_s / D_s     (intra-chunk)

    # the reference multiplies by the triangle; selecting gives the same
    # values, and no NaN where a product above it overflowed
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=q.device),
                     diagonal=-1 if bonus is not None else 0)
    attn = torch.where(tri, torch.einsum("bhntk,bhnsk->bhnts", q_in, k_in), 0.0)
    intra = torch.einsum("bhnts,bhnsv->bhntv", attn, vf)
    if bonus is not None:
        bn = bonus.float()[None, :, None, None, :]
        intra = intra + torch.sum(qf * bn * kf, -1, keepdim=True) * vf
    kv_chunk = torch.einsum("bhnsk,bhnsv->bhnkv", k_out, vf)   # chunk contribution to S

    s = (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device)
         if initial_state is None else initial_state.float())
    # the state entering each chunk, in sequence; then every chunk's readout
    # of it in one product
    starts = []
    for d_c, kv_c in zip(d_tot[..., None].unbind(2), kv_chunk.unbind(2)):
        starts.append(s)
        s = torch.addcmul(kv_c, d_c, s)              # d_c * s + kv_c
    inter = torch.matmul(q_in, torch.stack(starts, 2))   # (B, H, N, C, K) @ (B, H, N, K, V)
    out = (intra + inter).reshape(b, h, n * chunk, dv)[:, :, :l]
    return out.to(v.dtype), s
