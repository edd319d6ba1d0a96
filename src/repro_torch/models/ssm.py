"""SSM mixers: Mamba2 (Zamba2 backbone) and RWKV6 "Finch".

Counterpart of ``repro/models/ssm.py``. Both share the gated linear-attention
recurrence ``S_t = diag(decay_t) S_{t-1} + k_t v_t^T``: prefill goes through
``ops.linear_scan`` (kernel K3 on the card), decode through the single-step
``ops.linear_scan_decode``, and the training pass (``train=True``) through
``ref.chunked_linear_scan_ref``, the reference's training math, on every
device. Each mixer is an ``nn.Module`` whose parameter
names are the reference's keys, so weights carry over by name.

State per layer (a dict, as the reference's):
  mamba2: {"conv": (B, conv_w-1, conv_dim), "ssm": (B, H, N, P) f32}
  rwkv6:  {"shift_tm": (B, D), "shift_cm": (B, D), "ssm": (B, H, K, V) f32}
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssm_scan import MAX_NEG_LOGW
from repro_torch.models import common
from repro_torch.models.common import ModelConfig, param
from repro_torch.sharding import spmd


def _train_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, decay: torch.Tensor,
                bonus: Optional[torch.Tensor] = None,
                initial_state: Optional[torch.Tensor] = None):
    """The training pass's chunked scan. On a mesh it runs on each rank's
    batch rows (its reshapes into chunks and its loop over them have no
    DTensor strategy), from the training pass's zero state."""
    if not spmd.is_dtensor(q):
        return ref.chunked_linear_scan_ref(q, k, v, decay, bonus=bonus,
                                           initial_state=initial_state)
    if initial_state is not None:
        raise ValueError("on a mesh the training pass's scan starts from the zero state")
    if bonus is None:
        return spmd.local(ref.chunked_linear_scan_ref, q, k, v, decay)
    return spmd.local(lambda *a: ref.chunked_linear_scan_ref(*a[:4], bonus=a[4]),
                      q, k, v, decay, bonus, shared=(4,))


def _silu(x: torch.Tensor) -> torch.Tensor:
    """SiLU in f32, back in x's dtype."""
    return F.silu(x.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------

def mamba2_dims(cfg: ModelConfig) -> Dict[str, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    heads = cfg.resolved_ssm_heads
    return dict(d_inner=d_inner, heads=heads, head_dim=d_inner // heads,
                state=cfg.ssm_state_dim,
                conv_dim=d_inner + 2 * cfg.ssm_state_dim)  # x, B, C all convolved


class Mamba2(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d = mamba2_dims(cfg)
        dt = cfg.dtype
        self.cfg, self.dims = cfg, d
        # in_proj -> [z (gate), x, B, C, dt]
        self.in_proj = param((cfg.d_model, 2 * d["d_inner"] + 2 * d["state"] + d["heads"]), dt,
                             device)
        self.conv_w = param((cfg.ssm_conv, d["conv_dim"]), dt, device)
        self.conv_b = param((d["conv_dim"],), dt, device)
        self.A_log = param((d["heads"],), torch.float32, device)
        self.D = param((d["heads"],), torch.float32, device)
        self.dt_bias = param((d["heads"],), torch.float32, device)
        self.norm_w = param((d["d_inner"],), dt, device)
        self.out_proj = param((d["d_inner"], cfg.d_model), dt, device)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        heads = self.dims["heads"]
        common.dense_init_(self.in_proj, gen)
        common.dense_init_(self.conv_w, gen)
        self.conv_b.zero_()
        self.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, heads)))
        self.D.fill_(1.0)
        self.dt_bias.fill_(math.log(math.expm1(0.01)))     # softplus^-1(0.01)
        self.norm_w.zero_()
        common.dense_init_(self.out_proj, gen, scale=1.0 / max(1, self.cfg.num_layers) ** 0.5)

    def init_state(self, batch: int, device=None) -> dict:
        d, cfg = self.dims, self.cfg
        return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, d["conv_dim"]), dtype=cfg.dtype,
                                    device=device),
                "ssm": torch.zeros((batch, d["heads"], d["state"], d["head_dim"]),
                                   dtype=torch.float32, device=device)}

    def _ssm_inputs(self, xbc_conv: torch.Tensor, dt: torch.Tensor):
        """Post-conv activations -> (q, k, v, decay) in (B, H, L, .) layout.

        The head-shared B/C and the per-head decay are stride-0 views: K3
        reads them through their strides and no copy per head is made."""
        d = self.dims
        b, l, _ = xbc_conv.shape
        h, n = d["heads"], d["state"]
        xbc_conv = _silu(xbc_conv)
        xs, bs, cs = torch.split(xbc_conv, [d["d_inner"], n, n], dim=-1)
        dt = F.softplus(dt.float() + self.dt_bias)                        # (B, L, H)
        # clamp per-step log-decay to the scan kernel's numeric contract
        decay_h = torch.exp(-torch.clamp(dt * torch.exp(self.A_log), 0.0, MAX_NEG_LOGW))
        xh = xs.reshape(b, l, h, d["head_dim"])
        q = cs[:, None].expand(b, h, l, n)
        k = bs[:, None].expand(b, h, l, n)
        v = (xh * dt[..., None].to(xh.dtype)).transpose(1, 2)             # dt folds into v
        decay = decay_h.transpose(1, 2)[..., None].expand(b, h, l, n)
        return q, k, v, decay, xh

    def _out(self, y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """y: (B, L, H, P) scan output -> (B, L, D)."""
        b, l = y.shape[:2]
        y = y + self.D.to(y.dtype)[None, None, :, None] * xh
        y = y.reshape(b, l, self.dims["d_inner"])
        y = common.rms_norm(y * _silu(z), self.norm_w, self.cfg.norm_eps)
        return y @ self.out_proj

    def _project(self, x: torch.Tensor):
        d = self.dims
        return torch.split(x @ self.in_proj, [d["d_inner"], d["conv_dim"], d["heads"]], dim=-1)

    def forward(self, x: torch.Tensor, state: Optional[dict] = None,
                train: bool = False) -> Tuple[torch.Tensor, dict]:
        """Full-sequence (prefill, or with ``train`` the training) pass. x: (B, L, D)."""
        b, l, _ = x.shape
        z, xbc, dt = self._project(x)
        prev = self.init_state(b, x.device) if state is None else state
        # causal depthwise conv with carried state
        ctx = torch.cat([prev["conv"].to(xbc.dtype), xbc], dim=1)
        new_conv = ctx[:, -(self.cfg.ssm_conv - 1):, :]
        xbc_conv = sum(ctx[:, i:i + l, :] * self.conv_w[i] for i in range(self.cfg.ssm_conv))
        xbc_conv = xbc_conv + self.conv_b
        q, k, v, decay, xh = self._ssm_inputs(xbc_conv, dt)
        if train:
            out, s_new = _train_scan(q, k, v, decay,
                                     initial_state=None if state is None else prev["ssm"])
        else:
            out, s_new = ops.linear_scan(q, k, v, decay, initial_state=prev["ssm"])
        y = out.transpose(1, 2).to(x.dtype)                                # (B, L, H, P)
        return self._out(y, xh, z), {"conv": new_conv, "ssm": s_new}

    def decode(self, x: torch.Tensor, state: dict) -> Tuple[torch.Tensor, dict]:
        """Single-token step. x: (B, 1, D)."""
        b = x.shape[0]
        z, xbc, dt = self._project(x)
        ctx = torch.cat([state["conv"].to(xbc.dtype), xbc], dim=1)        # (B, conv_w, C)
        new_conv = ctx[:, 1:, :]
        xbc_conv = torch.einsum("bwc,wc->bc", ctx, self.conv_w)[:, None, :] + self.conv_b
        q, k, v, decay, xh = self._ssm_inputs(xbc_conv, dt)
        out, s_new = ops.linear_scan_decode(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                                            decay[:, :, 0], state["ssm"])
        d = self.dims
        y = out.reshape(b, 1, d["heads"], d["head_dim"]).to(x.dtype)
        return self._out(y, xh, z), {"conv": new_conv, "ssm": s_new}


# ---------------------------------------------------------------------------
# RWKV6 (Finch)
# ---------------------------------------------------------------------------

RWKV_LORA = 64  # low-rank dim of the data-dependent decay projection


def rwkv6_dims(cfg: ModelConfig) -> Dict[str, int]:
    heads = cfg.resolved_ssm_heads or cfg.d_model // 64
    return dict(heads=heads, head_dim=cfg.d_model // heads)


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """x: (B, L, D); prev: (B, D) = last token before this block."""
    return torch.cat([prev[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def _mix(x: torch.Tensor, xx: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """Interpolate each token with the one before it, in f32."""
    mu = mu.float()
    return (x.float() * mu + xx.float() * (1 - mu)).to(x.dtype)


class RWKV6(nn.Module):
    """Time-mix and channel-mix of one RWKV6 layer (the channel-mix is its FFN)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, dt = cfg.d_model, cfg.dtype
        dd = rwkv6_dims(cfg)
        hidden = int(3.5 * d) // 32 * 32
        self.cfg, self.dims = cfg, dd
        self.mu = param((5, d), dt, device)                 # r, k, v, w, g
        self.w_r = param((d, d), dt, device)
        self.w_k = param((d, d), dt, device)
        self.w_v = param((d, d), dt, device)
        self.w_g = param((d, d), dt, device)
        self.w_o = param((d, d), dt, device)
        # data-dependent decay: w_t = exp(-exp(w0 + tanh(x A) B))
        self.decay_w0 = param((d,), torch.float32, device)
        self.decay_A = param((d, RWKV_LORA), dt, device)
        self.decay_B = param((RWKV_LORA, d), dt, device)
        self.bonus_u = param((dd["heads"], dd["head_dim"]), torch.float32, device)
        self.ln_w = param((d,), torch.float32, device)
        self.ln_b = param((d,), torch.float32, device)
        self.cm_mu = param((2, d), dt, device)
        self.cm_rk = param((d, d), dt, device)
        self.cm_kv = param((d, hidden), dt, device)
        self.cm_vo = param((hidden, d), dt, device)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        scale_out = 1.0 / max(1, self.cfg.num_layers) ** 0.5
        for mu in (self.mu, self.cm_mu):
            mu.copy_(torch.rand(mu.shape, generator=gen, device=mu.device))
        for w in (self.w_r, self.w_k, self.w_v, self.w_g, self.decay_A, self.decay_B,
                  self.cm_rk, self.cm_kv):
            common.dense_init_(w, gen)
        for w in (self.w_o, self.cm_vo):
            common.dense_init_(w, gen, scale=scale_out)
        common.dense_init_(self.bonus_u, gen)
        self.decay_w0.fill_(-2.0)
        self.ln_w.fill_(1.0)
        self.ln_b.zero_()

    def init_state(self, batch: int, device=None) -> dict:
        cfg, dd = self.cfg, self.dims
        return {"shift_tm": torch.zeros((batch, cfg.d_model), dtype=cfg.dtype, device=device),
                "shift_cm": torch.zeros((batch, cfg.d_model), dtype=cfg.dtype, device=device),
                "ssm": torch.zeros((batch, dd["heads"], dd["head_dim"], dd["head_dim"]),
                                   dtype=torch.float32, device=device)}

    def _timemix_inputs(self, x: torch.Tensor, prev_tok: torch.Tensor):
        b, l, d = x.shape
        dd = self.dims
        xx = _token_shift(x, prev_tok)
        r = _mix(x, xx, self.mu[0]) @ self.w_r
        k = _mix(x, xx, self.mu[1]) @ self.w_k
        v = _mix(x, xx, self.mu[2]) @ self.w_v
        g = _mix(x, xx, self.mu[4]) @ self.w_g
        # data-dependent decay (the RWKV6 contribution)
        wx = torch.tanh((_mix(x, xx, self.mu[3]) @ self.decay_A).float())
        w_log = self.decay_w0 + (wx.to(self.cfg.dtype) @ self.decay_B).float()
        # clamp per-step log-decay to the scan kernel's numeric contract
        decay = torch.exp(-torch.clamp(torch.exp(w_log), 0.0, MAX_NEG_LOGW))   # (B, L, D)

        def hsplit(t):
            return t.reshape(b, l, dd["heads"], dd["head_dim"]).transpose(1, 2)
        return hsplit(r), hsplit(k), hsplit(v), hsplit(decay), g

    def _out(self, out_bhlv: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        b, _, l, _ = out_bhlv.shape
        y = out_bhlv.transpose(1, 2).reshape(b, l, self.cfg.d_model)
        # per-head groupnorm approximated, as in the reference, by LN over all of D
        y = common.layer_norm(y, self.ln_w, self.ln_b, self.cfg.norm_eps)
        y = y * _silu(g).to(y.dtype)
        return y @ self.w_o

    def timemix(self, x: torch.Tensor, state: Optional[dict], decode: bool, train: bool = False):
        """Returns (out, new_ssm_state, new_shift). x: (B, L, D); ``train``
        runs the training pass's chunked scan."""
        b = x.shape[0]
        prev_tok = (state["shift_tm"] if state is not None
                    else torch.zeros((b, self.cfg.d_model), dtype=x.dtype, device=x.device))
        r, k, v, decay, g = self._timemix_inputs(x, prev_tok)
        s0 = state["ssm"] if state is not None else None
        if decode:
            out, s_new = ops.linear_scan_decode(r[:, :, 0], k[:, :, 0], v[:, :, 0],
                                                decay[:, :, 0], s0, bonus=self.bonus_u)
            out = out[:, :, None, :]
        else:
            scan = _train_scan if train else ops.linear_scan
            out, s_new = scan(r, k, v, decay, bonus=self.bonus_u, initial_state=s0)
        return self._out(out, g), s_new, x[:, -1, :]

    def channelmix(self, x: torch.Tensor, state: Optional[dict]):
        """Returns (out, new_shift). x: (B, L, D)."""
        b = x.shape[0]
        prev_tok = (state["shift_cm"] if state is not None
                    else torch.zeros((b, self.cfg.d_model), dtype=x.dtype, device=x.device))
        xx = _token_shift(x, prev_tok)
        rr = torch.sigmoid((_mix(x, xx, self.cm_mu[0]) @ self.cm_rk).float())
        kk = _mix(x, xx, self.cm_mu[1]) @ self.cm_kv
        kk = torch.square(torch.relu(kk.float())).to(x.dtype)
        vv = kk @ self.cm_vo
        return rr.to(x.dtype) * vv, x[:, -1, :]
