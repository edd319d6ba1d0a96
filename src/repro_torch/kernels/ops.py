"""The kernel ops the models call.

Each op chooses by the tensor's device: a CPU tensor goes to the plain
version in ``ref.py``; a ``meta`` tensor gets an empty result of the
kernel's output shapes and dtypes, and nothing is built or launched; any
other tensor goes to the hand-written Hopper kernel, which launches on a
CUDA tensor or raises (no fallback). ``LAUNCHES`` counts the kernel
launches of each op, so a run can show that its path went through them.

While a counter is set (``COUNTER``, by ``roofline/counts.py``), each op
records its kernel's ``cost`` once a call, on every device, and the plain
version's own ops on the CPU go uncounted: the card never runs them.
Counterpart of ``repro/kernels/ops.py``.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from repro_torch.kernels import adaln_rmsnorm as _ar
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import ssm_scan as _ss

LAUNCHES = {"flash_attention": 0, "adaln_rmsnorm": 0, "ssm_scan": 0}
# the active counter (``roofline.counts.Counter``) or None
COUNTER = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _plain():
    """The plain version's ops, uncounted."""
    return COUNTER.paused() if COUNTER is not None else contextlib.nullcontext()


def _count(name: str, cost: tuple, out) -> None:
    if COUNTER is not None:
        COUNTER.kernel(name, cost, out)


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
        with _plain():
            mask = None
            if causal or window:
                mask = attention_mask(q.shape[1], k.shape[1], window, q.device)
            # in the kernel's layout: what follows then runs the same ops on every device
            out = ref.attention_ref(q, k, v, mask, softcap).contiguous()
    elif q.device.type == "meta":
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
    else:
        out = _fa.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)
        LAUNCHES["flash_attention"] += 1
    _count("flash_attention", _fa.cost(q, k, v, causal=causal, window=window), out)
    return out


def adaln_rmsnorm(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, *,
                  eps: float = 1e-6) -> torch.Tensor:
    """x: (B, L, D); scale/shift: (B, D)."""
    if x.is_cpu:
        with _plain():
            out = ref.adaln_rmsnorm_ref(x, scale, shift, eps)
    elif x.is_meta:
        out = torch.empty_like(x)
    else:
        out = _ar.adaln_rmsnorm(x, scale, shift, eps=eps)
        LAUNCHES["adaln_rmsnorm"] += 1
    _count("adaln_rmsnorm", _ar.cost(x, scale, shift), out)
    return out


def linear_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, decay: torch.Tensor, *,
                bonus: Optional[torch.Tensor] = None,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, L, K) inputs -> (out (B, H, L, V), final_state (B, H, K, V) f32)."""
    if q.device.type == "cpu":
        with _plain():
            out = ref.ssm_scan_ref(q, k, v, decay, bonus, initial_state)
    elif q.device.type == "meta":
        out = tuple(torch.empty(shape, dtype=dt, device=q.device)
                    for shape, dt in _ss.out_shapes(q, v))
    else:
        out = _ss.ssm_scan(q, k, v, decay, bonus=bonus, initial_state=initial_state)
        LAUNCHES["ssm_scan"] += 1
    _count("ssm_scan", _ss.cost(q, k, v, decay, bonus=bonus, initial_state=initial_state), out)
    return out


def linear_scan_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, decay: torch.Tensor,
                       state: torch.Tensor, *, bonus: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrence; plain torch on every device (it is a matvec,
    and the reference has no kernel for it)."""
    return ref.linear_scan_decode_ref(q, k, v, decay, state, bonus)
