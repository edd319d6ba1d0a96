"""Kernel K1: flash attention on Hopper (``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``. The CUDA
kernel reads q/k/v in their ``(B, L, H, D)`` layout through strides, masks the
ragged edge itself (any ``L`` works), and takes bf16 with D in {64, 128, 256}
(256: gemma2's heads, on a ring of 64-key tiles).
This wrapper checks what it is given and launches; it never falls back.
``cost`` gives the operations and bytes of a call, which its bound is
priced at (``PEAK``: the bf16 tensor cores) and which ``roofline/counts.py``
counts.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (64, 128, 256)
PEAK = "bf16_tensor"             # the peak the bound prices the operations at
_VP = ctypes.c_void_p
_ARGTYPES = [_VP, _VP, _VP, _VP, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, _VP, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, _VP]


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention kernel: tensors must be on a CUDA device")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(f"flash_attention kernel takes bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention kernel: bad shapes {q.shape} {k.shape} {v.shape}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"flash_attention kernel: q {q.shape} and k/v {k.shape} disagree")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dim in {HEAD_DIMS}, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel: {name} needs unit stride on D, other "
                             f"strides a multiple of 8 and 16-byte alignment: {t.stride()}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Lq, H, D); k/v: (B, Lkv, H, D), GQA already expanded -> (B, Lq, H, D).

    A window implies the causal mask, as in the plain version."""
    _check(q, k, v)
    b, lq, h, d = q.shape
    lkv = k.shape[1]
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                       *o.stride()[:3])
    fn = _build.function("repro_flash_attention_bf16", _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, lq, lkv, d,
                 ctypes.addressof(strides), int(causal or window > 0), int(window), float(softcap),
                 1.0 / math.sqrt(d), stream)
    _build.check(err, "flash_attention")
    return o


def kept_pairs(lq: int, lkv: int, causal: bool = True, window: int = 0) -> int:
    """The query-key pairs one (batch, head) keeps: every pair without a
    mask, else those of ``ops.attention_mask`` (queries at the end of the
    keys, each seeing itself and the ``window - 1`` keys before it)."""
    if not (causal or window):
        return lq * lkv
    # query i sees n = i + lkv - lq + 1 keys (none when n <= 0), at most window
    lo = max(lkv - lq + 1, 1)
    if lo > lkv:
        return 0
    cap = window if window else lkv
    mid = min(lkv, cap)
    total = (lo + mid) * (mid - lo + 1) // 2 if lo <= mid else 0
    return total + cap * (lkv - max(lo, cap + 1) + 1) if lkv > cap else total


def cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
         window: int = 0) -> tuple:
    """(operations, bytes) of one call: 4 per kept query-key pair and head
    dim (the two products), and q, k, v and o each read or written once."""
    b, lq, h, d = q.shape
    lkv = k.shape[1]
    flops = 4.0 * kept_pairs(lq, lkv, causal, window) * b * h * d
    nbytes = q.element_size() * (2 * b * lq * h * d + 2 * b * lkv * h * d)
    return flops, nbytes
