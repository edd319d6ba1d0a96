"""Kernel K2: AdaLN-modulated RMSNorm on Hopper (``csrc/adaln_rmsnorm.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/adaln_rmsnorm.py``. The CUDA
kernel reads each row's (B, D) modulation row by ``row // L`` instead of a
broadcast copy, and takes float32 or bfloat16. This wrapper checks what it
is given and launches; it never falls back.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VP = ctypes.c_void_p
_ARGTYPES = [_VP, _VP, _VP, _VP, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_float, ctypes.c_int, _VP]


def _check(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> None:
    if not (x.is_cuda and scale.is_cuda and shift.is_cuda):
        raise ValueError("adaln_rmsnorm kernel: tensors must be on a CUDA device")
    if x.dtype not in DTYPES or not (x.dtype == scale.dtype == shift.dtype):
        raise ValueError(f"adaln_rmsnorm kernel takes float32 or bfloat16 for x, scale and "
                         f"shift alike, got {x.dtype}/{scale.dtype}/{shift.dtype}")
    if x.dim() != 3 or scale.shape != (x.shape[0], x.shape[2]) or shift.shape != scale.shape:
        raise ValueError(f"adaln_rmsnorm kernel: bad shapes {x.shape} {scale.shape} {shift.shape}")
    per_vec = 16 // x.element_size()
    if x.shape[2] % per_vec:
        raise ValueError(f"adaln_rmsnorm kernel: D={x.shape[2]} must be a multiple of {per_vec}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("adaln_rmsnorm kernel: x must be contiguous and 16-byte aligned")
    for name, t in (("scale", scale), ("shift", shift)):
        if t.stride(1) != 1 or t.stride(0) % per_vec or t.data_ptr() % 16:
            raise ValueError(f"adaln_rmsnorm kernel: {name} rows need unit stride, a row "
                             f"stride that keeps 16-byte alignment: {t.stride()}")


def adaln_rmsnorm(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, *,
                  eps: float = 1e-6) -> torch.Tensor:
    """x: (B, L, D); scale/shift: (B, D) -> (B, L, D) in x's dtype."""
    _check(x, scale, shift)
    b, l, d = x.shape
    out = torch.empty_like(x)
    fn = _build.function("repro_adaln_rmsnorm", _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), scale.data_ptr(), shift.data_ptr(), out.data_ptr(), b * l, l, d,
                 scale.stride(0), shift.stride(0), float(eps), DTYPES[x.dtype], stream)
    _build.check(err, "adaln_rmsnorm")
    return out
