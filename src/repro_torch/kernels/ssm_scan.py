"""Kernel K3: the gated linear-attention scan on Hopper (``csrc/ssm_scan.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/ssm_scan.py``, which serves
both Mamba2 (inclusive read) and RWKV6 (strict-past read plus the bonus
term). The CUDA kernel runs the recurrence token by token with the state in
registers, so it stays finite at the decay floor and does not depend on its
chunk length; it stages chunks of CHUNK tokens through a ring of STAGES
shared-memory stages by TMA, and reads q/k/v/decay through their strides,
so Mamba2's head-shared B/C and per-head decay stay stride-0 views (a decay
whose last stride is 0 takes the kernel's scalar-decay path). This
wrapper checks what it is given and launches; it never falls back.
``cost`` gives the operations and bytes of a call, which its bound is
priced at (``PEAK``: f32 outside the tensor cores) and which
``roofline/counts.py`` counts.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

# tokens the kernel stages per chunk, and chunks in its ring of shared-memory
# stages (CHUNK and STAGES in csrc/ssm_scan.cu); the result depends on neither
CHUNK = 16
STAGES = 3
# per-step log-decay clamp of the TPU kernel (``repro/kernels/ssm_scan.py``),
# kept by the kernel and by its plain version alike
MAX_NEG_LOGW = 5.4
MAX_DIM = 64                     # largest K and V the kernel takes
PEAK = "f32"                     # the peak the bound prices the operations at
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VP = ctypes.c_void_p
_ARGTYPES = [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, _VP, ctypes.c_int, _VP]
_PLAN_ARGTYPES = [_VP, _VP, _VP, _VP] + [ctypes.c_int] * 6 + [_VP, ctypes.c_int, _VP]
# the tensors the kernel copies element by element (ELEM_* in csrc/ssm_scan.cu)
_ELEM = (("q", 1), ("k", 2), ("v", 4), ("decay", 8))


def _check(q, k, v, decay, bonus, initial_state) -> None:
    ts = [q, k, v, decay] + [t for t in (bonus, initial_state) if t is not None]
    if not all(t.is_cuda and t.device == q.device for t in ts):
        raise ValueError("ssm_scan kernel: tensors must be on one CUDA device")
    if q.dtype not in DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"ssm_scan kernel takes float32 or bfloat16 q/k/v alike, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.shape != q.shape or decay.shape != q.shape or v.dim() != 4 \
            or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"ssm_scan kernel: bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} decay {tuple(decay.shape)}")
    b, h, _, dk = q.shape
    dv = v.shape[3]
    if not (1 <= dk <= MAX_DIM and 1 <= dv <= MAX_DIM):
        raise ValueError(f"ssm_scan kernel takes K and V in 1..{MAX_DIM}, got {dk}, {dv}")
    if decay.dtype != torch.float32:
        raise ValueError(f"ssm_scan kernel takes a float32 decay, got {decay.dtype}")
    if bonus is not None and (bonus.shape != (h, dk) or bonus.dtype != torch.float32
                              or not bonus.is_contiguous()):
        raise ValueError(f"ssm_scan kernel: bonus must be ({h}, {dk}) float32 contiguous, "
                         f"got {tuple(bonus.shape)} {bonus.dtype}")
    if initial_state is not None and (initial_state.shape != (b, h, dk, dv)
                                      or initial_state.dtype != torch.float32
                                      or not initial_state.is_contiguous()):
        raise ValueError(f"ssm_scan kernel: initial_state must be ({b}, {h}, {dk}, {dv}) "
                         f"float32 contiguous, got {tuple(initial_state.shape)} "
                         f"{initial_state.dtype}")


def ssm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, decay: torch.Tensor, *,
             bonus: Optional[torch.Tensor] = None,
             initial_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q/k/decay: (B, H, L, K); v: (B, H, L, V); bonus: (H, K) f32 or None.

    Returns (out (B, H, L, V) in v's dtype, final_state (B, H, K, V) f32).
    Without a bonus the read is inclusive (Mamba2), with one it is the strict
    past plus the bonus term (RWKV6)."""
    return _scan("repro_ssm_scan", (), q, k, v, decay, bonus, initial_state)


def ssm_scan_rows(rows: int, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  decay: torch.Tensor, *, bonus: Optional[torch.Tensor] = None,
                  initial_state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ssm_scan`` with the kernel's rows of S per thread forced to ``rows``
    (2, 4 or 8: slices of 16, 32 or 64 columns), for the tile sweep."""
    return _scan("repro_ssm_scan_rows", (rows,), q, k, v, decay, bonus, initial_state)


def _strides(q, k, v, decay):
    return (ctypes.c_longlong * 16)(*q.stride(), *k.stride(), *v.stride(), *decay.stride())


def _scan(name, lead, q, k, v, decay, bonus, initial_state):
    _check(q, k, v, decay, bonus, initial_state)
    b, h, l, dk = q.shape
    dv = v.shape[3]
    out = torch.empty((b, h, l, dv), dtype=v.dtype, device=v.device)
    final = torch.empty((b, h, dk, dv), dtype=torch.float32, device=v.device)
    strides = _strides(q, k, v, decay)
    fn = _build.function(name, [ctypes.c_int] * len(lead) + _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(*lead, q.data_ptr(), k.data_ptr(), v.data_ptr(), decay.data_ptr(),
                 None if bonus is None else bonus.data_ptr(),
                 None if initial_state is None else initial_state.data_ptr(),
                 out.data_ptr(), final.data_ptr(), b, h, l, dk, dv, ctypes.addressof(strides),
                 DTYPES[q.dtype], stream)
    _build.check(err, "ssm_scan")
    return out, final


def plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, decay: torch.Tensor, *,
         bonus: Optional[torch.Tensor] = None) -> dict:
    """What the kernel does with these inputs: its rows of S per thread, the
    slice of V a block takes, the staging path ("tma", or which tensors it
    copies element by element), the decay path (a per-token decay lands by
    4-byte cp.async), its shared memory per block and the blocks resident
    per SM."""
    _check(q, k, v, decay, bonus, None)
    out = (ctypes.c_int * 6)()
    strides = _strides(q, k, v, decay)
    fn = _build.function("repro_ssm_scan_plan", _PLAN_ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), decay.data_ptr(), bonus is not None,
                 q.shape[0], q.shape[1], q.shape[2], q.shape[3], v.shape[3],
                 ctypes.addressof(strides), DTYPES[q.dtype], out)
    _build.check(err, "ssm_scan plan")
    rows, cols, elem, scalar, smem, per_sm = out
    staging = [name for name, bit in _ELEM if elem & bit]
    return {"rows": rows, "slice": cols,
            "staging": "element-wise " + ",".join(staging) if staging else "tma",
            "decay": "per-token" if scalar else "per-channel", "smem_bytes": smem,
            "blocks_per_sm": per_sm}


def unique_bytes(t: torch.Tensor) -> int:
    """Bytes a tensor holds: a stride-0 (broadcast) dimension counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        n *= size if stride else 1
    return n * t.element_size()


def out_shapes(q: torch.Tensor, v: torch.Tensor) -> tuple:
    """The (shape, dtype) of the call's two outputs: out (B, H, L, V) in v's
    dtype and the final state (B, H, K, V) in float32."""
    b, h, l, dk = q.shape
    dv = v.shape[3]
    return ((b, h, l, dv), v.dtype), ((b, h, dk, dv), torch.float32)


def cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, decay: torch.Tensor, *,
         bonus: Optional[torch.Tensor] = None,
         initial_state: Optional[torch.Tensor] = None) -> tuple:
    """(operations, bytes) of one call: 5 per token, K and V element (the
    state's update 3, the read 2), and the unique bytes of the inputs (a
    head-shared view once), both outputs, the bonus and the initial state."""
    b, h, l, dk = q.shape
    dv = v.shape[3]
    nbytes = sum(unique_bytes(t) for t in (q, k, v, decay))
    nbytes += sum(math.prod(shape) * torch.empty((), dtype=dt).element_size()
                  for shape, dt in out_shapes(q, v))
    nbytes += sum(unique_bytes(t) for t in (bonus, initial_state) if t is not None)
    return 5.0 * b * h * l * dk * dv, nbytes
