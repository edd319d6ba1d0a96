"""Kernel K2: AdaLN-modulated RMSNorm on Hopper (``csrc/adaln_rmsnorm.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/adaln_rmsnorm.py``. The CUDA
kernel holds each row in registers, reads each block's (B, D) modulation row
once, and takes float32 or bfloat16; ``plan`` picks its instantiation. This
wrapper checks what it is given and launches; it never falls back.

The launch path is cut to what a call needs: shapes, strides, dtypes and
devices are checked once per signature and remembered with the launch record
the C entry point takes; each call checks only its pointers' alignment, takes
the raw stream handle, and enters a device guard only when the tensors are
not on the current device. ``cost`` gives the operations and bytes of a
call, which its bound is priced at (``PEAK``: f32 outside the tensor
cores) and which ``roofline/counts.py`` counts.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# 16-byte vectors per lane the kernel is built for (launch_v in the .cu)
VECTORS = (1, 2, 4, 6, 8, 12, 16, 24)
BLOCK_WARPS = 4                 # warps per block, halved for short calls
SMS = 132                       # an H100 SXM's SMs
MAX_B = 65535                   # the grid's second dimension
PEAK = "f32"                    # the peak the bound prices the operations at
_VP = ctypes.c_void_p


class _Launch(ctypes.Structure):
    """``AdalnLaunch`` in the .cu: one signature's launch."""
    _fields_ = [(name, ctypes.c_int) for name in
                ("B", "L", "D", "vectors", "lanes_log2", "warps")] + [
        ("scale_stride", ctypes.c_longlong), ("shift_stride", ctypes.c_longlong),
        ("eps", ctypes.c_float), ("dtype", ctypes.c_int)]


_ARGTYPES = [_VP] * 6
# signature (``_key``) -> (device index, launch record, its address)
_SIGNATURES: dict = {}
_launch_fn = None


def plan(b: int, l: int, d: int, dtype: torch.dtype) -> dict:
    """The kernel's instantiation for x of (b, l, d) in ``dtype``: 16-byte
    vectors per lane and lanes per row (the fewest lanes, up to a warp, that
    take the row, with the fewest vectors each), rows per warp and per block,
    the grid (a block per group of rows along L, batch rows) and the dynamic
    shared memory (the block's modulation row, scale and shift). Warps per
    block: BLOCK_WARPS, halved while the grid has fewer than two blocks per
    SM, so short calls spread over every SM."""
    size = dtype.itemsize
    per_vec = 16 // size
    if d <= 0 or d % per_vec:
        raise ValueError(f"adaln_rmsnorm kernel: D={d} must be a positive multiple of {per_vec}")
    nvec = d // per_vec
    lanes = min(32, 1 << (nvec - 1).bit_length())
    need = -(-nvec // lanes)
    if need > VECTORS[-1]:
        raise ValueError(f"adaln_rmsnorm kernel takes D up to {32 * VECTORS[-1] * per_vec} "
                         f"in {dtype}, got {d}")
    vectors = min(v for v in VECTORS if v >= need)
    rows_per_warp = 32 // lanes
    warps = BLOCK_WARPS
    while warps > 1 and b * -(-l // (warps * rows_per_warp)) < 2 * SMS:
        warps //= 2
    rows_per_block = warps * rows_per_warp
    return {"vectors": vectors, "lanes": lanes, "rows_per_warp": rows_per_warp, "warps": warps,
            "rows_per_block": rows_per_block, "grid": (-(-l // rows_per_block), b),
            "smem_bytes": 2 * d * size}


def _key(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, eps: float) -> tuple:
    """What ``_launch_record`` checks: shapes, strides, dtypes, devices, eps."""
    return (x.shape, x.stride(), x.dtype, x.device, scale.shape, scale.stride(), scale.dtype,
            scale.device, shift.shape, shift.stride(), shift.dtype, shift.device, eps)


def _launch_record(key: tuple) -> tuple:
    """Check one signature (``_key``) and build its launch: (device index,
    ``_Launch``, the record's address). Raises on what the kernel does not
    take."""
    (xs, xst, xdt, xdev, ss, sst, sdt, sdev, ts, tst, tdt, tdev, eps) = key
    if not (xdev.type == sdev.type == tdev.type == "cuda" and xdev == sdev == tdev):
        raise ValueError(f"adaln_rmsnorm kernel: tensors must be on one CUDA device, got "
                         f"{xdev}/{sdev}/{tdev}")
    if xdt not in DTYPES or not (xdt == sdt == tdt):
        raise ValueError(f"adaln_rmsnorm kernel takes float32 or bfloat16 for x, scale and "
                         f"shift alike, got {xdt}/{sdt}/{tdt}")
    if len(xs) != 3 or ss != (xs[0], xs[2]) or ts != ss:
        raise ValueError(f"adaln_rmsnorm kernel: bad shapes {xs} {ss} {ts}")
    b, l, d = xs
    if b > MAX_B:
        raise ValueError(f"adaln_rmsnorm kernel takes B up to {MAX_B}, got {b}")
    p = plan(b, l, d, xdt)               # refuses a width it has no instantiation for
    if any(n != 1 and st != want for n, st, want in zip(xs, xst, (l * d, d, 1))):
        raise ValueError(f"adaln_rmsnorm kernel: x must be contiguous, strides {xst}")
    per_vec = 16 // xdt.itemsize
    for name, st in (("scale", sst), ("shift", tst)):
        if st[1] != 1 or st[0] % per_vec:
            raise ValueError(f"adaln_rmsnorm kernel: {name} rows need unit stride and a row "
                             f"stride that keeps 16-byte alignment: {st}")
    launch = _Launch(b, l, d, p["vectors"], p["lanes"].bit_length() - 1, p["warps"], sst[0],
                     tst[0], eps, DTYPES[xdt])
    return xdev.index, launch, ctypes.addressof(launch)


def adaln_rmsnorm(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, *,
                  eps: float = 1e-6) -> torch.Tensor:
    """x: (B, L, D); scale/shift: (B, D) -> (B, L, D) in x's dtype."""
    key = _key(x, scale, shift, eps)
    sig = _SIGNATURES.get(key)
    if sig is None:
        sig = _SIGNATURES[key] = _launch_record(key)
    dev, _, launch = sig
    px, ps, pt = x.data_ptr(), scale.data_ptr(), shift.data_ptr()
    if (px | ps | pt) & 15:
        raise ValueError("adaln_rmsnorm kernel: x, scale and shift must be 16-byte aligned")
    out = torch.empty_like(x)
    global _launch_fn
    if _launch_fn is None:
        _launch_fn = _build.function("repro_adaln_rmsnorm", _ARGTYPES)
    if torch._C._cuda_getDevice() == dev:
        err = _launch_fn(px, ps, pt, out.data_ptr(), launch,
                         torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            err = _launch_fn(px, ps, pt, out.data_ptr(), launch,
                             torch._C._cuda_getCurrentRawStream(dev))
    if err:
        _build.check(err, "adaln_rmsnorm")
    return out


def cost(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> tuple:
    """(operations, bytes) of one call: 6 a element of x (square, sum, scale
    by the reciprocal rms, 1 + scale, multiply, add), and x read, y written
    and the (B, D) scale and shift read once."""
    b, l, d = x.shape
    es = x.element_size()
    return 6.0 * b * l * d, 2 * b * l * d * es + 2 * b * d * es
