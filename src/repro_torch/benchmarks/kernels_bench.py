"""Kernel microbenchmarks: the plain versions' wall time on the CPU
(``kernels/ref.py``, which the kernel ops run for CPU tensors), at the
reference's three shapes.

Counterpart of ``benchmarks/kernels_bench.py``. These are host times of
plain PyTorch, not of the Hopper kernels: ``chip_smoke.py`` times those
on the card. ``hw`` is taken for the harness's signature and unused."""
from __future__ import annotations

import time
from typing import List

import torch

from repro_torch.benchmarks.common import Row
from repro_torch.core.profiler import H100_SXM, Hardware
from repro_torch.kernels import ops, ref


def _time(fn, *args, iters: int = 5) -> float:
    """Microseconds a call, after one untimed call."""
    fn(*args)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters * 1e6


def run(quick: bool = True, hw: Hardware = H100_SXM) -> List[Row]:
    rows: List[Row] = []
    g = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g)

    b, l, h, d = 1, 512, 4, 64
    q, k, v = randn(b, l, h, d), randn(b, l, h, d), randn(b, l, h, d)
    mask = ops.attention_mask(l, l, 0, q.device)
    rows.append(("kernels/attention_ref_512/us_per_call",
                 round(_time(ref.attention_ref, q, k, v, mask), 1),
                 {"shape": f"{b}x{l}x{h}x{d}"}))

    q2, k2, v2 = randn(1, 4, 1024, 16), randn(1, 4, 1024, 16), randn(1, 4, 1024, 16)
    w2 = torch.exp(-torch.exp(randn(1, 4, 1024, 16) * 0.3))
    rows.append(("kernels/linear_scan_ref_1024/us_per_call",
                 round(_time(ref.ssm_scan_ref, q2, k2, v2, w2), 1),
                 {"shape": "1x4x1024x16"}))

    x = randn(4, 1024, 256)
    s, t = randn(4, 256) * 0.1, randn(4, 256) * 0.1
    rows.append(("kernels/adaln_rmsnorm_ref/us_per_call",
                 round(_time(ref.adaln_rmsnorm_ref, x, s, t), 1), {"shape": "4x1024x256"}))
    return rows
