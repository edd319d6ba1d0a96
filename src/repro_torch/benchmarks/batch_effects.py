"""Fig. 17 / Appendix E.1 — batch-size effects per stage (Encode batches
almost freely, Diffuse only at low resolution, Decode not at all)."""
from __future__ import annotations

from typing import List

import repro_torch.configs as C
from repro_torch.benchmarks.common import Row
from repro_torch.core.profiler import H100_SXM, Hardware, Profiler
from repro_torch.core.request import Request


def _batched_time(prof: Profiler, req: Request, stage: str, bs: int) -> float:
    """Latency of a batch of ``bs`` identical requests on one unit, at the
    profiler's peak rate, MFU and memory bandwidth.
    Compute-bound stages amortize; memory-bound ones scale linearly."""
    hw = prof.hw
    flops = prof.stage_flops(req, stage) * bs
    hbm = prof.stage_hbm_bytes(req, stage) + (bs - 1) * prof.stage_act_bytes(req, stage) * 3
    k = prof.k_min
    return max(flops / (k * hw.peak_flops * hw.mfu), hbm / (k * hw.hbm_bw))


def run(quick: bool = True, hw: Hardware = H100_SXM) -> List[Row]:
    rows: List[Row] = []
    prof = Profiler(C.get("sd3"), hw=hw)
    for stage, res in (("E", 512), ("D", 256), ("D", 1024), ("C", 1024)):
        req = Request("sd3", res)
        t1 = _batched_time(prof, req, stage, 1)
        opt_bs = 1
        for bs in (2, 4, 8, 16, 32):
            tb = _batched_time(prof, req, stage, bs)
            if tb <= t1 * 1.2:   # paper E.1: batch latency <= 1.2x single
                opt_bs = bs
        rows.append((f"batch_effects/sd3/{stage}@{res}/opt_batch", opt_bs,
                     {"t1_ms": round(t1 * 1e3, 2),
                      "t_at_opt_ms": round(_batched_time(prof, req, stage, opt_bs) * 1e3, 2)}))
    return rows
