"""Fig. 3 + Appendix A — per-stage speedup vs SP degree and resolution."""
from __future__ import annotations

from typing import List

import repro_torch.configs as C
from repro_torch.benchmarks.common import Row
from repro_torch.core.profiler import H100_SXM, Hardware, Profiler
from repro_torch.core.request import Request


def run(quick: bool = True, hw: Hardware = H100_SXM) -> List[Row]:
    rows: List[Row] = []
    cases = {
        "sd3": [(r, 0.0) for r in (512, 1024, 2048, 4096)],
        "flux": [(r, 0.0) for r in (512, 1024, 2048, 4096)],
        "cogvideox": [(480, 2.0), (720, 4.0), (720, 8.0)],
        "hunyuanvideo": [(540, 2.0), (720, 4.0), (720, 8.0)],
    }
    pipes = ("flux", "cogvideox") if quick else list(cases)
    for pid in pipes:
        prof = Profiler(C.get(pid), hw=hw)
        for res, sec in cases[pid]:
            req = Request(pid, res, sec)
            for stage in "EDC":
                speed = {k: round(prof.speedup(req, stage, k * prof.k_min), 3)
                         for k in (1, 2, 4, 8)}
                rows.append((
                    f"parallelism/{pid}/{res}x{sec}/{stage}/opt_degree",
                    prof.optimal_degree(req, stage),
                    {"speedup": speed,
                     "t1_ms": round(prof.stage_time(req, stage, prof.k_min) * 1e3, 2)}))
    return rows
