"""Fig. 12 — Virtual Replica type distribution (most requests must land on
the lowest-communication feasible type)."""
from __future__ import annotations

from typing import List

from repro_torch.benchmarks.common import Row, duration
from repro_torch.core.profiler import H100_SXM, Hardware
from repro_torch.core.simulator import run_sim
from repro_torch.core.trident import TridentScheduler


def run(quick: bool = True, hw: Hardware = H100_SXM) -> List[Row]:
    rows: List[Row] = []
    for pid in ("flux", "hunyuanvideo"):
        res = run_sim(pid, TridentScheduler, "medium", duration(quick), hw=hw)
        total = sum(res.vr_histogram.values()) or 1  # detlint: ignore[DET001] int request counts: exact
        v0_share = res.vr_histogram.get(0, 0) / total
        low2 = (res.vr_histogram.get(0, 0) + res.vr_histogram.get(1, 0)) / total
        rows.append((f"vr_distribution/{pid}/v0_share", round(v0_share, 3),
                     {"hist": res.vr_histogram,
                      "v0_plus_v1_share": round(low2, 3)}))
    return rows
