"""Fig. 14 — component ablations: wo-switch / wo-stageAware / wo-scheduler."""
from __future__ import annotations

from typing import List

from repro_torch.benchmarks.common import Row
from repro_torch.core.profiler import H100_SXM, Hardware
from repro_torch.core.simulator import run_sim
from repro_torch.core.trident import TridentScheduler

VARIANTS = {
    "full": {},
    "wo-switch": {"enable_switch": False},
    "wo-stageAware": {"stage_aware": False},
    "wo-scheduler": {"use_ilp": False},
}


def run(quick: bool = True, hw: Hardware = H100_SXM) -> List[Row]:
    rows: List[Row] = []
    pipes = ("flux",) if quick else ("flux", "hunyuanvideo")
    workloads = ("dynamic",) if quick else ("dynamic", "medium")
    dur = 900.0 if quick else 1800.0
    rate = 2.2  # stressed load: components only matter under contention
    for pid in pipes:
        for wl in workloads:
            for name, kw in VARIANTS.items():
                res = run_sim(pid, TridentScheduler, wl, dur, rate=rate, hw=hw, **kw)
                rows.append((
                    f"ablation/{pid}/{wl}/{name}/slo_pct",
                    round(res.slo_attainment * 100, 2),
                    {"mean_s": round(res.mean_latency, 3),
                     "p95_s": round(res.p95_latency, 3)}))
    return rows
