"""Fig. 15 — SLO scaling: attainment as the SLO scale factor alpha varies."""
from __future__ import annotations

from typing import List

from repro_torch.benchmarks.common import Row, duration
from repro_torch.core.baselines import BASELINES
from repro_torch.core.profiler import H100_SXM, Hardware
from repro_torch.core.simulator import run_sim
from repro_torch.core.trident import TridentScheduler


def run(quick: bool = True, hw: Hardware = H100_SXM) -> List[Row]:
    rows: List[Row] = []
    alphas = (1.5, 2.5, 5.0) if quick else (1.0, 1.5, 2.5, 5.0, 10.0)
    scheds = {"trident": TridentScheduler, "B6": BASELINES["B6"], "B5": BASELINES["B5"]}
    for alpha in alphas:
        for name, cls in scheds.items():
            res = run_sim("flux", cls, "dynamic", duration(quick), slo_scale=alpha, hw=hw)
            rows.append((f"slo_sensitivity/flux/alpha{alpha}/{name}/slo_pct",
                         round(res.slo_attainment * 100, 2),
                         {"mean_s": round(res.mean_latency, 3)}))
    return rows
