"""Fig. 13 — Adjust-on-Dispatch vs naive shutdown adjustment."""
from __future__ import annotations

from typing import List

from repro_torch.benchmarks.common import Row
from repro_torch.core.profiler import H100_SXM, Hardware
from repro_torch.core.simulator import SimConfig, run_sim
from repro_torch.core.trident import TridentScheduler


def run(quick: bool = True, hw: Hardware = H100_SXM) -> List[Row]:
    dur = 900.0 if quick else 1800.0
    aod = run_sim("flux", TridentScheduler, "dynamic", dur, rate=2.2, hw=hw)
    down = run_sim("flux", TridentScheduler, "dynamic", dur, rate=2.2,
                   sim_cfg=SimConfig(downtime_adjust=True), hw=hw)
    return [
        ("adjust_on_dispatch/flux/dynamic/mean_latency_s",
         round(aod.mean_latency, 3),
         {"p95_s": round(aod.p95_latency, 3),
          "slo_pct": round(aod.slo_attainment * 100, 1),
          "downtime_s": aod.engine_stats.get("downtime", 0.0),
          "adjust_loads": aod.engine_stats.get("adjust_loads", 0)}),
        ("adjust_on_dispatch/flux/dynamic/downtime_mean_latency_s",
         round(down.mean_latency, 3),
         {"p95_s": round(down.p95_latency, 3),
          "slo_pct": round(down.slo_attainment * 100, 1),
          "downtime_s": round(down.engine_stats.get("downtime", 0.0), 2)}),
    ]
