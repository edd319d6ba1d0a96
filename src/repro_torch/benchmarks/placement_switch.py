"""Fig. 11 — throughput timeline + placement switches on the Dynamic
workload (Trident vs the static-placement B6)."""
from __future__ import annotations

from typing import List

from repro_torch.benchmarks.common import Row
from repro_torch.core.baselines import BASELINES
from repro_torch.core.profiler import H100_SXM, Hardware
from repro_torch.core.simulator import run_sim
from repro_torch.core.trident import TridentScheduler

RATE = 2.2   # stressed arrival rate: load surges force re-placement (Fig 11)


def run(quick: bool = True, hw: Hardware = H100_SXM) -> List[Row]:
    dur = 900.0 if quick else 1800.0   # switches need warm-up past T_win/2
    rows: List[Row] = []
    t = run_sim("flux", TridentScheduler, "dynamic", dur, rate=RATE, hw=hw)
    b6 = run_sim("flux", BASELINES["B6"], "dynamic", dur, rate=RATE, hw=hw)
    rows.append(("placement_switch/flux/dynamic/trident/switches",
                 len(t.placement_switches) - 1,
                 {"slo_pct": round(t.slo_attainment * 100, 1),
                  "timeline": t.placement_switches[:6],
                  "throughput_per_min": t.throughput_timeline[:10]}))
    rows.append(("placement_switch/flux/dynamic/B6/switches", 0,
                 {"slo_pct": round(b6.slo_attainment * 100, 1),
                  "throughput_per_min": b6.throughput_timeline[:10]}))
    return rows
