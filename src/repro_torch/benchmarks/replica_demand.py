"""Fig. 4 — replica proportions that balance stage processing speeds, per
workload level (what motivates dynamic re-placement)."""
from __future__ import annotations

import random
from typing import List

import repro_torch.configs as C
from repro_torch.benchmarks.common import Row
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.profiler import H100_SXM, Hardware, Profiler
from repro_torch.core.request import Request
from repro_torch.core.workloads import MIXES


def run(quick: bool = True, hw: Hardware = H100_SXM) -> List[Row]:
    rows: List[Row] = []
    pipes = ("flux",) if quick else list(C.PIPELINE_IDS)
    for pid in pipes:
        prof = Profiler(C.get(pid), hw=hw)
        orch = Orchestrator(prof, num_chips=128)
        rng = random.Random(0)
        for level in ("light", "medium", "heavy"):
            mix = MIXES[pid][level]
            reqs = []
            for _ in range(200):
                total = sum(w for _, w in mix)
                x = rng.uniform(0, total)
                acc = 0.0
                for (res, sec), w in mix:
                    acc += w
                    if x <= acc:
                        break
                reqs.append(Request(pid, res, float(sec)))
            plan = orch.generate(reqs)
            hist = plan.type_histogram()
            d_units = sum(n for t, n in hist.items() if "D" in t)  # detlint: ignore[DET001] int unit counts: exact
            rows.append((
                f"replica_demand/{pid}/{level}/d_unit_share",
                round(d_units / plan.num_units, 3),
                {"placement": hist}))
    return rows
