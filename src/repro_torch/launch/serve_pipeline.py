"""End-to-end serving example: a simulated H100 cluster serving a dynamic
diffusion workload with TridentServe vs the baselines (B1, B5 and the
strongest, B6), printing the SLO/latency comparison and the
placement-switch timeline.

Counterpart of ``examples/serve_pipeline.py``. The event-clock simulator
drives the runtime engine; stage latencies come from the profiler on the
``H100_SXM`` constant set, not from stage executions on a card.

  PYTHONPATH=src python -m repro_torch.launch.serve_pipeline [--pipeline flux]
      [--workload dynamic] [--duration 480]
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.core.baselines import BASELINES
from repro_torch.core.simulator import run_sim
from repro_torch.core.trident import TridentScheduler


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pipeline", default="flux",
                    choices=["sd3", "flux", "cogvideox", "hunyuanvideo"])
    ap.add_argument("--workload", default="dynamic",
                    choices=["light", "medium", "heavy", "dynamic",
                             "proprietary"])
    ap.add_argument("--duration", type=float, default=480.0)
    ap.add_argument("--baselines", default="B1,B5,B6")
    args = ap.parse_args(argv)

    res = run_sim(args.pipeline, TridentScheduler, args.workload,
                  args.duration)
    print(res.summary())
    print(f"  VR distribution: {res.vr_histogram}")
    print("  placement timeline:")
    for t, hist in res.placement_switches:
        print(f"    t={t:7.1f}s  {hist}")
    print(f"  engine: merged={res.engine_stats.get('merged_runs')} "
          f"pushes={res.engine_stats.get('device_pushes')} "
          f"adjust_loads={res.engine_stats.get('adjust_loads')}")
    for name in (x for x in args.baselines.split(",") if x):
        r = run_sim(args.pipeline, BASELINES[name], args.workload,
                    args.duration)
        print(r.summary())


if __name__ == "__main__":
    main()
