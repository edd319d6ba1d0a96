"""Serving entry point: run the TridentServe cluster on a workload.

Counterpart of ``repro/launch/serve.py``. It drives the scheduler on the
host, through the event-clock simulator: every stage is priced by the
profiler on the ``H100_SXM`` constant set (``core/profiler.py``), fitted to
the stage times ``chip_smoke.py`` measures on one H100, or on the JAX
reference's constants (``--hw reference``). No tensor is computed, so it
needs no card. ``--cross-node-sp`` lets trident's SP groups span nodes
(degrees up to 32 units; on ``H100_SXM`` a group wider than one node
exchanges at the inter-node rate).

  PYTHONPATH=src python -m repro_torch.launch.serve --pipeline flux \\
      --workload dynamic --duration 600 --chips 128 \\
      --baselines B1,B5,B6 [--cross-node-sp] [--no-batching] \\
      [--hw reference] [--json out.jsonl]
"""
from __future__ import annotations

import argparse
import json
from typing import List, Optional, Sequence

from repro_torch.core.baselines import BASELINES
from repro_torch.core.profiler import HARDWARE
from repro_torch.core.simulator import SimConfig, SimResult, run_sim
from repro_torch.core.trident import TridentScheduler


def main(argv: Optional[Sequence[str]] = None) -> List[SimResult]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pipeline", default="flux",
                    choices=["sd3", "flux", "cogvideox", "hunyuanvideo"])
    ap.add_argument("--workload", default="dynamic",
                    choices=["light", "medium", "heavy", "dynamic",
                             "proprietary"])
    ap.add_argument("--duration", type=float, default=600.0)
    ap.add_argument("--chips", type=int, default=128)
    ap.add_argument("--rate", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baselines", default="")
    ap.add_argument("--cross-node-sp", action="store_true",
                    help="let trident's SP groups span nodes")
    ap.add_argument("--hw", choices=sorted(HARDWARE), default="h100",
                    help="the profiler's constant set: H100_SXM or the JAX "
                         "reference's")
    ap.add_argument("--no-batching", action="store_true")
    ap.add_argument("--json", default=None, help="append results here")
    args = ap.parse_args(argv)

    sim_cfg = SimConfig(num_chips=args.chips)
    hw = HARDWARE[args.hw]
    results = [run_sim(args.pipeline, TridentScheduler, args.workload,
                       args.duration, sim_cfg=sim_cfg, seed=args.seed,
                       rate=args.rate, cross_node_sp=args.cross_node_sp, hw=hw,
                       enable_batching=not args.no_batching)]
    for b in (x for x in args.baselines.split(",") if x):
        results.append(run_sim(args.pipeline, BASELINES[b], args.workload,
                               args.duration, sim_cfg=sim_cfg, seed=args.seed,
                               rate=args.rate, hw=hw))
    for r in results:
        print(r.summary())
        if r.scheduler == "trident":
            print(f"  VR distribution {r.vr_histogram}; "
                  f"{len(r.placement_switches) - 1} placement switches; "
                  f"engine merged={r.engine_stats.get('merged_runs')} "
                  f"pushes={r.engine_stats.get('device_pushes')}; "
                  f"solver {r.solver_ms:.1f} ms")
    if args.json:
        with open(args.json, "a") as f:
            for r in results:
                f.write(json.dumps({
                    "scheduler": r.scheduler, "pipeline": r.pipeline,
                    "workload": args.workload, "oom": r.oom,
                    "slo": r.slo_attainment, "mean": r.mean_latency,
                    "p95": r.p95_latency}) + "\n")
    return results


if __name__ == "__main__":
    main()
