"""Scale tier: the fleet's host path on an 8-pipeline trace at its largest size.

Runs the adaptive fleet (``core/fleet.py``) on the scale trace
(``workloads.scale_trace``: the four pipelines plus a ``-v2`` alias of
each, sharing its profiler) and reports how many simulated requests the
host path serves per second of wall clock.  Only ``FleetSimulator.run`` is
timed, with the garbage collector off: its pauses grow with the live heap
(every request of the trace stays reachable), which is not the scheduler's
work.  The smoke tier is 512 chips and 100,000 requests; ``--full`` is 4096
chips and 1,000,000.  ``--fast`` (the default) turns on the fleet's three
host-path switches (``array_state``, ``incremental_ilp``,
``step_changed_lanes_only``); ``--no-fast`` runs without them.  Stages are
priced on ``H100_SXM`` (``--hw h100``) or on the JAX reference's constants
(``--hw reference``), where the simulated fields are the reference's.  No
tensor is computed, so it needs no card.

  PYTHONPATH=src python -m repro_torch.launch.scale [--full] [--chips N] \\
      [--requests N] [--hw reference] [--no-fast] [--json BENCH_scale.json]

Counterpart of ``benchmarks/e2e.py --scale`` (``run_scale``);
``--json`` writes ``BENCH_scale.json``'s layout, without the reference's
comparison against an older tree.
"""
from __future__ import annotations

import argparse
import gc
import json
import time
from typing import Dict, Optional, Sequence

from repro_torch.core import workloads
from repro_torch.core.fleet import (FAST_PATH, FLEET_SCHEDULERS, FleetConfig,
                                    FleetOrchestrator, FleetSimulator,
                                    PipelineRegistry)
from repro_torch.core.profiler import HARDWARE, H100_SXM, Hardware

SMOKE_CHIPS = 512
SMOKE_REQUESTS = 100_000
FULL_CHIPS = 4096
FULL_REQUESTS = 1_000_000
LEVEL = "medium"


def run_scale(chips: int = SMOKE_CHIPS, n_requests: int = SMOKE_REQUESTS,
              fast: bool = True, hw: Hardware = H100_SXM) -> Dict:
    """One run of the scale tier; returns its simulated fields and
    ``wall_s``, the host seconds of ``FleetSimulator.run`` alone."""
    scale = chips / workloads.SCALE_BASE_CHIPS
    rates = {pid: r * scale for pid, r in workloads.SCALE_RATES.items()}
    duration = n_requests / sum(rates.values())  # detlint: ignore[DET001] module-literal dict: insertion order is fixed
    reg = PipelineRegistry(hw=hw)
    for pid in workloads.SCALE_PIPELINES:
        if pid not in workloads.SCALE_ALIASES:
            reg.register(pid)
    for alias, base in workloads.SCALE_ALIASES.items():
        reg.register(alias, profiler=reg.profiler(base))
    profs = {pid: reg.profiler(pid) for pid in workloads.SCALE_PIPELINES}
    trace = workloads.scale_trace(duration, profs, seed=0, num_chips=chips, level=LEVEL)
    cfg = FleetConfig(num_chips=chips, **(FAST_PATH if fast else {}))
    orch = FleetOrchestrator(reg, num_chips=chips)
    sim = FleetSimulator(reg, FLEET_SCHEDULERS["adaptive"](orch, cfg), trace, cfg)
    gc.collect()
    gc.disable()
    try:
        t0 = time.perf_counter()
        res = sim.run()
        wall = time.perf_counter() - t0
    finally:
        gc.enable()
    return {"num_chips": chips, "fast": fast, "hw": hw.name,
            "duration_s": duration, "n_requests": len(trace),
            "n_finished": res.n_finished, "slo": res.slo_attainment,
            "sched_wakeups": res.sched_wakeups,
            "repartitions": len(res.repartitions) - 1,
            "wall_s": wall, "throughput_rps": len(trace) / max(wall, 1e-9)}


def bench_layout(run: Dict) -> Dict:
    """``BENCH_scale.json``'s fields for one run."""
    return {
        "bench": "scale_sim_core",
        "num_chips": run["num_chips"],
        "pipelines": list(workloads.SCALE_PIPELINES),
        "level": LEVEL,
        "fast_path": {k: run["fast"] for k in FAST_PATH},
        "n_requests": run["n_requests"],
        "duration_s": round(run["duration_s"], 1),
        "wall_s": round(run["wall_s"], 2),
        "throughput_rps": round(run["throughput_rps"], 1),
        "n_finished": run["n_finished"],
        "slo_pct": round(run["slo"] * 100, 2),
        "sched_wakeups": run["sched_wakeups"],
    }


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hw", choices=sorted(HARDWARE), default="h100",
                    help="the profiler's constant set: H100_SXM or the JAX "
                         "reference's")
    ap.add_argument("--full", action="store_true",
                    help=f"{FULL_CHIPS} chips and {FULL_REQUESTS} requests")
    ap.add_argument("--chips", type=int, default=None,
                    help=f"pool size (default {SMOKE_CHIPS}, --full {FULL_CHIPS})")
    ap.add_argument("--requests", type=int, default=None,
                    help=f"expected requests of the trace (default {SMOKE_REQUESTS}, "
                         f"--full {FULL_REQUESTS})")
    ap.add_argument("--fast", action=argparse.BooleanOptionalAction, default=True,
                    help="the fleet's host-path switches (array_state, "
                         "incremental_ilp, step_changed_lanes_only)")
    ap.add_argument("--json", default=None,
                    help="write BENCH_scale.json's layout here")
    args = ap.parse_args(argv)
    chips = args.chips or (FULL_CHIPS if args.full else SMOKE_CHIPS)
    n_req = args.requests or (FULL_REQUESTS if args.full else SMOKE_REQUESTS)
    run = run_scale(chips, n_req, fast=args.fast, hw=HARDWARE[args.hw])
    print(f"scale {chips} chips on {run['hw']} (fast={run['fast']}): "
          f"{run['n_finished']}/{run['n_requests']} finished, "
          f"SLO={run['slo'] * 100:.4f}%, {run['sched_wakeups']} wake-ups, "
          f"{run['repartitions']} re-partitions; {run['wall_s']:.2f} s of host "
          f"time, {run['throughput_rps']:.1f} requests/s")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(bench_layout(run), f, indent=2)
            f.write("\n")
    return run


if __name__ == "__main__":
    main()
