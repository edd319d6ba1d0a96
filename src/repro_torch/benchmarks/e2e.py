"""Fig. 10 — end-to-end SLO attainment / mean / P95 across pipelines x
workloads x {TridentServe, B1..B6}, on the ported core.

Counterpart of ``benchmarks/e2e.py``. Also hosts:

* the smoke set (``run_smoke``): the event-driven clock timed against the
  tick clock on identical traces, written as ``BENCH_event_sim.json`` and,
  with ``unified_bench_path``, ``BENCH_unified_clock.json``;
* ``run_mixed``: the 512-chip mixed sd3 + flux + cogvideox deployment, three
  static sub-clusters each run by its own TridentServe instance;
* ``run_profile``: the per-subsystem wall shares of one scale-tier run;
* the fleet and scale smokes of ``run.py --smoke``, which call
  ``launch/serve_fleet.py`` and ``launch/scale.py`` with the reference's
  smoke arguments.

Every script prices stages with the profiler's constant set ``hw``:
``H100_SXM`` by default, ``REFERENCE_HW`` for the JAX reference's numbers.
Not ported: the reference's timings of other checked-out trees
(``time_seed_tree``, ``kernel_overhead_pct``, the scale tier's comparison
against a pre-scale-out tree), which run the JAX package itself.

  PYTHONPATH=src python -m repro_torch.benchmarks.e2e [--smoke|--mixed|--profile] \\
      [--full] [--hw reference]
"""
from __future__ import annotations

import importlib
import json
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.benchmarks.common import Row, duration
from repro_torch.core.baselines import BASELINES
from repro_torch.core.profiler import H100_SXM, Hardware
from repro_torch.core.simulator import SimConfig, run_sim
from repro_torch.core.trident import TridentScheduler

PIPES_QUICK = ("flux", "hunyuanvideo")
PIPES_FULL = ("sd3", "flux", "cogvideox", "hunyuanvideo")
WORKLOADS_QUICK = ("medium", "dynamic")
WORKLOADS_FULL = ("light", "medium", "heavy", "dynamic", "proprietary")

SCHEDS = {"trident": TridentScheduler, **BASELINES}

BENCH_REPEATS = 3   # best-of-N sim-core timing (damps machine noise)

# CI smoke set: small enough to run in seconds under the event clock, with
# enough sparse-video coverage that the tick clock's O(horizon/tick) cost
# shows.  (pipeline, scheduler, workload, duration_s, rate_override)
SMOKE_SCENARIOS: Tuple[Tuple[str, str, str, float, Optional[float]], ...] = (
    ("sd3", "trident", "light", 60.0, None),
    ("sd3", "B4", "light", 60.0, None),
    ("flux", "trident", "medium", 120.0, None),
    ("hunyuanvideo", "trident", "heavy", 300.0, None),
    ("hunyuanvideo", "B6", "heavy", 300.0, None),
    ("cogvideox", "trident", "medium", 300.0, None),
    # the event clock's home turf: long sparse video traces, where the tick
    # loop burns 1/tick iterations per simulated second doing nothing —
    # overnight-valley traffic at a twentieth of the Table-5 rates
    ("hunyuanvideo", "trident", "dynamic", 3600.0, None),
    ("hunyuanvideo", "trident", "proprietary", 3600.0, 0.05),
    ("hunyuanvideo", "trident", "light", 3600.0, 0.05),
    ("cogvideox", "trident", "light", 3600.0, 0.05),
    ("cogvideox", "trident", "medium", 3600.0, 0.1),
    ("flux", "trident", "light", 3600.0, 0.1),
)

# 512-chip mixed deployment: static sub-clusters per pipeline, each run by
# its own TridentServe instance over its share of the arrival budget.
MIXED_PARTITION: Dict[str, int] = {"sd3": 128, "flux": 192, "cogvideox": 192}


def run(quick: bool = True, hw: Hardware = H100_SXM) -> List[Row]:
    rows: List[Row] = []
    pipes = PIPES_QUICK if quick else PIPES_FULL
    workloads = WORKLOADS_QUICK if quick else WORKLOADS_FULL
    dur = duration(quick)
    for pid in pipes:
        for wl in workloads:
            for name, cls in SCHEDS.items():
                res = run_sim(pid, cls, wl, dur, hw=hw)
                rows.append((
                    f"e2e/{pid}/{wl}/{name}/slo_pct",
                    round(res.slo_attainment * 100, 2),
                    {"mean_s": round(res.mean_latency, 3) if not res.oom else "OOM",
                     "p95_s": round(res.p95_latency, 3) if not res.oom else "OOM",
                     "oom": res.oom,
                     "finished": res.n_finished,
                     "requests": res.n_requests}))
    return rows


# ---------------------------------------------------------------- smoke bench

def run_smoke_mode(mode: str, hw: Hardware = H100_SXM) -> Tuple[List[Row], float, int]:
    """Run the smoke set under one clock mode; returns (rows, wall_s, wakeups).

    Only ``Simulator.run`` is timed: profiler tables and traces are built
    outside the timer (they are identical across modes — same seeds, same
    cost model), so the wall-clock ratio measures the simulation core the
    clock mode actually changes.
    """
    import repro_torch.configs as configs
    from repro_torch.core import workloads
    from repro_torch.core.profiler import Profiler
    from repro_torch.core.simulator import Simulator

    rows: List[Row] = []
    wakeups = 0
    wall = 0.0
    profs: Dict[Tuple[str, Optional[int]], Profiler] = {}
    for pid, sched, wl, dur, rate in SMOKE_SCENARIOS:
        cls = SCHEDS[sched]
        k_min = getattr(cls, "FORCE_KMIN", None)
        prof = profs.get((pid, k_min))
        if prof is None:
            prof = profs[(pid, k_min)] = Profiler(configs.get(pid), hw=hw, force_k_min=k_min)
        trace = workloads.make_trace(pid, wl, dur, prof, seed=0, rate=rate)
        sim_cfg = SimConfig(mode=mode)
        sim = Simulator(pid, cls(prof, sim_cfg, trace), trace, sim_cfg)
        t0 = time.perf_counter()
        res = sim.run()
        wall += time.perf_counter() - t0
        wakeups += res.sched_wakeups
        # duration/rate are part of the name: the set may contain the same
        # (pipeline, workload, scheduler) at several scales
        tag = f"{wl}{int(dur)}s" + (f"r{rate:g}" if rate is not None else "")
        rows.append((f"e2e_smoke/{pid}/{tag}/{sched}/{mode}/slo_pct",
                     round(res.slo_attainment * 100, 2),
                     {"mean_s": round(res.mean_latency, 3),
                      "p95_s": round(res.p95_latency, 3),
                      "wakeups": res.sched_wakeups,
                      "finished": res.n_finished}))
    return rows, wall, wakeups


def _best_of(mode: str, hw: Hardware = H100_SXM,
             repeats: int = BENCH_REPEATS) -> Tuple[List[Row], float, int]:
    best: Optional[Tuple[List[Row], float, int]] = None
    for _ in range(repeats):
        rows, wall, wk = run_smoke_mode(mode, hw)
        if best is None or wall < best[1]:
            best = (rows, wall, wk)
    return best


def _smoke_metrics_match(event_rows: List[Row], tick_rows: List[Row]) -> bool:
    ev = {n.rsplit("/", 2)[0]: (v, d.get("mean_s"), d.get("p95_s"))
          for n, v, d in event_rows if "/slo_pct" in n}
    tk = {n.rsplit("/", 2)[0]: (v, d.get("mean_s"), d.get("p95_s"))
          for n, v, d in tick_rows if "/slo_pct" in n}
    return ev == tk


def run_smoke(bench_path: Optional[str] = None, unified_bench_path: Optional[str] = None,
              hw: Hardware = H100_SXM, repeats: int = BENCH_REPEATS) -> List[Row]:
    """Event vs tick clock on identical traces; records the speedup (the
    best of ``repeats`` timings of each) in ``bench_path``, and with
    ``unified_bench_path`` the same measurements as the unified clock
    kernel's record."""
    rows, wall_event, wk_event = _best_of("event", hw, repeats)
    tick_rows, wall_tick, wk_tick = _best_of("tick", hw, repeats)
    speedup = wall_tick / max(wall_event, 1e-9)
    match = _smoke_metrics_match(rows, tick_rows)
    rows.append(("e2e_smoke/wallclock_speedup_event_vs_tick", round(speedup, 2),
                 {"wall_event_s": round(wall_event, 3),
                  "wall_tick_s": round(wall_tick, 3),
                  "wakeups_event": wk_event, "wakeups_tick": wk_tick}))
    # machine-checkable parity row: run.py --smoke exits nonzero when the
    # event clock stops reproducing the tick clock's metrics
    rows.append(("e2e_smoke/metrics_match_event_vs_tick", float(match), {}))
    fields = {
        "scenarios": [list(s) for s in SMOKE_SCENARIOS],
        "wall_event_s": round(wall_event, 4),
        "wall_tick_s": round(wall_tick, 4),
        "speedup_event_vs_tick": round(speedup, 2),
        "sched_wakeups_event": wk_event,
        "sched_wakeups_tick": wk_tick,
        "metrics_match": match,
    }
    for path, bench in ((bench_path, "event_driven_simulator_smoke"),
                        (unified_bench_path, "unified_clock_kernel")):
        if path:
            _write({"bench": bench, **fields}, path)
    return rows


def _write(bench: Dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(bench, f, indent=2)
        f.write("\n")


# ---------------------------------------------------------------- mixed-512

def run_mixed(quick: bool = True, hw: Hardware = H100_SXM) -> List[Row]:
    """512-chip mixed sd3 + flux + cogvideox deployment (event clock).

    Each pipeline gets a static sub-cluster (chips per MIXED_PARTITION) and
    its Table-5 arrival rate; the trace horizon is 1 h in full mode."""
    dur = 600.0 if quick else 3600.0
    rows: List[Row] = []
    tot_reqs = tot_fin = 0
    slo_weighted = 0.0
    lat_weighted = 0.0
    p95_max = 0.0
    t0 = time.perf_counter()
    wakeups = 0
    for pid, chips in MIXED_PARTITION.items():  # detlint: ignore[DET001] module-literal dict: iteration order is source order
        cfg = SimConfig(num_chips=chips, mode="event")
        res = run_sim(pid, TridentScheduler, "dynamic", dur, sim_cfg=cfg, hw=hw)
        wakeups += res.sched_wakeups
        rows.append((f"e2e_mixed512/{pid}/slo_pct",
                     round(res.slo_attainment * 100, 2),
                     {"chips": chips, "mean_s": round(res.mean_latency, 3),
                      "p95_s": round(res.p95_latency, 3),
                      "finished": res.n_finished, "requests": res.n_requests,
                      "wakeups": res.sched_wakeups}))
        tot_reqs += res.n_requests
        tot_fin += res.n_finished
        slo_weighted += res.slo_attainment * res.n_requests
        lat_weighted += res.mean_latency * res.n_requests
        p95_max = max(p95_max, res.p95_latency)
    rows.append(("e2e_mixed512/aggregate/slo_pct",
                 round(100.0 * slo_weighted / max(1, tot_reqs), 2),
                 {"chips": sum(MIXED_PARTITION.values()),  # detlint: ignore[DET001] int chip counts: exact
                  "duration_s": dur,
                  "mean_s": round(lat_weighted / max(1, tot_reqs), 3),
                  "p95_max_s": round(p95_max, 3),
                  "finished": tot_fin, "requests": tot_reqs,
                  "wakeups": wakeups,
                  "wall_s": round(time.perf_counter() - t0, 2)}))
    return rows


# ------------------------------------------------------ fleet and scale smokes

def _fleet_rows(scenario: str, runs) -> List[Row]:
    """One row per fleet run: its P95, with SLO, mean, goodput and host s."""
    return [(f"e2e_{scenario}_smoke/{r.mode}/p95_s", round(r.result.p95_latency, 3),
             {"slo_pct": round(r.result.slo_attainment * 100, 2),
              "mean_s": round(r.result.mean_latency, 3),
              "goodput_rps": round(r.result.goodput, 3),
              "finished": r.result.n_finished, "requests": r.result.n_requests,
              "wall_s": round(r.wall_s, 2)}) for r in runs]


def run_shared_smoke(bench_path: Optional[str] = None, hw: Hardware = H100_SXM) -> List[Row]:
    """The shared-cluster smoke: a 240 s mix-flip trace, static vs adaptive,
    fleet windows shrunk to match (``serve_fleet --scenario shared --smoke``)."""
    from repro_torch.launch import serve_fleet
    runs = serve_fleet.run_shared(hw=hw, duration=240.0, modes=("static", "adaptive"),
                                  fleet_cfg_kw={"t_win": 90.0, "cooldown": 60.0},
                                  bench_path=bench_path)
    return _fleet_rows("shared", runs)


def run_predictive_smoke(bench_path: Optional[str] = None,
                         hw: Hardware = H100_SXM) -> List[Row]:
    """The predictive smoke: 4 diurnal periods on 128 chips, seed 0."""
    from repro_torch.launch import serve_fleet
    sm = serve_fleet.PREDICTIVE_SMOKE
    runs = serve_fleet.run_predictive(hw=hw, duration=sm["duration"], periods=sm["periods"],
                                      rates=sm["rates"], fleet_cfg_kw=sm["cfg"], seeds=(0,),
                                      bench_path=bench_path)
    return _fleet_rows("predictive", runs)


def run_cross_batch_smoke(bench_path: Optional[str] = None,
                          hw: Hardware = H100_SXM) -> List[Row]:
    """The cross-lane batching smoke: the burst storm at 2/3 scale, seed 0,
    no narrative arms."""
    from repro_torch.launch import serve_fleet
    sm = serve_fleet.CROSS_BATCH_SMOKE
    runs = serve_fleet.run_cross_batch(hw=hw, duration=sm["duration"], head=sm["head"],
                                       base_rates=sm["base_rates"],
                                       wave_rates=sm["wave_rates"], fleet_cfg_kw=sm["cfg"],
                                       seeds=(0,), narrative_arms=(), bench_path=bench_path)
    return _fleet_rows("cross_batch", runs)


def run_elastic_smoke(bench_path: Optional[str] = None, hw: Hardware = H100_SXM) -> List[Row]:
    """The elastic smoke: one preemption storm on 128 chips at half rate."""
    from repro_torch.launch import serve_fleet
    sm = serve_fleet.ELASTIC_SMOKE
    runs = serve_fleet.run_elastic(hw=hw, duration=sm["duration"], rates=sm["rates"],
                                   n_storms=sm["n_storms"], fleet_cfg_kw=sm["cfg"],
                                   seeds=(0,), bench_path=bench_path)
    return _fleet_rows("elastic", runs)


def run_scale_smoke(bench_path: Optional[str] = None, hw: Hardware = H100_SXM) -> List[Row]:
    """The scale tier's smoke size (512 chips, 100,000 requests) with the
    fleet's host-path switches on, once (``launch/scale.py``)."""
    from repro_torch.launch import scale
    got = scale.run_scale(scale.SMOKE_CHIPS, scale.SMOKE_REQUESTS, fast=True, hw=hw)
    if bench_path:
        _write(scale.bench_layout(got), bench_path)
    return [(f"e2e_scale/{got['num_chips']}chips/{got['n_requests']}req/throughput_rps",
             round(got["throughput_rps"], 1),
             {"wall_s": round(got["wall_s"], 2), "slo_pct": round(got["slo"] * 100, 2),
              "finished": got["n_finished"], "wakeups": got["sched_wakeups"],
              "repartitions": got["repartitions"]})]


# ------------------------------------------------------------- wall profile

# per-subsystem wall-share buckets: (bucket, module path, class, methods)
_PROFILE_TARGETS = (
    ("dispatch_ilp", "repro_torch.core.dispatcher", "Dispatcher", ("dispatch",)),
    ("cross_lane_batching", "repro_torch.core.dispatcher", "CrossLaneBatcher",
     ("plan", "finalize")),
    ("monitor", "repro_torch.core.monitor", "Monitor",
     ("record_stage", "record_backlog", "next_window_boundary", "pattern_change")),
    ("monitor", "repro_torch.core.monitor", "FleetMonitor",
     ("record_arrival", "record_finish", "record_util", "record_class_demand", "demand",
      "demand_shares", "slo_attainment", "backlog_pressure", "idle_supply",
      "next_window_boundary", "mix_shift")),
    ("orchestrator", "repro_torch.core.fleet", "FleetOrchestrator", ("generate", "budgets")),
    ("lending", "repro_torch.core.lending", "LendingBroker", ("step", "sample")),
    ("engine_execute", "repro_torch.core.runtime", "RuntimeEngine", ("execute",)),
)


def run_profile(full: bool = False, hw: Hardware = H100_SXM) -> List[Row]:
    """Per-subsystem wall shares of one scale-tier run (a tenth of its
    requests).

    Wraps the subsystem entry points (dispatch/ILP, monitor, orchestrator,
    lending, cross-lane batching, engine execute) with wall accumulators
    and runs the scale slice in-process; whatever wall is left over is the
    clock kernel + lane bookkeeping.  A single global re-entrancy guard
    attributes nested calls (e.g. the orchestrator consulting the monitor)
    to the *outermost* bucket, so the shares are additive.
    """
    from repro_torch.core import workloads
    from repro_torch.core.fleet import (FAST_PATH, FLEET_SCHEDULERS, FleetConfig,
                                        FleetOrchestrator, FleetSimulator, PipelineRegistry)
    from repro_torch.launch import scale

    chips = scale.FULL_CHIPS if full else scale.SMOKE_CHIPS
    n_req = (scale.FULL_REQUESTS if full else scale.SMOKE_REQUESTS) // 10
    acc: Dict[str, float] = {}
    depth = [0]
    patched = []
    for bucket, modname, clsname, methods in _PROFILE_TARGETS:
        cls = getattr(importlib.import_module(modname), clsname)
        for meth in methods:
            orig = cls.__dict__[meth]

            def timed(*a, __orig=orig, __b=bucket, **kw):
                if depth[0]:
                    return __orig(*a, **kw)
                depth[0] = 1
                t0 = time.perf_counter()
                try:
                    return __orig(*a, **kw)
                finally:
                    depth[0] = 0
                    acc[__b] = acc.get(__b, 0.0) + time.perf_counter() - t0
            setattr(cls, meth, timed)
            patched.append((cls, meth, orig))
    try:
        reg = PipelineRegistry(hw=hw)
        for pid in workloads.SCALE_PIPELINES:
            if pid not in workloads.SCALE_ALIASES:
                reg.register(pid)
        for a, b in workloads.SCALE_ALIASES.items():
            reg.register(a, profiler=reg.profiler(b))
        profs = {pid: reg.profiler(pid) for pid in workloads.SCALE_PIPELINES}
        dur = workloads.scale_duration(n_req, chips)
        trace = workloads.scale_trace(dur, profs, seed=0, num_chips=chips, level=scale.LEVEL)
        cfg = FleetConfig(num_chips=chips, **FAST_PATH)
        orch = FleetOrchestrator(reg, num_chips=chips)
        sim = FleetSimulator(reg, FLEET_SCHEDULERS["adaptive"](orch, cfg), trace, cfg)
        t0 = time.perf_counter()
        sim.run()
        wall = time.perf_counter() - t0
    finally:
        for cls, meth, orig in patched:
            setattr(cls, meth, orig)
    rows: List[Row] = []
    accounted = sum(acc[k] for k in sorted(acc))
    acc["clock_kernel_and_lanes"] = max(0.0, wall - accounted)
    for bucket in sorted(acc):
        rows.append((f"e2e_scale_profile/{chips}chips/{bucket}/wall_s",
                     round(acc[bucket], 3),
                     {"share_pct": round(100.0 * acc[bucket] / max(wall, 1e-9), 1)}))
    rows.append((f"e2e_scale_profile/{chips}chips/total/wall_s", round(wall, 3),
                 {"requests": len(trace),
                  "throughput_rps": round(len(trace) / max(wall, 1e-9), 1)}))
    return rows


if __name__ == "__main__":
    import argparse

    from repro_torch.benchmarks.common import emit
    from repro_torch.core.profiler import HARDWARE

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hw", choices=sorted(HARDWARE), default="h100",
                    help="the profiler's constant set: H100_SXM or the JAX reference's")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke set's event-vs-tick speedup (writes --bench-json)")
    ap.add_argument("--mixed", action="store_true",
                    help="the 512-chip mixed sd3 + flux + cogvideox deployment")
    ap.add_argument("--profile", action="store_true",
                    help="per-subsystem wall shares of one scale-tier run")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--bench-json", default=None,
                    help="with --smoke: write BENCH_event_sim.json's layout here")
    ap.add_argument("--unified-json", default=None,
                    help="with --smoke: also write BENCH_unified_clock.json's layout here")
    args = ap.parse_args()
    hw_set = HARDWARE[args.hw]
    if args.profile:
        emit(run_profile(full=args.full, hw=hw_set))
    if args.smoke:
        emit(run_smoke(bench_path=args.bench_json, unified_bench_path=args.unified_json,
                       hw=hw_set))
    if args.mixed:
        emit(run_mixed(quick=not args.full, hw=hw_set))
    if not (args.smoke or args.mixed or args.profile):
        emit(run(quick=not args.full, hw=hw_set))
