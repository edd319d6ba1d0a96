"""Bench-regression gate: compare fresh benchmark JSON against the
committed baselines and exit non-zero on regression.

Two comparison regimes per (baseline, current) pair, keyed by the files'
``bench`` field:

* **same scale** (equal ``duration_s``/scenarios): headline metrics must
  stay within ``--tolerance`` (default 10%) of the baseline — deterministic
  metrics (wakeup counts, SLO, improvement ratios) use it directly;
  wall-clock-derived metrics (speedups) use the looser ``--wall-tolerance``
  (default 35%) because CI machines are noisy.
* **different scale** (e.g. the 240 s shared smoke vs the committed 600 s
  run): exact ratios are not comparable, so the gate falls back to the
  scenario's acceptance *floors* (the same ones documented in
  benchmarks/README.md).

The port's own copy of ``benchmarks/check_regression.py``: the same
checks, floors and tolerances, for the JSON the port's benchmark scripts write.
Usage (what ``repro_torch.benchmarks.run --smoke --hw reference`` does):

    PYTHONPATH=src python -m repro_torch.benchmarks.check_regression \
        --pair BENCH_event_sim.json results/BENCH_event_sim.torch_smoke.json \
        --pair BENCH_shared_cluster.json results/BENCH_shared.torch_smoke.json

Exit status 0 = no regression; 1 = regression (problems printed); 2 = bad
invocation / unreadable files.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

# acceptance floors, per bench kind (benchmarks/README.md)
EVENT_SPEEDUP_FLOOR = 1.2          # event clock must beat the tick clock
SHARED_P95_FLOOR = 1.2             # adaptive fleet vs static sub-clusters
LENDING_WORST_P95_FLOOR = 1.0      # lending must never hurt the worst lane
PREDICTIVE_P95_FLOOR = 1.15        # predictive vs adaptive, worst pipeline
                                   # on the committed diurnal trace
PREDICTIVE_SMOKE_FLOOR = 1.0       # scale-aware: at smoke scale the
                                   # predictive scheduler must never be
                                   # worse than adaptive
CROSS_BATCH_P95_FLOOR = 1.15       # cross-lane batching vs off, aggregate
                                   # P95 on the committed burst-storm trace
CROSS_BATCH_SMOKE_FLOOR = 1.0      # scale-aware: at smoke scale batching
                                   # must never be worse than off
UNIFIED_OVERHEAD_CEIL_PCT = 5.0    # kernel overhead vs the old hand-rolled
                                   # loops (wall-clock-class measurement)
SCALE_SPEEDUP_FLOOR = 5.0          # sim-core throughput vs the pre-scale-out
                                   # tree, extrapolated to the full 4096-chip
                                   # tier (the PR's acceptance bar)
SCALE_SMOKE_SPEEDUP_FLOOR = 0.6    # scale-aware: at 512 chips the fast paths
                                   # barely matter (the broken bottlenecks
                                   # were superlinear in chips) — the smoke
                                   # check only guards against the fast paths
                                   # becoming an outright slowdown
SCALE_SLO_FLOOR_PCT = 95.0         # the scale trace is sized to be servable;
                                   # a throughput "win" that drops SLO is a
                                   # broken scheduler, not a fast one
ELASTIC_RECOVERY_FLOOR = 1.15      # drain-aware vs drain-unaware recovery
                                   # P95 on the committed preemption storm
ELASTIC_SWEEP_FLOOR = 0.95         # off-canonical arrival seeds: drain must
                                   # never make recovery materially worse
ELASTIC_SMOKE_FLOOR = 0.9          # scale-aware: the 128-chip smoke storm
                                   # is too small to back the pool up, so
                                   # smoke only guards parity — the
                                   # mechanism canaries below do the work
SCALE_RPS_SANITY_FRACTION = 0.05   # cross-scale wall sanity fallback: only
                                   # consulted when the smoke run timed no
                                   # reference tree (the same-machine probe
                                   # ratio is strictly better evidence, so it
                                   # takes precedence) — a 512-chip smoke run
                                   # below 5% of the committed 4096-chip
                                   # throughput is a hung machine or a broken
                                   # build, not a slow one


def _ratio_check(problems: List[str], name: str, current: float,
                 baseline: float, tol: float, floor: float = 0.0) -> None:
    """Higher-is-better metric: current must stay within ``tol`` of the
    baseline and above the absolute floor."""
    if current < floor:
        problems.append(f"{name}: {current} below acceptance floor {floor}")
    elif baseline > 0 and current < baseline * (1.0 - tol):
        problems.append(f"{name}: {current} regressed vs baseline "
                        f"{baseline} (tolerance {tol:.0%})")


def _count_check(problems: List[str], name: str, current: float,
                 baseline: float, tol: float) -> None:
    """Lower-is-better deterministic counter (e.g. scheduler wake-ups)."""
    if baseline > 0 and current > baseline * (1.0 + tol):
        problems.append(f"{name}: {current} exceeds baseline "
                        f"{baseline} (tolerance {tol:.0%})")


def check_event_sim(base: Dict, cur: Dict, tol: float,
                    wall_tol: float) -> List[str]:
    problems: List[str] = []
    if not cur.get("metrics_match", False):
        problems.append("metrics_match: event clock diverged from tick clock")
    if base.get("scenarios") == cur.get("scenarios"):
        _count_check(problems, "sched_wakeups_event",
                     cur.get("sched_wakeups_event", 0),
                     base.get("sched_wakeups_event", 0), tol)
    _ratio_check(problems, "speedup_event_vs_tick",
                 cur.get("speedup_event_vs_tick", 0.0),
                 base.get("speedup_event_vs_tick", 0.0),
                 wall_tol, floor=EVENT_SPEEDUP_FLOOR)
    return problems


def check_shared_cluster(base: Dict, cur: Dict, tol: float,
                         wall_tol: float) -> List[str]:
    problems: List[str] = []
    same_scale = base.get("duration_s") == cur.get("duration_s")
    for key in ("p95_improvement_adaptive_vs_static",
                "worst_pipeline_p95_improvement"):
        if same_scale:
            _ratio_check(problems, key, cur.get(key, 0.0),
                         base.get(key, 0.0), tol, floor=SHARED_P95_FLOOR)
    if not same_scale:
        # shorter smoke traces never reach the full run's aggregate ratio;
        # the scale-free signals are "adaptive not worse than static" on
        # aggregate P95 and the acceptance floor on the worst pipeline
        # (where the mix flip bites hardest even at smoke scale)
        _ratio_check(problems, "p95_improvement_adaptive_vs_static",
                     cur.get("p95_improvement_adaptive_vs_static", 0.0),
                     0.0, tol, floor=1.0)
        _ratio_check(problems, "worst_pipeline_p95_improvement",
                     cur.get("worst_pipeline_p95_improvement", 0.0),
                     0.0, tol, floor=SHARED_P95_FLOOR)
    if same_scale:
        for mode, m in base.get("modes", {}).items():
            cur_m = cur.get("modes", {}).get(mode)
            if cur_m is None:
                continue
            _ratio_check(problems, f"modes.{mode}.slo_pct",
                         cur_m.get("slo_pct", 0.0), m.get("slo_pct", 0.0),
                         tol)
    else:
        # scale-free sanity: adaptive must not do worse than static
        modes = cur.get("modes", {})
        if "static" in modes and "adaptive" in modes:
            if (modes["adaptive"].get("slo_pct", 0.0)
                    < modes["static"].get("slo_pct", 0.0) - 100 * tol):
                problems.append("modes.adaptive.slo_pct fell below static")
    return problems


def check_unit_lending(base: Dict, cur: Dict, tol: float,
                       wall_tol: float) -> List[str]:
    problems: List[str] = []
    key = "worst_pipeline_p95_improvement_lending_vs_adaptive"
    same_scale = base.get("duration_s") == cur.get("duration_s")
    _ratio_check(problems, key, cur.get(key, 0.0),
                 base.get(key, 0.0) if same_scale else 0.0, tol,
                 floor=LENDING_WORST_P95_FLOOR)
    if cur.get("diffuse_runs_on_borrowed_units", 0) != 0:
        problems.append("diffuse work landed on borrowed units")
    return problems


def check_unified_clock(base: Dict, cur: Dict, tol: float,
                        wall_tol: float) -> List[str]:
    """The unified event-clock kernel's acceptance record
    (BENCH_unified_clock.json).  Deterministic signals are tight: the
    kernel must keep reproducing tick-mode metrics and must not inflate
    wake-up counts.  Wall-derived signals get the wall-clock-class
    tolerance: the event-vs-tick speedup must hold vs the baseline, and —
    when the run measured it against a pre-unification tree — the
    kernel's per-mode overhead must stay under the 5% acceptance ceiling."""
    # same contract as the event-sim smoke pair (delegated, so the two
    # gates can never drift apart) ...
    problems = check_event_sim(base, cur, tol, wall_tol)
    # ... plus the tick-mode wakeup count and the overhead ceiling
    if base.get("scenarios") == cur.get("scenarios"):
        _count_check(problems, "sched_wakeups_tick",
                     cur.get("sched_wakeups_tick", 0),
                     base.get("sched_wakeups_tick", 0), tol)
    for key in ("kernel_overhead_pct_event", "kernel_overhead_pct_tick"):
        if key in cur and cur[key] > UNIFIED_OVERHEAD_CEIL_PCT:
            problems.append(f"{key}: {cur[key]}% exceeds the "
                            f"{UNIFIED_OVERHEAD_CEIL_PCT}% kernel-overhead "
                            f"ceiling")
    return problems


def check_predictive(base: Dict, cur: Dict, tol: float,
                     wall_tol: float) -> List[str]:
    """Predictive re-partitioning on the diurnal trace
    (BENCH_predictive.json).  Same scale: the worst-pipeline improvement
    must hold near the committed baseline and above the 1.15x acceptance
    floor.  Different scale (the CI smoke variant): scale-aware floor —
    predictive must never be worse than adaptive (>= 1.0x) and must have
    actually exercised the pre-warm path (a run that never stages is a
    broken forecaster, not a passing one)."""
    problems: List[str] = []
    key = "worst_pipeline_p95_improvement_predictive_vs_adaptive"
    same_scale = base.get("duration_s") == cur.get("duration_s")
    _ratio_check(problems, key, cur.get(key, 0.0),
                 base.get(key, 0.0) if same_scale else 0.0, tol,
                 floor=(PREDICTIVE_P95_FLOOR if same_scale
                        else PREDICTIVE_SMOKE_FLOOR))
    if cur.get("prewarm_units", 0) <= 0:
        problems.append("predictive run staged no pre-warm loads")
    if cur.get("predictive_repartitions", 0) <= 0:
        problems.append("predictive run never fired a predicted shift")
    return problems


def check_cross_batch(base: Dict, cur: Dict, tol: float,
                      wall_tol: float) -> List[str]:
    """Cross-lane dynamic batching on the burst-storm trace
    (BENCH_cross_batch.json).  Same scale: the aggregate P95 improvement
    must hold near the committed baseline and above the 1.15x acceptance
    floor.  Different scale (the CI smoke variant): scale-aware floor —
    batching must never be worse than off (>= 1.0x).  Either way the run
    must have actually fused launches across lanes (a run with zero
    merges is a broken candidate path, not a passing one)."""
    problems: List[str] = []
    key = "p95_improvement_batching_vs_off"
    same_scale = base.get("duration_s") == cur.get("duration_s")
    _ratio_check(problems, key, cur.get(key, 0.0),
                 base.get(key, 0.0) if same_scale else 0.0, tol,
                 floor=(CROSS_BATCH_P95_FLOOR if same_scale
                        else CROSS_BATCH_SMOKE_FLOOR))
    if cur.get("cross_lane_merges", 0) <= 0:
        problems.append("batching run fused no cross-lane launches")
    return problems


def check_scale(base: Dict, cur: Dict, tol: float,
                wall_tol: float) -> List[str]:
    """Sim-core throughput at fleet scale (BENCH_scale.json).  Same scale
    (equal chips and requests): throughput must hold near the committed
    baseline within the wall-clock-class tolerance, and when the run
    measured a pre-scale-out reference tree the extrapolated speedup must
    stay above the acceptance floor — and a run that *lost* the reference
    measurement the baseline has is itself flagged, so the floor cannot be
    skipped silently.  Different scale (the 512-chip CI smoke vs the
    committed 4096-chip tier): raw throughput is not comparable, so the
    gate checks structural invariants — every request finished, SLO held,
    the fast paths were actually on — plus the scale-aware smoke speedup
    floor when a reference tree was timed (at 512 chips the broken
    bottlenecks barely bite, so the floor only rejects outright
    slowdowns); only when no same-machine probe exists does it fall back
    to the lenient cross-scale throughput sanity fraction."""
    problems: List[str] = []
    same_scale = (base.get("num_chips") == cur.get("num_chips")
                  and base.get("n_requests") == cur.get("n_requests"))
    if cur.get("n_finished", 0) != cur.get("n_requests", -1):
        problems.append("scale run dropped requests "
                        f"({cur.get('n_finished')}/{cur.get('n_requests')})")
    if cur.get("slo_pct", 0.0) < SCALE_SLO_FLOOR_PCT:
        problems.append(f"slo_pct: {cur.get('slo_pct')} below the "
                        f"{SCALE_SLO_FLOOR_PCT}% floor")
    fast = cur.get("fast_path", {})
    if not all(fast.get(k) for k in ("array_state", "incremental_ilp",
                                     "step_changed_lanes_only")):
        problems.append(f"fast paths not fully enabled: {fast}")
    if cur.get("sched_wakeups", 0) <= 0:
        problems.append("scale run recorded no scheduler wake-ups")
    if same_scale:
        _ratio_check(problems, "throughput_rps",
                     cur.get("throughput_rps", 0.0),
                     base.get("throughput_rps", 0.0), wall_tol)
        if "speedup_extrapolated" in cur:
            _ratio_check(problems, "speedup_extrapolated",
                         cur["speedup_extrapolated"],
                         base.get("speedup_extrapolated", 0.0), wall_tol,
                         floor=SCALE_SPEEDUP_FLOOR)
        elif "speedup_extrapolated" in base:
            # The committed baseline measured a pre-scale-out reference
            # tree but this run did not: the reference timing failed (or
            # --scale-ref was dropped).  Silently skipping the floor here
            # would let the acceptance bar rot, so surface it.
            problems.append("speedup_extrapolated missing: baseline has a "
                            "reference-tree measurement but the current "
                            "run recorded none (reference timing failed "
                            "or --scale-ref not passed)")
    else:
        if "speedup_same_tier" in cur:
            _ratio_check(problems, "speedup_same_tier",
                         cur["speedup_same_tier"], 0.0, wall_tol,
                         floor=SCALE_SMOKE_SPEEDUP_FLOOR)
        else:
            # No same-machine probe ratio: fall back to the lenient
            # machine-speed sanity fraction against the committed tier.
            _ratio_check(problems, "throughput_rps (cross-scale sanity)",
                         cur.get("throughput_rps", 0.0), 0.0, wall_tol,
                         floor=(SCALE_RPS_SANITY_FRACTION
                                * base.get("throughput_rps", 0.0)))
    return problems


def check_elastic(base: Dict, cur: Dict, tol: float,
                  wall_tol: float) -> List[str]:
    """Elastic preemption storm (BENCH_elastic.json).  Same scale: the
    drain-aware recovery-P95 win on the canonical storm must hold near
    the committed baseline and above the 1.15x acceptance floor, and the
    arrival-seed sweep must stay above the never-worse floor.  Different
    scale (the CI smoke variant): the two-node smoke storm cannot back a
    128-chip pool up, so the gate only asks for parity — the real smoke
    signal is the mechanism canaries: the unaware arm must pay requeues
    (the fault path ran), the aware arm must drain units and stage
    pre-warm chips (the notice path ran), and both arms must end at the
    scheduled chip count (joins landed)."""
    problems: List[str] = []
    key = "recovery_p95_improvement_drain_vs_unaware"
    same_scale = base.get("duration_s") == cur.get("duration_s")
    _ratio_check(problems, key, cur.get(key, 0.0),
                 base.get(key, 0.0) if same_scale else 0.0, tol,
                 floor=(ELASTIC_RECOVERY_FLOOR if same_scale
                        else ELASTIC_SMOKE_FLOOR))
    if same_scale:
        _ratio_check(problems, "recovery_p95_sweep_floor",
                     cur.get("recovery_p95_sweep_floor", 0.0),
                     base.get("recovery_p95_sweep_floor", 0.0), tol,
                     floor=ELASTIC_SWEEP_FLOOR)
    modes = cur.get("modes", {})
    unaware = modes.get("drain_unaware", {})
    aware = modes.get("drain_aware", {})
    if unaware.get("requeued_requests", 0) <= 0:
        problems.append("unaware arm paid no requeues: the storm never "
                        "caught in-flight work (broken fault path or a "
                        "trace too cold to exercise it)")
    if aware.get("drained_units", 0) <= 0:
        problems.append("aware arm drained no units: the preemption "
                        "notice path never ran")
    if aware.get("elastic_prewarm_chips", 0) <= 0:
        problems.append("aware arm staged no pre-warm chips: the join "
                        "announce path never ran")
    for arm, m in modes.items():
        if m.get("nodes_lost", 0) <= 0 or m.get("nodes_joined", 0) <= 0:
            problems.append(f"{arm}: schedule lost/joined no nodes")
    return problems


CHECKERS = {
    "event_driven_simulator_smoke": check_event_sim,
    "shared_cluster_mix_flip": check_shared_cluster,
    "unit_lending_bursty_ec": check_unit_lending,
    "unified_clock_kernel": check_unified_clock,
    "predictive_prewarm_diurnal": check_predictive,
    "cross_lane_batching_burst_storm": check_cross_batch,
    "scale_sim_core": check_scale,
    "elastic_preemption_storm": check_elastic,
}


def check_pair(baseline_path: str, current_path: str, tol: float,
               wall_tol: float) -> List[str]:
    with open(baseline_path) as f:
        base = json.load(f)
    with open(current_path) as f:
        cur = json.load(f)
    kind = base.get("bench")
    if kind != cur.get("bench"):
        return [f"bench kind mismatch: {kind} vs {cur.get('bench')}"]
    checker = CHECKERS.get(kind)
    if checker is None:
        return [f"unknown bench kind: {kind}"]
    return [f"[{kind}] {p}" for p in checker(base, cur, tol, wall_tol)]


def run_checks(pairs, tolerance: float = 0.10,
               wall_tolerance: float = 0.35) -> List[str]:
    problems: List[str] = []
    for baseline, current in pairs:
        problems.extend(check_pair(baseline, current, tolerance,
                                   wall_tolerance))
    return problems


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pair", nargs=2, action="append", required=True,
                    metavar=("BASELINE", "CURRENT"),
                    help="baseline JSON (committed) and current JSON "
                         "(fresh run); repeatable")
    ap.add_argument("--tolerance", type=float, default=0.10,
                    help="relative tolerance for deterministic metrics "
                         "(default 0.10)")
    ap.add_argument("--wall-tolerance", type=float, default=0.35,
                    help="relative tolerance for wall-clock-derived "
                         "metrics like speedups (default 0.35)")
    args = ap.parse_args(argv)
    try:
        problems = run_checks(args.pair, args.tolerance, args.wall_tolerance)
    except (OSError, json.JSONDecodeError) as e:
        print(f"check_regression: cannot read inputs: {e}")
        return 2
    if problems:
        print(f"REGRESSION: {len(problems)} problem(s)")
        for p in problems:
            print(f"  - {p}")
        return 1
    print(f"check_regression: {len(args.pair)} pair(s) OK "
          f"(tolerance {args.tolerance:.0%})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
