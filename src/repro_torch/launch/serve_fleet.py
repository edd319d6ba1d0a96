"""Fleet entry point: one shared cluster serving several pipelines.

Runs the fleet (``core/fleet.py``) on the host, through the event-clock
simulator, in one of five scenarios:

* ``shared``      — sd3 + flux + cogvideox on one pool under a mid-trace
  traffic-mix flip (``workloads.FLEET_RATES`` / ``MIX_FLIP``): the static,
  proportional and adaptive fleet schedulers (``BENCH_shared_cluster.json``);
* ``predictive``  — sd3 + cogvideox under anti-phase diurnal demand
  (``workloads.diurnal_phases``): adaptive against predictive
  re-partitioning (``BENCH_predictive.json``);
* ``cross_batch`` — flux + hunyuanvideo under a long-prompt burst storm
  (``workloads.cross_batch_trace``): the predictive fleet with cross-lane
  batching off and on (``BENCH_cross_batch.json``), beside narrative runs
  of re-partitioning alone and of unit lending;
* ``lending``     — sd3 + cogvideox on 256 chips under sub-window decode
  bursts (``workloads.BURSTY_EC``): the adaptive fleet without and with
  unit lending (``BENCH_unit_lending.json``);
* ``elastic``     — sd3 + hunyuanvideo on a pool hit by preemption storms,
  autoscale joins and a degraded node
  (``workloads.preemption_storm_schedule``): the adaptive fleet acting on
  preemption notices (drain-aware) or not (``BENCH_elastic.json``).

Every stage is priced by the profiler on a named ``Hardware`` set:
``H100_SXM`` (``--hw h100``, the default), fitted to the stage times
``chip_smoke.py`` measures on one H100, or ``REFERENCE_HW``
(``--hw reference``), the JAX reference's constants — with those and a
scenario's own sizes, ``--json`` writes the reference's BENCH file.
``--fast`` turns on the fleet's three host-path switches (``array_state``,
``incremental_ilp``, ``step_changed_lanes_only``; ``launch/scale.py``).  No
tensor is computed, so it needs no card.

  PYTHONPATH=src python -m repro_torch.launch.serve_fleet --scenario shared \\
      --chips 128 --rate-scale 0.25 [--modes static,adaptive] [--smoke|--full] \\
      [--hw reference] [--duration S] [--fast] [--json out.json]

Counterpart of the fleet scenarios of ``benchmarks/e2e.py``
(``run_mixed_shared``, ``run_predictive``, ``run_cross_batch``,
``run_lending``, ``run_elastic``) and of the way it writes their JSON.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import workloads
from repro_torch.core.fleet import (FAST_PATH, FleetConfig, FleetResult,
                                    PipelineRegistry, run_fleet)
from repro_torch.core.profiler import HARDWARE, H100_SXM, Hardware

# -- shared cluster: one 512-chip pool, mid-trace mix flip ---------------------
SHARED_PIPELINES = ("sd3", "flux", "cogvideox")
SHARED_MODES = ("static", "proportional", "adaptive")
SHARED_CHIPS = 512

# -- predictive: 5 anti-phase square-wave periods, windows and forecast
# knobs scaled to the period so the forecaster sees >= 2 full periods before
# the trace's second half
PREDICTIVE_PIPELINES = ("sd3", "cogvideox")
PREDICTIVE_MODES = ("adaptive", "predictive")
PREDICTIVE_PERIODS = 5
PREDICTIVE_DURATION = 1500.0
PREDICTIVE_CFG: Dict = dict(
    num_chips=256, t_win=120.0, cooldown=100.0,
    forecast_bin=10.0, forecast_history=600.0, forecast_horizon=250.0,
    prewarm_lead=50.0, prewarm_cooldown=80.0, prewarm_ttl=240.0,
    forecast_grace=60.0)
# CI-sized variant: same shape, 4 periods of 240 s on 128 chips (the
# forecaster needs 2 full periods of history, so 3 of the 7 flips land in
# the forecastable second half)
PREDICTIVE_SMOKE: Dict = dict(
    duration=960.0, periods=4,
    rates={"sd3": 14.0, "cogvideox": 0.42},
    cfg=dict(num_chips=128, t_win=90.0, cooldown=70.0,
             forecast_bin=5.0, forecast_history=480.0,
             forecast_horizon=200.0, prewarm_lead=40.0,
             prewarm_cooldown=60.0, prewarm_ttl=200.0,
             forecast_grace=50.0))

# -- cross-lane batching on the burst storm: identical arrivals, predictive
# scheduler both arms, ``cross_lane_batching`` off vs on
CROSS_BATCH_PIPELINES = workloads.CROSS_BATCH_PIPELINES
CROSS_BATCH_ARMS = ("off", "batching")
CROSS_BATCH_DURATION = 900.0
CROSS_BATCH_CFG: Dict = dict(num_chips=96, t_win=120.0, cooldown=100.0)
CROSS_BATCH_MAX_BATCH = 8
# CI-sized variant: same burst shape at 2/3 scale (64 chips, 600 s with a
# shortened head so two full burst cycles still land)
CROSS_BATCH_SMOKE: Dict = dict(
    duration=600.0, head=160.0,
    base_rates={"flux": 1.45, "hunyuanvideo": 0.35},
    wave_rates={"flux": 4.6, "hunyuanvideo": 0.2},
    cfg=dict(num_chips=64, t_win=120.0, cooldown=100.0))

# -- unit lending on the bursty-E/C trace: identical arrivals, the adaptive
# scheduler both arms, lending off vs on.  Burst lengths are the point, so
# the trace keeps its 600 s and --full widens across seeds instead
LENDING_PIPELINES = ("sd3", "cogvideox")
LENDING_MODES = ("adaptive", "adaptive+lending")
LENDING_CHIPS = 256
LENDING_DURATION = 600.0

# -- elastic capacity on the preemption-storm script: identical arrivals and
# capacity events both arms; drain-aware acts on every notice (drain, loan
# force-return, join pre-warm), drain-unaware eats the loss's requeues
ELASTIC_PIPELINES = workloads.ELASTIC_PIPELINES
ELASTIC_ARMS = ("drain_aware", "drain_unaware")
ELASTIC_DURATION = 900.0
ELASTIC_CFG: Dict = dict(num_chips=256, t_win=120.0, cooldown=100.0)
# recovery window: requests arriving between a preemption's notice and this
# long after its landing
ELASTIC_RECOVERY_TAIL = 120.0
# CI-sized variant: one storm on 128 chips at half rate
ELASTIC_SMOKE: Dict = dict(
    duration=480.0, n_storms=1,
    rates={"sd3": 4.0, "hunyuanvideo": 0.8},
    cfg=dict(num_chips=128, t_win=90.0, cooldown=70.0))

SCENARIO_PIPELINES = {"shared": SHARED_PIPELINES,
                      "predictive": PREDICTIVE_PIPELINES,
                      "cross_batch": CROSS_BATCH_PIPELINES,
                      "lending": LENDING_PIPELINES,
                      "elastic": ELASTIC_PIPELINES}
SCENARIOS = tuple(SCENARIO_PIPELINES)


@dataclasses.dataclass
class Run:
    """One fleet run of a scenario: ``mode`` is the fleet scheduler (or the
    scenario's arm), ``wall_s`` the host seconds of the simulation alone.
    ``recovery`` is the elastic scenario's (P95 latency, requests) over its
    recovery windows, else None."""
    scenario: str
    mode: str
    seed: int
    result: FleetResult
    wall_s: float
    recovery: Optional[Tuple[float, int]] = None


def _scaled(rates: Dict[str, float], scale: float) -> Dict[str, float]:
    return dict(rates) if scale == 1.0 else {p: v * scale
                                             for p, v in rates.items()}


def _per_pipeline(r: FleetResult) -> Dict:
    return {pid: {k: (round(v, 3) if isinstance(v, float) else v)
                  for k, v in m.items()}
            for pid, m in r.per_pipeline.items()}


def _write(bench: Dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(bench, f, indent=2)
        f.write("\n")


def _timed(scenario: str, tag: str, seed: int, **fleet_kw) -> Run:
    """One ``run_fleet`` call, timed; ``tag`` names the run's mode or arm."""
    t0 = time.perf_counter()
    res = run_fleet(**fleet_kw)
    return Run(scenario, tag, seed, res, time.perf_counter() - t0)


# ---------------------------------------------------------------- shared

def run_shared(hw: Hardware = H100_SXM, chips: int = SHARED_CHIPS,
               duration: float = 600.0, rate_scale: float = 1.0,
               modes: Sequence[str] = SHARED_MODES,
               fleet_cfg_kw: Optional[Dict] = None,
               bench_path: Optional[str] = None) -> List[Run]:
    """Shared cluster, sd3 + flux + cogvideox, mid-trace mix flip.

    One heterogeneous trace per mode (same seed -> identical arrivals).  The
    static baseline partitions the pool from the first-window traffic and
    never moves; when the mix flips, its flux/cogvideox slices drown while
    sd3 chips idle — the adaptive fleet re-partitions."""
    registry = PipelineRegistry(SHARED_PIPELINES, hw=hw)
    profs = {pid: registry.profiler(pid) for pid in SHARED_PIPELINES}
    rates = _scaled(workloads.FLEET_RATES, rate_scale)
    runs = []
    for mode in modes:
        cfg = FleetConfig(num_chips=chips, **(fleet_cfg_kw or {}))
        # a fresh trace per mode (requests are mutated by the simulation),
        # built outside the timer so wall_s measures the fleet alone
        trace = workloads.fleet_trace(SHARED_PIPELINES, duration, profs,
                                      seed=0, rates=rates,
                                      phases=workloads.MIX_FLIP)
        runs.append(_timed("shared", mode, 0, pipelines=SHARED_PIPELINES,
                           mode=mode, duration=duration, cfg=cfg,
                           registry=registry, trace=trace))
    results = {r.mode: r.result for r in runs}
    if bench_path and "static" in results and "adaptive" in results:
        st, ad = results["static"], results["adaptive"]
        p95_x = st.p95_latency / max(ad.p95_latency, 1e-9)
        goodput_x = ad.goodput / max(st.goodput, 1e-9)
        worst_x = (max(m["p95_s"] for m in st.per_pipeline.values())  # detlint: ignore[DET004] numeric extremum over values: order-free
                   / max(1e-9, max(m["p95_s"]  # detlint: ignore[DET004] numeric extremum over values: order-free
                                   for m in ad.per_pipeline.values())))
        _write({
            "bench": "shared_cluster_mix_flip",
            "num_chips": chips,
            "pipelines": list(SHARED_PIPELINES),
            "duration_s": duration,
            "rates_rps": rates,
            "phases": [[f, dict(m)] for f, m in workloads.MIX_FLIP],
            "p95_improvement_adaptive_vs_static": round(p95_x, 2),
            "goodput_improvement_adaptive_vs_static": round(goodput_x, 3),
            "worst_pipeline_p95_improvement": round(worst_x, 2),
            "modes": {
                mode: {
                    "p95_s": round(r.p95_latency, 3),
                    "mean_s": round(r.mean_latency, 3),
                    "slo_pct": round(r.slo_attainment * 100, 2),
                    "goodput_rps": round(r.goodput, 3),
                    "finished": r.n_finished,
                    "requests": r.n_requests,
                    "repartitions": len(r.repartitions) - 1,
                    "swap_cost_s": round(r.swap_cost_s, 2),
                    "units_reloaded": r.units_reloaded,
                    "per_pipeline": _per_pipeline(r),
                } for mode, r in results.items()},
        }, bench_path)
    return runs


# ---------------------------------------------------------------- predictive

def run_predictive(hw: Hardware = H100_SXM,
                   duration: float = PREDICTIVE_DURATION,
                   periods: int = PREDICTIVE_PERIODS,
                   rates: Optional[Dict[str, float]] = None,
                   rate_scale: float = 1.0,
                   fleet_cfg_kw: Optional[Dict] = None,
                   seeds: Sequence[int] = (0,),
                   modes: Sequence[str] = PREDICTIVE_MODES,
                   bench_path: Optional[str] = None) -> List[Run]:
    """Predictive re-partitioning on the diurnal mix-flip trace.

    Anti-phase square-wave demand between sd3 and cogvideox: every half
    period the mix flips hard, and the adaptive scheduler detects each flip
    a demand-window late.  The predictive scheduler (core/forecast.py) fits
    the period from rate history, pre-warms the target partition's weights
    before the shift lands, and fires the swap as soon as the freshest
    observed rates confirm the predicted mix."""
    rates = _scaled(rates or workloads.PREDICTIVE_RATES, rate_scale)
    cfg_kw = dict(PREDICTIVE_CFG)
    cfg_kw.update(fleet_cfg_kw or {})
    phases = workloads.diurnal_phases(n_periods=periods)
    registry = PipelineRegistry(PREDICTIVE_PIPELINES, hw=hw)
    profs = {pid: registry.profiler(pid) for pid in PREDICTIVE_PIPELINES}
    runs = []
    for seed in seeds:
        for mode in modes:
            trace = workloads.fleet_trace(PREDICTIVE_PIPELINES, duration,
                                          profs, seed=seed, rates=rates,
                                          phases=phases)
            runs.append(_timed("predictive", mode, seed,
                               pipelines=PREDICTIVE_PIPELINES, mode=mode,
                               duration=duration, cfg=FleetConfig(**cfg_kw),
                               registry=registry, trace=trace))
    if bench_path and set(PREDICTIVE_MODES) <= set(modes):
        _write_predictive(runs, seeds, cfg_kw, duration, periods, rates,
                          bench_path)
    return runs


def _write_predictive(runs: List[Run], seeds: Sequence[int], cfg_kw: Dict,
                      duration: float, periods: int, rates: Dict[str, float],
                      path: str) -> None:
    by = {(r.seed, r.mode): r.result for r in runs}
    worst_by_seed = {}
    for seed in seeds:
        ad, pr = by[(seed, "adaptive")], by[(seed, "predictive")]
        worst_by_seed[seed] = (
            max(m["p95_s"] for m in ad.per_pipeline.values())  # detlint: ignore[DET004] numeric extremum over values: order-free
            / max(1e-9, max(m["p95_s"]  # detlint: ignore[DET004] numeric extremum over values: order-free
                            for m in pr.per_pipeline.values())))
    results = {mode: by[(seeds[0], mode)] for mode in PREDICTIVE_MODES}
    ad, pr = results["adaptive"], results["predictive"]
    worst_x = min(worst_by_seed.values())  # detlint: ignore[DET004] numeric extremum over values: order-free
    p95_x = ad.p95_latency / max(pr.p95_latency, 1e-9)
    _write({
        "bench": "predictive_prewarm_diurnal",
        "num_chips": cfg_kw["num_chips"],
        "pipelines": list(PREDICTIVE_PIPELINES),
        "duration_s": duration,
        "periods": periods,
        "rates_rps": dict(rates),
        "worst_pipeline_p95_improvement_predictive_vs_adaptive":
            round(worst_x, 3),
        "worst_pipeline_p95_improvement_per_seed":
            {s: round(v, 3) for s, v in worst_by_seed.items()},
        "p95_improvement_predictive_vs_adaptive": round(p95_x, 3),
        "slo_improvement_pts": round((pr.slo_attainment
                                      - ad.slo_attainment) * 100, 2),
        "predictive_repartitions": pr.predictive_repartitions,
        "prewarm_units": pr.prewarm_units,
        "prewarm_hits": pr.prewarm_hits,
        "prewarm_cost_s": round(pr.prewarm_cost_s, 3),
        "prewarm_loan_returns": pr.prewarm_loan_returns,
        "modes": {
            mode: {
                "p95_s": round(r.p95_latency, 3),
                "mean_s": round(r.mean_latency, 3),
                "slo_pct": round(r.slo_attainment * 100, 2),
                "goodput_rps": round(r.goodput, 3),
                "repartitions": len(r.repartitions) - 1,
                "predictive_repartitions": r.predictive_repartitions,
                "prewarm_units": r.prewarm_units,
                "swap_cost_s": round(r.swap_cost_s, 3),
                "per_pipeline": _per_pipeline(r),
            } for mode, r in results.items()},
    }, path)


# ---------------------------------------------------------------- cross-batch

def run_cross_batch(hw: Hardware = H100_SXM,
                    duration: float = CROSS_BATCH_DURATION,
                    base_rates: Optional[Dict[str, float]] = None,
                    wave_rates: Optional[Dict[str, float]] = None,
                    head: float = 240.0, rate_scale: float = 1.0,
                    fleet_cfg_kw: Optional[Dict] = None,
                    seeds: Sequence[int] = (0,),
                    modes: Sequence[str] = CROSS_BATCH_ARMS,
                    narrative_arms: Sequence[str] = (),
                    bench_path: Optional[str] = None) -> List[Run]:
    """Cross-lane dynamic batching on the long-prompt burst-storm trace.

    Correlated waves of cond-4096 prompt-expansion requests overload each
    lane's single auxiliary encode unit.  With ``cross_lane_batching`` on,
    the fleet dispatcher fuses flux and hunyuanvideo encodes that share a
    placement shape into one batched launch on the freer aux unit.

    ``narrative_arms`` adds seed-0 reference runs of the alternatives:
    ``"adaptive"`` (re-partitioning alone) and ``"lending"`` (the
    predictive fleet with unit lending instead of batching)."""
    cfg_kw = dict(CROSS_BATCH_CFG)
    cfg_kw.update(fleet_cfg_kw or {})
    base_rates = _scaled(base_rates or workloads.CROSS_BATCH_BASE_RATES,
                         rate_scale)
    wave_rates = _scaled(wave_rates or workloads.CROSS_BATCH_WAVE_RATES,
                         rate_scale)
    registry = PipelineRegistry(CROSS_BATCH_PIPELINES, hw=hw)
    profs = {pid: registry.profiler(pid) for pid in CROSS_BATCH_PIPELINES}
    arm_cfg = {"off": {}, "batching": dict(
        cross_lane_batching=True, cross_lane_max_batch=CROSS_BATCH_MAX_BATCH)}

    def one(tag, mode, seed, **extra_cfg):
        trace = workloads.cross_batch_trace(duration, profs, seed=seed,
                                            base_rates=base_rates,
                                            wave_rates=wave_rates, head=head)
        return _timed("cross_batch", tag, seed,
                      pipelines=CROSS_BATCH_PIPELINES, mode=mode,
                      duration=duration,
                      cfg=FleetConfig(**{**cfg_kw, **extra_cfg}),
                      registry=registry, trace=trace)

    runs = [one(arm, "predictive", seed, **arm_cfg[arm])
            for seed in seeds for arm in modes]
    narrative = {}
    if "adaptive" in narrative_arms:
        ad = one("narrative-adaptive", "adaptive", seeds[0])
        runs.append(ad)
        narrative.update({
            "adaptive_p95_s": round(ad.result.p95_latency, 3),
            "adaptive_repartitions": len(ad.result.repartitions) - 1,
        })
    if "lending" in narrative_arms:
        ln = one("narrative-lending", "predictive", seeds[0], lending=True)
        runs.append(ln)
        narrative.update({
            "lending_p95_s": round(ln.result.p95_latency, 3),
            "lending_loans": ln.result.loans,
        })
    if bench_path and set(CROSS_BATCH_ARMS) <= set(modes):
        by = {(r.seed, r.mode): r.result for r in runs}
        ratio_by_seed = {s: by[(s, "off")].p95_latency
                         / max(by[(s, "batching")].p95_latency, 1e-9)
                         for s in seeds}
        results = {arm: by[(seeds[0], arm)] for arm in CROSS_BATCH_ARMS}
        off, on = results["off"], results["batching"]
        worst_x = min(ratio_by_seed.values())  # detlint: ignore[DET004] numeric extremum over values: order-free
        _write({
            "bench": "cross_lane_batching_burst_storm",
            "num_chips": cfg_kw["num_chips"],
            "pipelines": list(CROSS_BATCH_PIPELINES),
            "duration_s": duration,
            "base_rates_rps": dict(base_rates),
            "wave_rates_rps": dict(wave_rates),
            "cond_len": dict(workloads.CROSS_BATCH_COND),
            "cross_lane_max_batch": CROSS_BATCH_MAX_BATCH,
            "p95_improvement_batching_vs_off": round(worst_x, 3),
            "p95_improvement_per_seed":
                {s: round(v, 3) for s, v in ratio_by_seed.items()},
            "slo_improvement_pts": round((on.slo_attainment
                                          - off.slo_attainment) * 100, 2),
            "cross_lane_merges": on.cross_lane_merges,
            "narrative": narrative,
            "modes": {
                arm: {
                    "p95_s": round(r.p95_latency, 3),
                    "mean_s": round(r.mean_latency, 3),
                    "slo_pct": round(r.slo_attainment * 100, 2),
                    "goodput_rps": round(r.goodput, 3),
                    "cross_lane_merges": r.cross_lane_merges,
                    "repartitions": len(r.repartitions) - 1,
                    "per_pipeline": _per_pipeline(r),
                } for arm, r in results.items()},
        }, bench_path)
    return runs


# ---------------------------------------------------------------- lending

def run_lending(hw: Hardware = H100_SXM, duration: float = LENDING_DURATION,
                rate_scale: float = 1.0, fleet_cfg_kw: Optional[Dict] = None,
                seeds: Sequence[int] = (0,),
                modes: Sequence[str] = LENDING_MODES,
                bench_path: Optional[str] = None) -> List[Run]:
    """Cross-pipeline unit lending on the bursty-E/C trace.

    A calm sizing window, then sub-window decode bursts of cogvideox while
    sd3 sits in its lull: too short for the adaptive re-partitioner's
    hysteresis and cooldown to chase, so without lending the burst pipeline
    drowns while sd3 units idle.  Borrowed units host E/C only; the
    headline is the worst-pipeline P95 ratio."""
    rates = _scaled(workloads.LENDING_RATES, rate_scale)
    cfg_kw: Dict = dict(num_chips=LENDING_CHIPS)
    cfg_kw.update(fleet_cfg_kw or {})
    phases = workloads.bursty_ec_phases(duration)
    registry = PipelineRegistry(LENDING_PIPELINES, hw=hw)
    profs = {pid: registry.profiler(pid) for pid in LENDING_PIPELINES}
    runs = []
    for seed in seeds:
        for mode in modes:
            trace = workloads.fleet_trace(LENDING_PIPELINES, duration, profs,
                                          seed=seed, rates=rates,
                                          phases=phases)
            cfg = FleetConfig(**cfg_kw, lending=mode == "adaptive+lending")
            runs.append(_timed("lending", mode, seed,
                               pipelines=LENDING_PIPELINES, mode="adaptive",
                               duration=duration, cfg=cfg,
                               registry=registry, trace=trace))
    if bench_path and set(LENDING_MODES) <= set(modes):
        by = {(r.seed, r.mode): r.result for r in runs}
        worst_by_seed = {}
        for seed in seeds:
            ad, lend = by[(seed, "adaptive")], by[(seed, "adaptive+lending")]
            worst_by_seed[seed] = (
                max(m["p95_s"] for m in ad.per_pipeline.values())  # detlint: ignore[DET004] numeric extremum over values: order-free
                / max(1e-9, max(m["p95_s"]  # detlint: ignore[DET004] numeric extremum over values: order-free
                                for m in lend.per_pipeline.values())))
        results = {mode: by[(seeds[0], mode)] for mode in LENDING_MODES}
        ad, lend = results["adaptive"], results["adaptive+lending"]
        worst_x = min(worst_by_seed.values())  # detlint: ignore[DET004] numeric extremum over values: order-free
        p95_x = ad.p95_latency / max(lend.p95_latency, 1e-9)
        _write({
            "bench": "unit_lending_bursty_ec",
            "num_chips": cfg_kw["num_chips"],
            "pipelines": list(LENDING_PIPELINES),
            "duration_s": duration,
            "rates_rps": rates,
            "phases": [[f, dict(m)] for f, m in phases],
            "worst_pipeline_p95_improvement_lending_vs_adaptive":
                round(worst_x, 3),
            "worst_pipeline_p95_improvement_per_seed":
                {s: round(v, 3) for s, v in worst_by_seed.items()},
            "p95_improvement_lending_vs_adaptive": round(p95_x, 3),
            "slo_improvement_pts": round((lend.slo_attainment
                                          - ad.slo_attainment) * 100, 2),
            "loans": lend.loans,
            "borrowed_unit_seconds": round(lend.borrowed_unit_seconds, 1),
            "lend_swap_cost_s": round(lend.lend_swap_cost_s, 2),
            "borrowed_stage_runs": lend.borrowed_stage_runs,
            "diffuse_runs_on_borrowed_units":
                lend.borrowed_stage_runs.get("D", 0),
            "modes": {
                mode: {
                    "p95_s": round(r.p95_latency, 3),
                    "mean_s": round(r.mean_latency, 3),
                    "slo_pct": round(r.slo_attainment * 100, 2),
                    "goodput_rps": round(r.goodput, 3),
                    "repartitions": len(r.repartitions) - 1,
                    "per_pipeline": _per_pipeline(r),
                } for mode, r in results.items()},
        }, bench_path)
    return runs


def lending_stage_worth(hw: Hardware = H100_SXM, level: str = "medium"
                        ) -> Dict[str, Dict[str, float]]:
    """What the lending broker's gate reads for each pipeline of the lending
    scenario: the per-request time of a hosted stage (E, C) at its optimal
    degree (``LendingBroker._stage_worth`` over a queue of one request),
    the largest over the pipeline's classes at ``level``.  The broker
    borrows for a pipeline only when this reaches
    ``FleetConfig.lend_min_stage_s``."""
    from types import SimpleNamespace
    from repro_torch.core.lending import LendingBroker
    from repro_torch.core.request import Request
    registry = PipelineRegistry(LENDING_PIPELINES, hw=hw)
    broker = LendingBroker(FleetConfig(lending=True), registry)
    out: Dict[str, Dict[str, float]] = {}
    for pid in LENDING_PIPELINES:
        prof = registry.profiler(pid)
        out[pid] = {stage: max(
            broker._stage_worth(
                SimpleNamespace(prof=prof, pending=[Request(pid, res, float(sec))]),
                stage)
            for (res, sec), _ in workloads.MIXES[pid][level])
            for stage in ("E", "C")}
    return out


# ---------------------------------------------------------------- elastic

def recovery_windows(schedule, tail: float = ELASTIC_RECOVERY_TAIL
                     ) -> List[Tuple[float, float]]:
    """[notice, land + tail] span of every preemption in the schedule."""
    return [(ev.t - ev.lead, ev.t + tail)
            for ev in schedule if ev.kind == "preempt"]


def recovery_p95(trace, windows, horizon_lat: float) -> Tuple[float, int]:
    """P95 latency (censored at the horizon, like ``FleetResult``) over the
    requests that arrive inside any recovery window, and their count."""
    lat: List[float] = []
    for r in trace:
        if not any(lo <= r.arrival <= hi for lo, hi in windows):
            continue
        f = r.stage_done.get("C")
        lat.append((f - r.arrival) if f is not None
                   else (horizon_lat - r.arrival))
    lat.sort()
    n = len(lat)
    return (lat[int(0.95 * (n - 1))] if n else 0.0), n


def run_elastic(hw: Hardware = H100_SXM, duration: float = ELASTIC_DURATION,
                rates: Optional[Dict[str, float]] = None,
                rate_scale: float = 1.0, n_storms: int = 2,
                fleet_cfg_kw: Optional[Dict] = None,
                seeds: Sequence[int] = (0,),
                modes: Sequence[str] = ELASTIC_ARMS,
                bench_path: Optional[str] = None) -> List[Run]:
    """Elastic capacity and fault injection on the preemption-storm script.

    Both arms play the same capacity schedule on identical arrivals: a
    degraded node (detected and quarantined), announced preemption storms,
    autoscale joins.  The drain-aware arm acts on each notice; the
    drain-unaware arm ignores it and requeues everything in flight on the
    lost nodes.  The storm script is fixed (seed 0) and the seeds vary only
    the arrivals; the headline is the recovery-window P95 ratio
    unaware / aware on ``seeds[0]``."""
    rates = _scaled(rates or workloads.ELASTIC_RATES, rate_scale)
    cfg_kw = dict(ELASTIC_CFG)
    cfg_kw.update(fleet_cfg_kw or {})
    chips = cfg_kw["num_chips"]
    registry = PipelineRegistry(ELASTIC_PIPELINES, hw=hw)
    profs = {pid: registry.profiler(pid) for pid in ELASTIC_PIPELINES}
    schedule = workloads.preemption_storm_schedule(duration, chips, seed=0,
                                                   n_storms=n_storms)
    windows = recovery_windows(schedule)
    runs = []
    for seed in seeds:
        for arm in modes:
            act = arm == "drain_aware"
            cfg = FleetConfig(**cfg_kw, elastic=True,
                              elastic_schedule=schedule,
                              elastic_drain=act, elastic_prewarm=act)
            trace = workloads.fleet_trace(ELASTIC_PIPELINES, duration, profs,
                                          seed=seed, rates=rates,
                                          level=workloads.ELASTIC_LEVEL)
            run = _timed("elastic", arm, seed, pipelines=ELASTIC_PIPELINES,
                         mode="adaptive", duration=duration, cfg=cfg,
                         registry=registry, trace=trace)
            trace_end = trace[-1].arrival if trace else 0.0
            run.recovery = recovery_p95(trace, windows,
                                        trace_end + cfg.horizon_slack)
            runs.append(run)
    if bench_path and set(ELASTIC_ARMS) <= set(modes):
        by = {(r.seed, r.mode): r for r in runs}
        ratio_by_seed = {s: by[(s, "drain_unaware")].recovery[0]
                         / max(by[(s, "drain_aware")].recovery[0], 1e-9)
                         for s in seeds}
        first = {arm: by[(seeds[0], arm)] for arm in ELASTIC_ARMS}
        aware = first["drain_aware"].result
        unaware = first["drain_unaware"].result
        sweep_floor = min(ratio_by_seed.values())  # detlint: ignore[DET004] numeric extremum over values: order-free
        _write({
            "bench": "elastic_preemption_storm",
            "num_chips": chips,
            "pipelines": list(ELASTIC_PIPELINES),
            "duration_s": duration,
            "rates_rps": dict(rates),
            "n_storms": n_storms,
            "recovery_tail_s": ELASTIC_RECOVERY_TAIL,
            "recovery_p95_improvement_drain_vs_unaware":
                round(ratio_by_seed[seeds[0]], 3),
            "recovery_p95_improvement_per_seed":
                {s: round(v, 3) for s, v in ratio_by_seed.items()},
            "recovery_p95_sweep_floor": round(sweep_floor, 3),
            "slo_improvement_pts": round((aware.slo_attainment
                                          - unaware.slo_attainment) * 100, 2),
            "modes": {
                arm: {
                    "recovery_p95_s": round(run.recovery[0], 3),
                    "recovery_requests": run.recovery[1],
                    "p95_s": round(r.p95_latency, 3),
                    "mean_s": round(r.mean_latency, 3),
                    "slo_pct": round(r.slo_attainment * 100, 2),
                    "goodput_rps": round(r.goodput, 3),
                    "capacity_events": r.capacity_events,
                    "nodes_joined": r.nodes_joined,
                    "nodes_lost": r.nodes_lost,
                    "requeued_requests": r.requeued_requests,
                    "drained_units": r.drained_units,
                    "quarantined_units": r.quarantined_units,
                    "elastic_prewarm_chips": r.elastic_prewarm_chips,
                    "final_chips": r.final_chips,
                    "repartitions": len(r.repartitions) - 1,
                    "per_pipeline": _per_pipeline(r),
                } for arm, run in first.items() for r in (run.result,)},
        }, bench_path)
    return runs


# ---------------------------------------------------------------- CLI

def scenario_runs(args) -> List[Run]:
    """The runs ``main``'s arguments ask for: the scenario at its own sizes
    (``--smoke``: its CI-sized variant, where it has one — lending's 600 s
    trace is already its smallest; ``--full``: three seeds, and the shared
    scenario's hour-long trace), overridden by ``--chips``, ``--duration``
    and ``--rate-scale``."""
    hw = HARDWARE[args.hw]
    seeds = (0, 1, 2) if args.full else (0,)
    kw: Dict = dict(hw=hw, rate_scale=args.rate_scale, bench_path=args.json)
    cfg_kw: Dict = {}
    if args.scenario == "shared":
        duration = 3600.0 if args.full else 600.0
        modes: Tuple[str, ...] = SHARED_MODES
        if args.smoke:
            duration, modes = 240.0, ("static", "adaptive")
            cfg_kw = {"t_win": 90.0, "cooldown": 60.0}
        fn = run_shared
        kw.update(chips=args.chips or SHARED_CHIPS)
    elif args.scenario == "predictive":
        duration, modes = PREDICTIVE_DURATION, PREDICTIVE_MODES
        if args.smoke:
            sm = PREDICTIVE_SMOKE
            duration, cfg_kw = sm["duration"], dict(sm["cfg"])
            kw.update(periods=sm["periods"], rates=sm["rates"])
        fn = run_predictive
        kw.update(seeds=seeds)
    elif args.scenario == "lending":
        duration, modes = LENDING_DURATION, LENDING_MODES
        fn = run_lending
        kw.update(seeds=seeds)
    elif args.scenario == "elastic":
        duration, modes = ELASTIC_DURATION, ELASTIC_ARMS
        if args.smoke:
            sm = ELASTIC_SMOKE
            duration, cfg_kw = sm["duration"], dict(sm["cfg"])
            kw.update(rates=sm["rates"], n_storms=sm["n_storms"])
        fn = run_elastic
        kw.update(seeds=seeds)
    else:
        duration, modes = CROSS_BATCH_DURATION, CROSS_BATCH_ARMS
        kw.update(narrative_arms=("adaptive", "lending"))
        if args.smoke:
            sm = CROSS_BATCH_SMOKE
            duration, cfg_kw = sm["duration"], dict(sm["cfg"])
            kw.update(head=sm["head"], base_rates=sm["base_rates"],
                      wave_rates=sm["wave_rates"], narrative_arms=())
        fn = run_cross_batch
        kw.update(seeds=seeds)
    if args.chips and args.scenario != "shared":
        cfg_kw["num_chips"] = args.chips
    if args.fast:
        cfg_kw.update(FAST_PATH)
    if args.modes:
        modes = tuple(m for m in args.modes.split(",") if m)
    return fn(duration=args.duration or duration, modes=modes,
              fleet_cfg_kw=cfg_kw, **kw)


def main(argv: Optional[Sequence[str]] = None) -> List[Run]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", choices=SCENARIOS, default="shared")
    ap.add_argument("--hw", choices=sorted(HARDWARE), default="h100",
                    help="the profiler's constant set: H100_SXM or the JAX "
                         "reference's")
    ap.add_argument("--chips", type=int, default=None,
                    help="pool size (default: the scenario's own)")
    ap.add_argument("--duration", type=float, default=None,
                    help="trace seconds (default: the scenario's own)")
    ap.add_argument("--rate-scale", type=float, default=1.0,
                    help="multiply every arrival rate (keep the load per "
                         "chip with chips / the scenario's own chips)")
    ap.add_argument("--modes", default=None,
                    help="comma list of fleet schedulers or arms (cross_batch: "
                         "off,batching; lending: adaptive,adaptive+lending; "
                         "elastic: drain_aware,drain_unaware); default: the "
                         "scenario's own")
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--smoke", action="store_true",
                      help="the scenario's CI-sized variant")
    size.add_argument("--full", action="store_true",
                      help="seeds 0-2; the shared scenario's 3600 s trace")
    ap.add_argument("--fast", action="store_true",
                    help="the fleet's host-path switches (array_state, "
                         "incremental_ilp, step_changed_lanes_only)")
    ap.add_argument("--json", default=None,
                    help="write the scenario's BENCH-layout JSON here")
    args = ap.parse_args(argv)
    runs = scenario_runs(args)
    for r in runs:
        seed = f" s{r.seed}" if r.seed else ""
        rec = (f"  recovery p95={r.recovery[0]:.2f}s" if r.recovery is not None
               else "")
        print(f"{r.scenario}/{r.mode}{seed}: {r.result.summary()}{rec}  "
              f"({r.wall_s:.2f} s of host time)")
    return runs


if __name__ == "__main__":
    main()
