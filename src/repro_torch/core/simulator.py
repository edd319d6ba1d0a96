"""Discrete-event cluster simulator driving the real planner + engine code.

The simulator owns the arrival trace; *all* scheduling logic (Orchestrator,
Dispatcher, Monitor, Adjust-on-Dispatch, the baselines) is the production
code of this package — only stage execution latencies come from the
Profiler's cost model, on a named ``Hardware`` set, instead of runs on the
GPUs.  This is the path that gives SLO attainment and mean/P95 latency.

The clock lives in ``core/clock.py``: ``Simulator`` is a one-lane
``ClockDriver`` over ``EventClock``.  Two clock modes share one per-step
body (admit arrivals -> drain completion events -> maybe re-place ->
dispatch):

* ``tick`` — the fixed-step loop: the scheduler runs every
  ``SimConfig.tick`` seconds across the whole horizon, O(horizon/tick).
* ``event`` (default) — the scheduler only wakes when state can change —
  the next arrival, the next stage completion (which is also when units
  cross their ``free_at``), the next Monitor-window boundary, or a
  ``max_idle_gap`` cap that preserves periodic re-placement/aging checks
  while requests are pending.  Wake-ups are quantized *up* to the same tick
  grid, so on traces where the skipped ticks are no-ops the two modes
  produce bit-identical results at O(events) cost.

The shared-cluster ``FleetSimulator`` (core/fleet.py) drives the same kernel
with one Lane per pipeline.

Counterpart of ``repro/core/simulator.py``: cross-node SP and the
array-backed lane state are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import repro_torch.configs as configs
from repro_torch.core import workloads
from repro_torch.core.clock import (ClockConfig, EventClock, Lane, Scheduler,
                                    monitor_boundary_source, replace_capable)
from repro_torch.core.profiler import H100_SXM, Hardware, Profiler
from repro_torch.core.request import Request
from repro_torch.core.runtime import RuntimeEngine

__all__ = ["SimConfig", "SimResult", "Simulator", "run_sim"]


@dataclasses.dataclass
class SimConfig:
    num_chips: int = 128
    tick: float = 0.25
    horizon_slack: float = 600.0      # grace period after the last arrival
    proactive_push: bool = True
    adjust_on_dispatch: bool = True
    downtime_adjust: bool = False     # Fig. 13 ablation
    mode: str = "event"               # "event" (O(events)) | "tick"
    max_idle_gap: float = 1.0         # event mode: max clock jump while
                                      # requests are pending (keeps periodic
                                      # re-placement/aging checks alive)
    adaptive_idle_gap: bool = False   # profile-guided heartbeat: double the
                                      # gap while no pending request crosses
                                      # its deadline (no aging flips), reset
                                      # to max_idle_gap when one does
    idle_gap_max: float = 16.0        # ceiling for the adaptive gap (s)
    idle_window_wakeups: bool = False # event mode: keep Monitor-window
                                      # boundary wake-ups scheduled even
                                      # while nothing is pending/in-flight,
                                      # so a pattern change during an idle
                                      # gap is seen before the window drains
                                      # below MIN_SAMPLES (stale-window fix)
    scheduler_wake_hooks: bool = False # event mode: register the scheduler's
                                      # ``next_wake`` trigger-crossing hook
                                      # as a wake source.  Opt-in: extra
                                      # wake-ups (even no-op ones) shift
                                      # heartbeat phase

    def clock_cfg(self, horizon: float) -> ClockConfig:
        return ClockConfig(tick=self.tick, horizon=horizon, mode=self.mode,
                           max_idle_gap=self.max_idle_gap,
                           adaptive_idle_gap=self.adaptive_idle_gap,
                           idle_gap_max=self.idle_gap_max)


@dataclasses.dataclass
class SimResult:
    scheduler: str
    pipeline: str
    workload: str
    oom: bool
    n_requests: int
    n_finished: int
    n_request_oom: int
    slo_attainment: float
    mean_latency: float
    p95_latency: float
    throughput_timeline: List[Tuple[float, int]]
    placement_switches: List[Tuple[float, Dict[str, int]]]
    vr_histogram: Dict[int, int]
    engine_stats: Dict[str, float]
    solver_ms: float = 0.0
    sched_wakeups: int = 0            # scheduler invocations (event vs tick)

    def summary(self) -> str:
        if self.oom:
            return (f"{self.scheduler:10s} {self.pipeline:12s} {self.workload:11s} "
                    f"OOM (colocated placement exceeds HBM)")
        return (f"{self.scheduler:10s} {self.pipeline:12s} {self.workload:11s} "
                f"SLO={self.slo_attainment * 100:5.1f}%  "
                f"mean={self.mean_latency:7.2f}s  p95={self.p95_latency:7.2f}s  "
                f"fin={self.n_finished}/{self.n_requests}")


class Simulator(Lane):
    """One-lane simulator over the event-clock kernel.

    ``Simulator`` *is* its own Lane (the scheduler sees ``sim.pending`` /
    ``sim.engine`` / ``sim.monitor``) and implements the ``ClockDriver``
    protocol; all loop mechanics — the completion heap, tick-grid
    quantization, heartbeat and adaptive idle gap — live in
    ``core/clock.EventClock``.
    """

    def __init__(self, pipeline_id: str, scheduler: Scheduler,
                 trace: Sequence[Request], sim_cfg: SimConfig):
        super().__init__(pipeline_id, scheduler.prof, scheduler)
        self.trace = sorted(trace, key=lambda r: r.arrival)
        self.cfg = sim_cfg
        self.clock = EventClock(sim_cfg.clock_cfg(self._horizon()))
        self._ai = 0                   # arrival cursor into the trace
        self._track_flips = (sim_cfg.mode == "event"
                             and sim_cfg.adaptive_idle_gap)
        self.clock.add_source(self._next_arrival)
        # monitor-window wake-ups only matter to schedulers that re-place
        if replace_capable(scheduler):
            self.clock.add_source(monitor_boundary_source(
                self.monitor,
                lambda: bool(self.pending or self.clock.completions
                             or self.cfg.idle_window_wakeups)))
        if sim_cfg.scheduler_wake_hooks:
            self.clock.add_source(lambda tau: scheduler.next_wake(self, tau))

    # ---------------------------------------------------------------- helpers

    def _horizon(self) -> float:
        trace_end = self.trace[-1].arrival if self.trace else 0.0
        return trace_end + self.cfg.horizon_slack

    def _next_arrival(self, tau: float) -> Optional[float]:
        if self._ai < len(self.trace):
            return self.trace[self._ai].arrival
        return None

    # ---------------------------------------------------------------- clock protocol

    def advance(self, tau: float) -> None:
        """Admit arrivals, drain completions, run one scheduler step."""
        self.new_arrivals = []
        trace = self.trace
        n = len(trace)
        ai = self._ai
        clock = self.clock if self._track_flips else None
        while ai < n and trace[ai].arrival <= tau:
            self.admit(trace[ai], clock)
            ai += 1
        self._ai = ai
        for t, _, _, s, ptype, dur, _, _ in self.clock.pop_due(tau):
            self.on_completion(t, s, ptype, dur)
        self.step(tau, self.clock, self._apply_replacement)

    def _apply_replacement(self, new_plan, tau: float) -> None:
        self.engine.apply_placement(new_plan, tau,
                                    downtime_adjust=self.cfg.downtime_adjust)

    def done(self) -> bool:
        return (self._ai >= len(self.trace) and not self.pending
                and not self.clock.completions)

    def heartbeat_pending(self) -> bool:
        return bool(self.pending)

    def still_pending(self, lane: str, rid: int) -> bool:
        return self.pending.has_rid(rid)

    # ---------------------------------------------------------------- main

    def run(self) -> SimResult:
        # single-run objects: the arrival cursor, wake sources, and the
        # trace's Request objects all carry state a second run would
        # silently corrupt — fail loudly instead
        assert self.clock.wakeups == 0, "Simulator instances are single-run"
        plan = self.sched.initial_placement()
        if plan is None:   # no feasible placement (e.g. colocated OOM)
            return self._oom_result()
        self.engine = RuntimeEngine(
            self.prof, plan, proactive_push=self.cfg.proactive_push,
            adjust_on_dispatch=self.cfg.adjust_on_dispatch)
        self.placement_log.append((0.0, plan.type_histogram()))
        self.clock.run(self)
        return self._result()

    # ---------------------------------------------------------------- results

    def _oom_result(self) -> SimResult:
        return SimResult(
            scheduler=self.sched.name, pipeline=self.pipeline,
            workload="", oom=True, n_requests=len(self.trace), n_finished=0,
            n_request_oom=len(self.trace), slo_attainment=0.0,
            mean_latency=float("inf"), p95_latency=float("inf"),
            throughput_timeline=[], placement_switches=[], vr_histogram={},
            engine_stats={})

    def _result(self) -> SimResult:
        lat = []
        on_time = 0
        finished = 0
        oom_ids = {r.rid for r in self.request_oom}
        horizon_lat = (self.trace[-1].arrival + self.cfg.horizon_slack
                       if self.trace else 0.0)
        for r in self.trace:
            if r.rid in oom_ids:
                lat.append(horizon_lat)
                continue
            if r.finished:
                finished += 1
                lat.append(r.latency)
                on_time += int(r.on_time)
            else:
                lat.append(horizon_lat - r.arrival)  # censored
        lat_sorted = sorted(lat)
        n = len(lat_sorted)
        stats = dataclasses.asdict(self.engine.stats) if self.engine else {}
        return SimResult(
            scheduler=self.sched.name, pipeline=self.pipeline,
            workload="", oom=False, n_requests=n, n_finished=finished,
            n_request_oom=len(self.request_oom),
            slo_attainment=on_time / max(1, n),
            mean_latency=sum(lat) / max(1, n),
            p95_latency=lat_sorted[int(0.95 * (n - 1))] if n else 0.0,
            throughput_timeline=sorted((60.0 * b, c) for b, c in self.throughput.items()),
            placement_switches=self.placement_log,
            vr_histogram=dict(self.vr_histogram),
            engine_stats=stats,
            solver_ms=1e3 * self.sched.solver_time,
            sched_wakeups=self.clock.wakeups)


def run_sim(pipeline_id: str, scheduler_cls, workload: str, duration: float,
            sim_cfg: Optional[SimConfig] = None, seed: int = 0,
            rate: Optional[float] = None, slo_scale: Optional[float] = None,
            hw: Hardware = H100_SXM, **sched_kw) -> SimResult:
    """Convenience: build profiler (on ``hw``) + trace + scheduler and run."""
    sim_cfg = sim_cfg or SimConfig()
    pcfg = configs.get(pipeline_id)
    prof = Profiler(pcfg, hw=hw, force_k_min=getattr(scheduler_cls, "FORCE_KMIN", None))
    kw = {} if slo_scale is None else {"slo_scale": slo_scale}
    trace = workloads.make_trace(pipeline_id, workload, duration, prof,
                                 seed=seed, rate=rate, **kw)
    sched = scheduler_cls(prof, sim_cfg, trace, **sched_kw)
    sim = Simulator(pipeline_id, sched, trace, sim_cfg)
    res = sim.run()
    res.workload = workload
    return res
