"""TridentServe scheduler: Orchestrator + Dispatcher + Monitor glued per
Algorithm 1 (bootstrap placement -> online dispatch -> adaptive re-placement
via Adjust-on-Dispatch).

Counterpart of ``repro/core/trident.py``.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence

from repro_torch.core.clock import Scheduler
from repro_torch.core.dispatcher import DispatchDecision, Dispatcher
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.placement import PlacementPlan, PRIMARY_PLACEMENTS
from repro_torch.core.profiler import Profiler
from repro_torch.core.request import Request
from repro_torch.core.workloads import T_WIN


class TridentScheduler(Scheduler):
    name = "trident"

    def __init__(self, prof: Profiler, sim_cfg, trace: Sequence[Request], *,
                 enable_switch: bool = True, stage_aware: bool = True,
                 use_ilp: bool = True, enable_batching: bool = True,
                 aggregate_ilp: bool = False,
                 cross_lane_batching: bool = False,
                 incremental_ilp: bool = False):
        super().__init__(prof, sim_cfg, trace)
        self.orch = Orchestrator(prof, num_chips=sim_cfg.num_chips)
        # aggregate_ilp: multiplicity-aware solver aggregation (identical
        # pending requests enter once with a count); the fleet turns it on.
        # incremental_ilp: persist the dispatch model across wake-ups and
        # skip the solve when it is unchanged (``Dispatcher.incremental``)
        self.disp = Dispatcher(prof, aggregate=aggregate_ilp,
                               incremental=incremental_ilp)
        # array-backed lane state (SimConfig.array_state): the deadline
        # order comes from the PendingSet's deadline column, the same order
        self._array_state = sim_cfg.array_state
        # fleet cross-lane batching: when on, tick() annotates decisions
        # whose auxiliary E/C runs are fusable across lanes (dec.xl_candidate)
        # for the fleet's CrossLaneBatcher; off leaves decisions untouched
        self.cross_lane_batching = cross_lane_batching
        self.enable_switch = enable_switch      # wo-switch ablation
        self.stage_aware = stage_aware          # wo-stageAware ablation
        self.use_ilp = use_ilp                  # wo-scheduler ablation
        self.enable_batching = enable_batching  # App. E.1 dynamic batching
        self.t_win = T_WIN.get(prof.cfg.name, 300.0)
        self.solver_time = 0.0
        self._recent: List[Request] = []
        self._recent_ids: set = set()

    # -- Algorithm 1, lines 1-3 -----------------------------------------------

    def initial_placement(self) -> Optional[PlacementPlan]:
        sample = list(self.trace[:64])
        return self.orch.generate(sample)

    # -- Algorithm 1, lines 6-8 (adaptive re-placement) -------------------------

    def maybe_replace(self, sim, tau: float) -> Optional[PlacementPlan]:
        if not self.enable_switch:
            return None
        sim.monitor.t_win = self.t_win
        if not sim.monitor.pattern_change(tau, cooldown=self.t_win / 2):
            return None
        recent = [r for r in self._recent if r.arrival > tau - self.t_win]
        if len(recent) < 8:
            return None
        measured = sim.monitor.placement_rates(tau, sim.engine.plan.type_histogram())
        new_plan = self.orch.generate(recent, measured_rates=measured)
        if new_plan is None:   # no feasible re-placement: keep the current plan
            return None
        if new_plan.type_histogram() == sim.engine.plan.type_histogram():
            return None
        return new_plan

    def next_wake(self, sim, tau: float) -> Optional[float]:
        """Event-source plug-in (opt-in via
        ``SimConfig.scheduler_wake_hooks``): the pattern-change trigger is
        gated on a cooldown after the last switch and a warm-up of half a
        window — the earliest future time it can *newly* fire is the later
        of those two crossings.  Window contents themselves only change on
        completions and boundary wake-ups the clock already visits."""
        if not self.enable_switch:
            return None
        gate = max(sim.monitor.last_switch + self.t_win / 2, self.t_win / 2)
        return gate if gate > tau else None

    # -- Algorithm 1, lines 9-10 (dispatch) --------------------------------------

    def tick(self, sim, tau: float) -> List[DispatchDecision]:
        # the simulator exposes the batch admitted since the last step, so
        # recent-arrival bookkeeping is O(new) instead of O(pending) per tick
        for r in sim.new_arrivals:
            if r.rid not in self._recent_ids:
                self._recent.append(r)
                self._recent_ids.add(r.rid)
        if len(self._recent) > 4096:
            drop = self._recent[:-4096]
            self._recent = self._recent[-4096:]
            self._recent_ids -= {r.rid for r in drop}
        # live engine view (read-only contract, RuntimeEngine.idle_units):
        # held across dispatch but never mutated, and consumed before the
        # decisions are applied back to the engine
        idle = sim.engine.idle_units(tau)
        idle_primary = len(idle & sim.engine.plan.primary_units)
        sim.monitor.record_backlog(tau, len(sim.pending), idle_primary)
        if not sim.pending or idle_primary == 0:
            return []
        if not self.stage_aware:
            return self._dispatch_pipeline_level(sim, tau, idle)
        if not self.use_ilp:
            return self._dispatch_greedy_srtf(sim, tau, idle)
        t0 = time.perf_counter()  # detlint: ignore[DET002] wall-clock metrics only (solver_time); no control flow
        # App. E.1: form batches at the Diffuse stage's optimal batch size.
        # Same-class pending requests are chunked into batch-sized slices;
        # each slice's head enters the ILP and its tail rides along.
        pending = sim.pending
        chunk_of = {}
        if self.enable_batching:
            groups = {}
            ordered = (pending.by_deadline() if self._array_state
                       else sorted(pending, key=lambda r: r.deadline))
            for r in ordered:
                groups.setdefault(r.key(), []).append(r)
            pending = []
            for key, pool in groups.items():
                bs0 = self.prof.optimal_batch(
                    pool[0], "D",
                    self.prof.optimal_degree(pool[0], "D") * self.prof.k_min)
                for i in range(0, len(pool), bs0):
                    chunk = pool[i:i + bs0]
                    pending.append(chunk[0])
                    chunk_of[chunk[0].rid] = chunk
        # a fleet Lane carries its borrowed foreign E/C units (unit lending)
        # and its draining units (elastic capacity); the plain Simulator
        # has neither
        reuses0 = self.disp.solve_reuses
        out = self.disp.dispatch(pending, sim.engine.plan, idle,
                                 sim.engine.free_at(), tau,
                                 borrowed=getattr(sim, "borrowed_units", None),
                                 draining=getattr(sim, "draining_units",
                                                  None) or None)
        if self.disp.solve_reuses != reuses0:
            # credit persisted-model solve skips to the engine serving this
            # lane (banked across fleet re-partitions like every EngineStats
            # counter); without incremental_ilp it never moves
            sim.engine.stats.ilp_reuses += self.disp.solve_reuses - reuses0
        if self.enable_batching:
            for dec in out:
                chunk = chunk_of.get(dec.request.rid, [dec.request])
                bs = min(len(chunk), self.prof.optimal_batch(
                    dec.request, "D", dec.degree * self.prof.k_min))
                dec.corequests = tuple(chunk[1:bs])
        self.solver_time += time.perf_counter() - t0  # detlint: ignore[DET002] wall-clock metrics only (solver_time); no control flow
        if self.cross_lane_batching:
            self._mark_cross_lane(sim, tau, out)
        return out

    def _mark_cross_lane(self, sim, tau: float,
                         out: List[DispatchDecision]) -> None:
        """Mark auxiliary stage runs the fleet batcher may fuse across
        lanes: E when it is NOT merged into the primary launch, C when it
        runs on units outside the decode set.  Co-resident stages stay
        native — fusing them would break the merged-launch model."""
        free_at = sim.engine.free_at()
        for dec in out:
            prim = PRIMARY_PLACEMENTS[dec.vr_type]
            stages = []
            if "E" not in prim and dec.e_units:
                stages.append("E")
            if dec.c_units and not set(dec.c_units) <= set(dec.d_units):
                stages.append("C")
            if stages:
                dec.xl_candidate = tuple(stages)
            # E-hold: when the auxiliary encode unit is already backlogged
            # past one solo run, dispatching natively would pin primary
            # units against a queued encode.  The decision is marked held —
            # the fleet batcher still sees it as a fusion candidate this
            # tick, but if no cross-lane fusion takes it the lane skips
            # execution and the request stays in the pending pool
            # (clock.Lane.execute_decisions), so the backlog queues where
            # fusion can pack it instead of invisibly on the unit's
            # free_at.  Once the backlog drains (wait <= one run) requests
            # dispatch natively, so holding never idles the unit; requests
            # out of deadline slack always dispatch (no starvation under
            # overload).
            if "E" in stages:
                wait = max(free_at.get(g, tau) for g in dec.e_units) - tau
                solo = self.prof.stage_time(
                    dec.request, "E", len(dec.e_units) * self.prof.k_min)
                if wait > solo and tau + wait <= dec.request.deadline:
                    dec.xl_hold = True

    # -- ablation variants ---------------------------------------------------------

    def _dispatch_pipeline_level(self, sim, tau, idle) -> List[DispatchDecision]:
        """wo-stageAware: all stages take the Diffuse stage's unit set."""
        out = []
        avail = set(idle)
        for req in sorted(sim.pending, key=lambda r: r.deadline):
            k = self.prof.optimal_degree(req, "D")
            units = None
            for vr, ptype in enumerate(PRIMARY_PLACEMENTS):
                if not self.prof.fits(req, ptype, k):
                    continue
                units = Dispatcher.select_units(sim.engine.plan, ptype, k, avail)
                if units:
                    break
            if not units:
                continue
            avail -= set(units)
            out.append(DispatchDecision(request=req, vr_type=vr, degree=k,
                                        d_units=units, e_units=units,
                                        c_units=units))
        return out

    def _dispatch_greedy_srtf(self, sim, tau, idle) -> List[DispatchDecision]:
        """wo-scheduler: greedy SRTF replaces the ILP; stages still use
        profiled-optimal parallelism."""
        out = []
        avail = set(idle)
        free_at = sim.engine.free_at()

        def t_rem(r):
            k = self.prof.optimal_degree(r, "D") * self.prof.k_min
            return self.prof.stage_time(r, "D", k)

        for req in sorted(sim.pending, key=t_rem):
            k = self.prof.optimal_degree(req, "D")
            dec = None
            for vr, ptype in enumerate(PRIMARY_PLACEMENTS):
                if not self.prof.fits(req, ptype, k):
                    continue
                units = Dispatcher.select_units(sim.engine.plan, ptype, k, avail)
                if not units:
                    continue
                e_units = units if "E" in ptype else self.disp._aux_units(
                    sim.engine.plan, "E", self.prof.optimal_degree(req, "E"),
                    avail, free_at, tau)
                kc = self.prof.optimal_degree(req, "C")
                c_units = (units[:max(1, min(kc, len(units)))] if "C" in ptype
                           else self.disp._aux_units(sim.engine.plan, "C", kc,
                                                     avail, free_at, tau))
                if e_units and c_units:
                    dec = DispatchDecision(request=req, vr_type=vr, degree=k,
                                           d_units=units, e_units=tuple(e_units),
                                           c_units=tuple(c_units))
                    break
            if dec:
                avail -= set(dec.d_units)
                out.append(dec)
        return out
