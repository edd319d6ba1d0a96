"""Shared-cluster co-serving for heterogeneous diffusion pipelines.

TridentServe (Algorithm 1/2) derives one placement plan *per pipeline*; a
multi-model deployment then degenerates to static per-pipeline sub-clusters.
This module adds the missing layer: **one placement plan for the whole
cluster**, spanning every pipeline, with the chip budget per pipeline
re-derived from the live traffic mix.

* ``PipelineRegistry``     — one ``Profiler`` per served pipeline, on one
  named ``Hardware`` set (``H100_SXM`` unless the caller passes another).
* ``FleetPlacementPlan``   — the cluster-wide plan: per-pipeline chip
  ranges + pipeline-tagged sub-plans, so each scheduling unit carries
  ``(pipeline, placement_type)``.
* ``FleetOrchestrator``    — demand-weighted, node-quantized chip budgets
  (the unit-time footprint of each pipeline's recent traffic), then
  Algorithm 2 runs *per pipeline* inside its budget.
* ``FleetScheduler`` quartet — ``static`` (sub-clusters fixed at deploy
  time), ``proportional`` (re-partition to windowed demand every window, no
  hysteresis), ``adaptive`` (re-partition only on a
  ``FleetMonitor.mix_shift``, with hysteresis + cooldown, demand blended
  with queued backlog so a post-shift queue drains fast), ``predictive``
  (adaptive + the demand forecaster of core/forecast.py: predicts the next
  mix shift from rate history, pre-warms the target partition's weights on
  the units that will flip before the shift lands, and fires the swap the
  moment live rates confirm the prediction).
* ``FleetSimulator``       — one clock over the shared chip pool: a
  multi-lane ``ClockDriver`` over the same ``EventClock`` kernel the
  single-pipeline ``Simulator`` drives.  Each pipeline runs the unmodified
  single-pipeline TridentServe stack (``TridentScheduler`` +
  ``RuntimeEngine`` + ``Monitor``) inside a ``Lane``; on re-partition,
  chips change hands and the per-unit weight-swap cost (reload latency,
  charged on pipeline *or* type change) is paid by pre-busying the new
  units.
* Cross-lane dynamic batching — with ``FleetConfig.cross_lane_batching``
  the fleet step becomes decide-all → fuse → execute-all: the
  ``CrossLaneBatcher`` (core/dispatcher.py) merges auxiliary E/C runs whose
  units share a ``(stage, placement_type, unit_size)`` shape across two or
  more lanes into one batched launch, completed by ONE merged event
  (``clock.MERGED_LANE``) that ``_drain`` un-merges back into per-lane
  accounting.  Off (the default) the batcher is never constructed.

Wake sources (the clock.py standard: each subsystem registers one
``tau -> Optional[next-wake-time]`` closure, once, independent of lane
count): the next arrival, one Monitor-window boundary source per
replace-capable lane, the FleetMonitor demand/SLO/lending window
boundaries when the scheduler can re-partition, the lending broker's
loan-expiry and lending-window source when lending, the predictive
scheduler's ``forecast_wake`` when ``mode="predictive"``, and the fault
injector's capacity events when elastic.  Trigger *gates* stay in the
schedulers: a wake-up is only an opportunity to look.

Two options reshape capacity between re-partitions.  ``lending``
(core/lending.py): an idle unit of one pipeline hosts E/C stage work for a
backlogged other, paying its reloads both ways (``LendingBroker``).
``elastic`` (core/elastic.py): a seeded schedule of joins, preemptions
with notice, and degraded nodes plays through a ``FaultInjector``; the
fleet drains, requeues and re-partitions onto the pool that survives.

The single-pipeline system is the 1-pipeline special case: a fleet with one
registered pipeline reproduces ``Simulator`` + ``TridentScheduler``.

Counterpart of ``repro/core/fleet.py``.  The array-backed fast path
(``array_state``, ``incremental_ilp``, ``step_changed_lanes_only``) and
cross-node SP are later slices of the port: setting any of them raises
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import repro_torch.configs as configs
from repro_torch.core import workloads
from repro_torch.core.clock import (MERGED_LANE, ClockConfig, EventClock, Lane,
                                    monitor_boundary_source, replace_capable)
from repro_torch.core.dispatcher import CrossLaneBatcher
from repro_torch.core.elastic import FaultInjector
from repro_torch.core.forecast import DemandForecaster, rank_classes, tv_distance
from repro_torch.core.lending import LendingBroker
from repro_torch.core.monitor import FleetMonitor
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.placement import PlacementPlan
from repro_torch.core.profiler import H100_SXM, Hardware, Profiler
from repro_torch.core.request import Request
from repro_torch.core.runtime import RuntimeEngine
from repro_torch.core.simulator import SimConfig
from repro_torch.core.trident import TridentScheduler

# the FleetConfig switches of later slices, and the slice each waits for
CUT_OPTIONS = {
    "array_state": "the array-backed fast path",
    "incremental_ilp": "the array-backed fast path",
    "step_changed_lanes_only": "the array-backed fast path",
}


def not_ported(option: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(f"{option} comes with the {slice_name} slice of "
                               "the port; it is not ported yet")


def request_footprint(prof: Profiler, req: Request) -> float:
    """Unit-time footprint of one request: Diffuse chip-seconds at the
    profiled optimal degree.  The single currency the fleet partitions by —
    demand windows, backlog weights, and chip budgets must all be measured
    in it for ``FleetOrchestrator.budgets`` to mix them."""
    k = prof.optimal_degree(req, "D")
    return prof.stage_time(req, "D", k * prof.k_min) * k * prof.k_min


class PipelineRegistry:
    """One Profiler per served pipeline, keyed by config name, all on the
    same ``Hardware`` set."""

    def __init__(self, pipeline_ids: Sequence[str] = (),
                 cross_node_sp: bool = False, hw: Hardware = H100_SXM):
        if cross_node_sp:
            raise not_ported("cross_node_sp", "cross-node SP")
        self.hw = hw
        self._profs: Dict[str, Profiler] = {}
        for pid in pipeline_ids:
            self.register(pid)

    def register(self, pipeline_id: str,
                 profiler: Optional[Profiler] = None) -> Profiler:
        if profiler is None:
            profiler = Profiler(configs.get(pipeline_id), hw=self.hw)
        self._profs[pipeline_id] = profiler
        return profiler

    def profiler(self, pipeline_id: str) -> Profiler:
        return self._profs[pipeline_id]

    @property
    def pipelines(self) -> Tuple[str, ...]:
        return tuple(self._profs)

    def __len__(self) -> int:
        return len(self._profs)

    def __contains__(self, pipeline_id: str) -> bool:
        return pipeline_id in self._profs


@dataclasses.dataclass(frozen=True)
class LendableUnit:
    """One unit of the fleet plan that may host E/C stage work for another
    pipeline between re-partitions (cross-pipeline unit lending).

    ``borrow_cost`` maps (borrower pipeline, hosted stage) to the weight-swap
    latency the borrower pays when the unit changes hands; ``return_cost``
    is what the lender pays to reload its own weights on return — advisory
    (a map-build-time estimate): the broker recharges the actual return
    reload from the lender's live plan at close, since a lane re-placement
    may retype the unit while it is on loan."""
    pipeline: str
    unit: int
    ptype: str
    aux_class: bool                    # E/C-class unit (preferred stock)
    node: int
    borrow_cost: Dict[Tuple[str, str], float]
    return_cost: float


@dataclasses.dataclass
class FleetPlacementPlan:
    """One placement plan spanning the whole cluster: contiguous chip
    ranges per pipeline, each carrying a pipeline-tagged ``PlacementPlan``."""
    total_chips: int
    chip_ranges: Dict[str, Tuple[int, int]]     # pipeline -> [lo, hi) chips
    subplans: Dict[str, PlacementPlan]
    chips_per_node: int = 8

    def budget_histogram(self) -> Dict[str, int]:
        return {p: hi - lo for p, (lo, hi) in self.chip_ranges.items()}

    def tagged_units(self) -> List[Tuple[str, str]]:
        """(pipeline, placement_type) for every scheduling unit."""
        out: List[Tuple[str, str]] = []
        for pid, plan in self.subplans.items():
            out.extend((pid, p) for p in plan.placements)
        return out

    def type_histogram(self) -> Dict[Tuple[str, str], int]:
        hist: Dict[Tuple[str, str], int] = {}
        for tag in self.tagged_units():
            hist[tag] = hist.get(tag, 0) + 1
        return hist

    def unit_chips(self, pipeline: str, unit: int) -> Tuple[int, int]:
        """[lo, hi) chip span of one scheduling unit."""
        lo, _ = self.chip_ranges[pipeline]
        k = self.subplans[pipeline].unit_size
        return (lo + unit * k, lo + (unit + 1) * k)

    def node_of_unit(self, pipeline: str, unit: int) -> int:
        """Cluster-global node id of one scheduling unit."""
        return self.unit_chips(pipeline, unit)[0] // self.chips_per_node

    def lending_map(self, registry: "PipelineRegistry"
                    ) -> Dict[int, List[LendableUnit]]:
        """Per-node map of lendable units (cross-pipeline unit lending).

        A unit is lendable to borrower B iff its chip span can hold one of
        B's scheduling units (``unit_size`` covers B's) — the hosted stage is
        always E or C, never D, so B's diffuse placement is untouched.
        Aux-class (⟨E⟩/⟨C⟩) units are the preferred stock; primary-class
        units are listed too and the broker only taps them when the lender
        has idle surplus.  Costs come from ``Profiler.stage_load_time`` via
        the host path — the same currency re-partition swaps are charged in,
        so the min-hold policy can be compared against it directly."""
        out: Dict[int, List[LendableUnit]] = {}
        for pid, sub in self.subplans.items():
            lender_prof = registry.profiler(pid)
            for g, ptype in enumerate(sub.placements):
                if sub.is_extended(g):
                    continue   # borrowed overlay slots are not lendable stock
                costs: Dict[Tuple[str, str], float] = {}
                for bid in registry.pipelines:
                    if bid == pid:
                        continue
                    bsub = self.subplans.get(bid)
                    if bsub is not None and bsub.unit_size > sub.unit_size:
                        continue   # span too small for one borrower unit
                    bprof = registry.profiler(bid)
                    for s in ("E", "C"):
                        costs[(bid, s)] = bprof.stage_load_time(
                            s, via_host=True)
                if not costs:
                    continue
                ret_cost = sum(lender_prof.stage_load_time(s, via_host=True)
                               for s in ptype)
                node = self.node_of_unit(pid, g)
                out.setdefault(node, []).append(LendableUnit(
                    pipeline=pid, unit=g, ptype=ptype,
                    aux_class=ptype in ("E", "C"), node=node,
                    borrow_cost=costs, return_cost=ret_cost))
        return out


class FleetOrchestrator:
    """Chip budgets from demand, Algorithm 2 per pipeline inside each."""

    # SLO-weighted budget objective: a pipeline missing its deadlines gets
    # its demand weight grossed up by this gain times its windowed miss
    # fraction (miss 50% of a window -> 3x weight at the default gain).
    SLO_PRESSURE_GAIN = 4.0

    def __init__(self, registry: PipelineRegistry, num_chips: int = 512,
                 chips_per_node: int = 8):
        self.reg = registry
        self.num_chips = num_chips
        self.chips_per_node = chips_per_node
        # per-pipeline Algorithm-2 orchestrators, resized at each partition
        self._orchs = {pid: Orchestrator(registry.profiler(pid),
                                         num_chips=chips_per_node,
                                         chips_per_node=chips_per_node)
                       for pid in registry.pipelines}

    def demand_weights(self, reqs: Sequence[Request]) -> Dict[str, float]:
        """Unit-time footprint (chip-seconds of Diffuse work at the profiled
        optimal degree) per pipeline."""
        w = {pid: 0.0 for pid in self.reg.pipelines}
        for r in reqs:
            w[r.pipeline] += request_footprint(self.reg.profiler(r.pipeline), r)
        return w

    def objective_weights(self, weights: Dict[str, float],
                          slo_attainment: Dict[str, float],
                          objective: str = "demand") -> Dict[str, float]:
        """Apply ``FleetConfig.budget_objective`` to raw demand weights.

        ``"demand"`` (the default) returns ``weights`` unchanged.  ``"slo"``
        scales each pipeline's weight by its windowed SLO-miss pressure:
        chips flow toward the pipeline that is actually missing deadlines,
        not just the one with the largest footprint.  Pipelines with no
        windowed finishes keep their raw weight (no evidence, no boost)."""
        if objective != "slo" or not slo_attainment:
            return weights
        return {p: w * (1.0 + self.SLO_PRESSURE_GAIN
                        * (1.0 - slo_attainment.get(p, 1.0)))
                for p, w in weights.items()}

    def budgets(self, weights: Dict[str, float]) -> Dict[str, int]:
        """Demand-proportional chip budgets, quantized to whole nodes by
        largest remainder; every pipeline keeps at least one node so it can
        always serve (and Algorithm 2 stays feasible within its slice)."""
        upn = self.chips_per_node
        n_nodes = self.num_chips // upn
        pids = list(self.reg.pipelines)
        assert n_nodes >= len(pids), "cluster smaller than one node/pipeline"
        total = sum(max(0.0, weights.get(p, 0.0)) for p in pids)
        if total <= 0.0:
            raw = {p: n_nodes / len(pids) for p in pids}
        else:
            raw = {p: n_nodes * max(0.0, weights.get(p, 0.0)) / total
                   for p in pids}
        base = {p: max(1, math.floor(raw[p])) for p in pids}
        while sum(base.values()) > n_nodes:   # floors may overshoot n_nodes  # detlint: ignore[DET001] int node counts: exact
            p = max(pids, key=lambda p: base[p])
            base[p] -= 1
        rem = n_nodes - sum(base.values())  # detlint: ignore[DET001] int node counts: exact
        order = sorted(pids, key=lambda p: -(raw[p] - math.floor(raw[p])))
        i = 0
        while rem > 0:
            base[order[i % len(order)]] += 1
            rem -= 1
            i += 1
        return {p: base[p] * upn for p in pids}

    def generate(self, recent: Dict[str, Sequence[Request]],
                 budgets: Dict[str, int],
                 measured: Optional[Dict[str, Dict[str, float]]] = None
                 ) -> Optional[FleetPlacementPlan]:
        """One cluster-wide plan: Algorithm 2 per pipeline on its budget.
        Returns ``None`` when any pipeline has no feasible placement (the
        same contract ``Orchestrator.generate`` exposes)."""
        ranges: Dict[str, Tuple[int, int]] = {}
        subplans: Dict[str, PlacementPlan] = {}
        lo = 0
        for pid in self.reg.pipelines:
            chips = budgets[pid]
            orch = self._orchs[pid]
            orch.resize(chips)
            plan = orch.generate(list(recent.get(pid, ())),
                                 measured_rates=(measured or {}).get(pid))
            if plan is None:
                return None
            plan.pipeline = pid
            ranges[pid] = (lo, lo + chips)
            subplans[pid] = plan
            lo += chips
        return FleetPlacementPlan(self.num_chips, ranges, subplans,
                                  chips_per_node=self.chips_per_node)


@dataclasses.dataclass
class FleetConfig:
    num_chips: int = 512
    chips_per_node: int = 8
    tick: float = 0.25
    horizon_slack: float = 600.0
    seed: int = 0
    proactive_push: bool = True
    adjust_on_dispatch: bool = True
    mode: str = "event"               # "event" | "tick" (fixed-step loop)
    max_idle_gap: float = 1.0
    adaptive_idle_gap: bool = True    # profile-guided heartbeat (fleet runs
                                      # are long; quiet lanes should not pin
                                      # the clock to 1 s jumps)
    idle_gap_max: float = 16.0
    aggregate_ilp: bool = True        # multiplicity-aware dispatch ILP
    t_win: float = 180.0              # fleet demand window (s)
    hysteresis: float = 0.10          # min demand-share move to re-partition
    cooldown: float = 120.0           # min time between re-partitions (s)
    budget_objective: str = "demand"  # "demand" (pure footprint shares) |
                                      # "slo" (demand weighted by windowed
                                      # SLO-miss pressure; see
                                      # FleetOrchestrator.objective_weights)
    scheduler_wake_hooks: bool = False # register the fleet scheduler's
                                      # ``next_wake`` trigger-crossing hook
                                      # (window cadence / cooldown expiry)
                                      # as a kernel wake source.  Opt-in:
                                      # extra wake-ups shift heartbeat phase
    idle_window_wakeups: bool = False # Monitor-window wake-ups while fully
                                      # idle (the stale-window fix); lending
                                      # forces it on (loans must return
                                      # during idle gaps)
    # -- cross-pipeline unit lending (core/lending.py), default OFF ----------
    lending: bool = False
    lend_min_hold: float = 45.0       # a loan is held at least this long (s)
    lend_win: float = 20.0            # pressure window for borrow/return (s)
    # pressure is queued chip-seconds of work per owned chip (windowed mean)
    lend_min_pressure: float = 0.5    # borrow above this; lender reclaims at it
    lend_low_pressure: float = 0.05   # drained-borrower / busy-lender bound
    lend_reserve: int = 2             # idle units a lender always keeps
    lend_util_target: float = 0.4     # a lender keeps busy_mean/target units
                                      # for itself; only the surplus is stock
    lend_max_loans: int = 32          # concurrent loans per borrower
    lend_demand_frac: float = 8.0     # loan target per second of pressure
    lend_min_stage_s: float = 0.5     # borrow only when the hosted stage is
                                      # worth at least this long per request
                                      # (reloads never pay for ms decodes)
    # -- predictive re-partitioning (core/forecast.py), used only when the
    # fleet runs mode="predictive" ------------------------------------------
    forecast_bin: float = 10.0        # rate-history bin width (s)
    forecast_history: float = 600.0   # retained rate-history span (s)
    forecast_horizon: float = 240.0   # how far ahead to scan for a shift (s)
    forecast_min_conf: float = 0.35   # R² gate: act on a prediction only
                                      # when the fits explain this much of
                                      # the demand variance (stationary
                                      # traffic never crosses it)
    predictive_confirm: float = 0.4   # fraction of the hysteresis threshold
                                      # the *live* shares must have moved
                                      # (toward the prediction) before a
                                      # predicted shift may fire the swap
    forecast_grace: float = 60.0      # a predicted shift unconfirmed this
                                      # long after its time is dropped as a
                                      # mis-prediction
    prewarm_lead: float = 45.0        # start staging this long before the
                                      # predicted shift (must cover the
                                      # weight-reload latency)
    prewarm_budget: int = 16          # max units staged per pre-warm — the
                                      # mis-prediction cost bound
    prewarm_cooldown: float = 60.0    # min time between pre-warm stagings
    prewarm_ttl: float = 240.0        # staged weights are evicted (ignored
                                      # at cutover) after this long
    # -- cross-lane dynamic batching (core/dispatcher.py CrossLaneBatcher),
    # default OFF: the batcher object is never constructed ------------------
    cross_lane_batching: bool = False
    cross_lane_max_batch: int = 0     # 0 = profiler batch-curve cap; >0
                                      # replaces BOTH the fused launch's
                                      # shared batch budget and the
                                      # per-lane curve caps
    # -- the array-backed fast path, a later slice of the port: each raises
    # when set (CUT_OPTIONS) -------------------------------------------------
    array_state: bool = False         # array-backed lane state
    incremental_ilp: bool = False     # persisted dispatch model across ticks
    step_changed_lanes_only: bool = False  # O(changed-lanes) fleet stepping
    # -- elastic, failure-prone capacity (core/elastic.py), default OFF: the
    # FaultInjector is never constructed ------------------------------------
    elastic: bool = False             # play elastic_schedule through a
                                      # FaultInjector wake source
    elastic_schedule: Tuple = ()      # CapacityEvents (core/workloads.py
                                      # builds the preemption-storm and
                                      # region-evacuation schedules)
    elastic_drain: bool = True        # act on preemption notices: doomed
                                      # units drain stage-aware (only work
                                      # landing before the loss), in-flight
                                      # work that would outlive it requeues
                                      # ahead of the loss (the drain-unaware
                                      # arm turns this off)
    elastic_prewarm: bool = True      # stage target weights onto announced
                                      # join capacity during the lead window
    degrade_detect_ratio: float = 1.6 # quarantine a unit whose per-run mean
                                      # exceeds this x its pool mean
    degrade_min_samples: int = 6      # per-unit samples before quarantine

    def __post_init__(self):
        for option, slice_name in CUT_OPTIONS.items():
            if getattr(self, option):
                raise not_ported(f"FleetConfig.{option}", slice_name)

    def lane_sim_cfg(self, num_chips: int) -> SimConfig:
        return SimConfig(num_chips=num_chips, tick=self.tick,
                         horizon_slack=self.horizon_slack,
                         proactive_push=self.proactive_push,
                         adjust_on_dispatch=self.adjust_on_dispatch,
                         mode="event", max_idle_gap=self.max_idle_gap,
                         adaptive_idle_gap=self.adaptive_idle_gap,
                         idle_gap_max=self.idle_gap_max)

    def clock_cfg(self, horizon: float) -> ClockConfig:
        return ClockConfig(tick=self.tick, horizon=horizon, mode=self.mode,
                           max_idle_gap=self.max_idle_gap,
                           adaptive_idle_gap=self.adaptive_idle_gap,
                           idle_gap_max=self.idle_gap_max)


def make_lane(pipeline: str, prof: Profiler, sim_cfg: SimConfig,
              trace: Sequence[Request], aggregate_ilp: bool = False,
              cross_lane_batching: bool = False) -> Lane:
    """One pipeline's slice of the fleet: the unmodified single-pipeline
    TridentServe stack over a chip range, inside the shared ``Lane``
    container — so the lane *is* the 1-pipeline special case."""
    return Lane(pipeline, prof,
                TridentScheduler(prof, sim_cfg, trace,
                                 aggregate_ilp=aggregate_ilp,
                                 cross_lane_batching=cross_lane_batching))


# ---------------------------------------------------------------- schedulers

class FleetScheduler:
    """Static sub-clusters: partitioned once from the deploy-time traffic
    sample (the first fleet window of the trace), never moved."""

    name = "fleet-static"

    def __init__(self, fleet_orch: FleetOrchestrator, fleet_cfg: FleetConfig,
                 fixed_budgets: Optional[Dict[str, int]] = None):
        self.orch = fleet_orch
        self.cfg = fleet_cfg
        self.fixed_budgets = fixed_budgets
        self.basis_shares: Optional[Dict[str, float]] = None

    def initial_budgets(self, trace: Sequence[Request]) -> Dict[str, int]:
        if self.fixed_budgets is not None:
            return dict(self.fixed_budgets)
        prefix = [r for r in trace if r.arrival <= self.cfg.t_win]
        if not prefix:
            prefix = list(trace[:256])
        w = self.orch.demand_weights(prefix)
        total = sum(w.values())  # detlint: ignore[DET001] demand_weights dict is registry-ordered
        if total > 0:
            self.basis_shares = {p: v / total for p, v in w.items()}
        return self.orch.budgets(w)

    def maybe_repartition(self, fleet: "FleetSimulator", tau: float
                          ) -> Optional[Dict[str, int]]:
        return None

    def maybe_prewarm(self, fleet: "FleetSimulator", tau: float) -> None:
        """Predictive hook (``PredictiveFleetScheduler``): stage the next
        partition's weight loads ahead of a predicted shift.  Base: no-op."""
        return None

    def next_wake(self, fleet: "FleetSimulator", tau: float
                  ) -> Optional[float]:
        """Event-source plug-in (opt-in via
        ``FleetConfig.scheduler_wake_hooks``): the earliest future time
        this scheduler's re-partition trigger can *newly* fire — a window
        cadence or cooldown expiring.  Demand-share drift itself only
        moves on arrivals, which are already wake-ups."""
        return None

    def on_repartitioned(self, fleet: "FleetSimulator", tau: float) -> None:
        """A re-partition just landed: adopt the demand basis the new
        partition answers to.  Default: the windowed shares at swap time
        (the trigger must stop firing for the mix it just served)."""
        self.basis_shares = fleet.fleet_monitor.demand_shares(tau)

    def _objective_weights(self, fleet: "FleetSimulator", tau: float,
                           weights: Dict[str, float]) -> Dict[str, float]:
        return self.orch.objective_weights(
            weights, fleet.fleet_monitor.slo_attainment(tau),
            self.cfg.budget_objective)


class ProportionalFleetScheduler(FleetScheduler):
    """Re-partition to the windowed demand shares at every fleet window —
    no hysteresis, so weight-swap cost is paid whenever node-quantized
    shares wiggle.  The ablation the adaptive scheduler is judged against."""

    name = "fleet-prop"

    def maybe_repartition(self, fleet, tau):
        mon = fleet.fleet_monitor
        if tau - mon.last_repartition < self.cfg.t_win:
            return None
        shares = mon.demand_shares(tau)
        if not shares:
            return None
        budgets = self.orch.budgets(self._objective_weights(fleet, tau,
                                                            shares))
        if budgets == fleet.plan.budget_histogram():
            self.basis_shares = shares
            mon.last_repartition = tau   # window served; check again next win
            return None
        return budgets

    def next_wake(self, fleet, tau):
        cadence = fleet.fleet_monitor.last_repartition + self.cfg.t_win
        return cadence if cadence > tau else None


class AdaptiveFleetScheduler(FleetScheduler):
    """Re-partition only on a Monitor-detected traffic-mix shift (total
    variation of windowed demand shares vs the partition's basis >= the
    hysteresis threshold, past the cooldown).  Budgets weight windowed
    arrival demand *plus* the queued backlog footprint, so chips stranded
    on a now-idle pipeline move to the backlogged one and drain its queue."""

    name = "fleet-adaptive"

    def maybe_repartition(self, fleet, tau):
        mon = fleet.fleet_monitor
        if not mon.mix_shift(tau, self.basis_shares,
                             threshold=self.cfg.hysteresis,
                             cooldown=self.cfg.cooldown):
            return None
        shares = mon.demand_shares(tau)
        demand = mon.demand(tau)
        backlog = fleet.backlog_weights()
        weights = {p: demand.get(p, 0.0) + backlog.get(p, 0.0)
                   for p in self.orch.reg.pipelines}
        budgets = self.orch.budgets(self._objective_weights(fleet, tau,
                                                            weights))
        if budgets == fleet.plan.budget_histogram():
            # partition already matches the shifted demand at node
            # granularity: adopt the shares as the new basis so the trigger
            # stops firing.  Otherwise the basis only moves once the swap
            # actually succeeds (FleetSimulator._repartition) — an aborted
            # re-partition must leave the trigger armed.
            self.basis_shares = shares
            return None
        return budgets

    def next_wake(self, fleet, tau):
        cool = fleet.fleet_monitor.last_repartition + self.cfg.cooldown
        return cool if cool > tau else None


class PredictiveFleetScheduler(AdaptiveFleetScheduler):
    """Adaptive + a demand forecaster (core/forecast.py): predicts the next
    traffic-mix shift from per-pipeline windowed-rate history, **pre-warms**
    the target partition's weights on the units that will flip *before* the
    shift lands (overlapping the reload with the tail of the old mix), and
    fires the re-partition at the predicted shift once the live shares
    confirm it — instead of a detection window after it.  Wrong predictions
    cost at most the pre-warm budget's reloads per pre-warm cooldown;
    everything else falls back to plain adaptive behavior.

    Determinism contract: fits and staging attempts happen only at
    forecast-bin boundaries — grid points both clock modes visit (the
    fleet simulator registers ``forecast_wake`` as a kernel wake source) — so the
    event and tick clocks derive identical predictions and identical
    pre-warm trajectories."""

    name = "fleet-predictive"
    uses_forecast = True
    MIN_BINS = 12                      # bins before the first fit attempt

    def __init__(self, fleet_orch: FleetOrchestrator, fleet_cfg: FleetConfig,
                 fixed_budgets: Optional[Dict[str, int]] = None):
        super().__init__(fleet_orch, fleet_cfg, fixed_budgets)
        self.forecast = DemandForecaster(bin_s=fleet_cfg.forecast_bin,
                                         min_conf=fleet_cfg.forecast_min_conf)
        self._pred = None
        self._fit_bin = -1
        self._last_prewarm = -1e9
        self._fired_shares = None      # target shares of an in-flight
                                       # predictive fire (becomes the basis)
        self._cand = None              # last bin's candidate prediction —
                                       # a prediction arms only when two
                                       # consecutive bins agree on it
        # pre-warm campaign: one per armed prediction, staging incrementally
        # (idle units only) across the lead window under one unit budget
        self._campaign_pred = None
        self._campaign_budgets = None
        self._campaign_staged = 0
        self.early_fires = 0           # predictively fired re-partitions
        self.prewarms = 0              # units staged across the run
        self._class_fc = None          # per-placement-class forecaster,
                                       # built lazily (cross-lane batching
                                       # runs only; see _class_priority)

    # -- wake source (registered by the fleet simulator) --------------------------------

    def forecast_wake(self, tau: float) -> Optional[float]:
        """Earliest future forecast event the clock must visit: the next
        rate-history bin boundary (fits/staging happen only there), and the
        predicted shift time while a prediction is armed (the predictive
        fire condition crosses there)."""
        nxt = (math.floor(tau / self.cfg.forecast_bin) + 1.0) \
            * self.cfg.forecast_bin
        if self._pred is not None and tau < self._pred.t_shift:
            nxt = min(nxt, self._pred.t_shift)
        return nxt

    # -- forecasting -----------------------------------------------------------

    def maybe_prewarm(self, fleet: "FleetSimulator", tau: float) -> None:
        cfg = self.cfg
        cur_bin = int(tau // cfg.forecast_bin)
        if cur_bin == self._fit_bin:
            return                     # fits only move at bin boundaries
        self._fit_bin = cur_bin
        pred = self._pred
        if pred is not None and tau > pred.t_shift + cfg.forecast_grace:
            pred = self._pred = None   # shift never confirmed: mispredicted
        if pred is None or tau < pred.t_shift - cfg.prewarm_lead:
            # (re)predict freely while outside the pre-warm window; once
            # staging can begin the armed prediction is frozen, so the
            # refit at the shift itself cannot erase it before the live
            # shares get their chance to confirm it
            hist = fleet.fleet_monitor.rate_history(
                tau, self.orch.reg.pipelines)
            if len(hist) < self.MIN_BINS:
                self._pred = self._cand = None
                return
            self.forecast.fit(hist)
            cand = self.forecast.predict_shift(
                tau, threshold=cfg.hysteresis, horizon=cfg.forecast_horizon)
            prev, self._cand = self._cand, cand
            # a single bin's fit can blip (a lost period, a spurious trend)
            # and point the campaign at a phantom shift: arm only when two
            # consecutive bins agree on when the shift lands and what mix
            # it lands on
            stable = (cand is not None and prev is not None
                      and abs(cand.t_shift - prev.t_shift)
                      <= 2.0 * cfg.forecast_bin
                      and tv_distance(cand.shares, prev.shares)
                      <= cfg.hysteresis / 2.0)
            pred = self._pred = cand if stable else None
        if pred is None:
            return
        if tau < pred.t_shift - cfg.prewarm_lead:
            return                     # too early: weights would sit staged
        if self._campaign_pred is not pred:
            # one staging campaign per armed prediction, at most one per
            # pre-warm cooldown — the mis-prediction frequency bound
            if tau - self._last_prewarm < cfg.prewarm_cooldown:
                return
            self._last_prewarm = tau
            self._campaign_pred = pred
            self._campaign_budgets = self._target_budgets(fleet, tau, pred)
            self._campaign_staged = 0
        budgets = self._campaign_budgets
        if budgets is None or budgets == fleet.plan.budget_histogram():
            return
        left = cfg.prewarm_budget - self._campaign_staged
        if left > 0:
            # idle units only: busy units are deferred to the next bin's
            # retry, so staging rides the old mix's idle tail instead of
            # stalling live work
            n = fleet.stage_prewarm(
                budgets, tau, limit=left, idle_only=True,
                class_priority=self._class_priority(fleet, tau))
            self._campaign_staged += n
            self.prewarms += n

    def _class_priority(self, fleet: "FleetSimulator",
                        tau: float) -> Optional[List[str]]:
        """Placement classes by predicted demand at the armed shift time:
        with cross-lane batching on, fused E/C launches concentrate on the
        hottest auxiliary class, so the pre-warm budget should stage the
        placement-type *mix* the batcher will want first.  ``None``
        (plan-order staging) unless the batcher is on and the class history
        has enough bins."""
        if not self.cfg.cross_lane_batching:
            return None
        hist = fleet.fleet_monitor.class_rate_history(tau, ("E", "C"))
        if len(hist) < self.MIN_BINS:
            return None
        if self._class_fc is None:
            self._class_fc = DemandForecaster(
                bin_s=self.cfg.forecast_bin,
                min_conf=self.cfg.forecast_min_conf)
        self._class_fc.fit(hist)
        t = self._pred.t_shift if self._pred is not None else tau
        return rank_classes(self._class_fc, t)

    def _target_budgets(self, fleet: "FleetSimulator", tau: float,
                        pred) -> Optional[Dict[str, int]]:
        """Chip budgets for the partition the predicted post-shift mix will
        need: the settled new-phase demand rates (``pred.demand``), in the
        fleet's windowed chip-seconds currency."""
        w = {p: pred.demand.get(p, 0.0) * self.cfg.t_win
             for p in self.orch.reg.pipelines}
        if sum(w.values()) <= 0.0:  # detlint: ignore[DET001] dict-comp over registry order: insertion-ordered
            return None
        return self.orch.budgets(self._objective_weights(fleet, tau, w))

    def _recent_rates(self, fleet: "FleetSimulator", tau: float,
                      nbins: int = 3) -> Optional[Dict[str, float]]:
        """Near-instantaneous observed demand rates: the last ``nbins``
        completed rate-history bins.  The t_win demand window needs half a
        window to register a flip; these bins see it within seconds —
        that is what confirms (or refutes) a predicted shift."""
        hist = fleet.fleet_monitor.rate_history(tau, self.orch.reg.pipelines,
                                                last=nbins)
        if len(hist) < nbins:
            return None
        rates = {p: 0.0 for p in self.orch.reg.pipelines}
        for _, d in hist[-nbins:]:
            for p in self.orch.reg.pipelines:
                rates[p] += d.get(p, 0.0) / nbins
        return rates

    # -- re-partitioning -------------------------------------------------------

    def maybe_repartition(self, fleet, tau):
        cfg = self.cfg
        mon = fleet.fleet_monitor
        pred = self._pred
        if pred is None or tau < pred.t_shift - cfg.prewarm_lead:
            # no imminent prediction: plain adaptive behavior
            return super().maybe_repartition(fleet, tau)
        # an imminent predicted shift owns the cooldown: the reactive
        # trigger — whose trailing window would fire late and size the
        # partition for the *old* phase — holds while the live rates are
        # still consistent with "the shift has not landed yet".  The moment
        # the live rates shift AWAY from the prediction, it is wrong *now*
        # and reactive behavior resumes immediately (and ``forecast_grace``
        # expires a shift that never shows at all).
        rates = self._recent_rates(fleet, tau)
        tot = sum(rates.values()) if rates else 0.0  # detlint: ignore[DET001] rate dict is registry-ordered
        if tot > 0.0 and self.basis_shares:
            obs = {p: v / tot for p, v in sorted(rates.items())}
            moved = tv_distance(obs, self.basis_shares)
            if moved >= cfg.predictive_confirm * cfg.hysteresis:
                # the live mix has genuinely moved — with or against us?
                # confirmed: past the halfway point toward the predicted
                # mix.  contradicted: a full-threshold move that leaves the
                # observation *farther* from the prediction than the basis
                # was — i.e. the opposite direction, not merely a
                # transition still in flight.
                toward = (tv_distance(obs, pred.shares)
                          < tv_distance(obs, self.basis_shares))
                away = (tv_distance(obs, pred.shares)
                        > tv_distance(self.basis_shares, pred.shares)
                        + cfg.predictive_confirm * cfg.hysteresis)
                if moved >= cfg.hysteresis and away:
                    self._pred = self._cand = None
                    return super().maybe_repartition(fleet, tau)
                if toward and tau - mon.last_repartition >= cfg.cooldown:
                    # confirmed: fire now, sizing each pipeline by the
                    # *larger* of its forecast and its live rate, plus its
                    # queued backlog.  The forecast may add capacity ahead
                    # of demand, but never cut a pipeline below the live
                    # evidence.
                    backlog = fleet.backlog_weights()
                    weights = {
                        p: (max(pred.demand.get(p, 0.0),
                                rates.get(p, 0.0)) * cfg.t_win
                            + backlog.get(p, 0.0))
                        for p in self.orch.reg.pipelines}
                    budgets = self.orch.budgets(
                        self._objective_weights(fleet, tau, weights))
                    self._pred = None  # consumed
                    # the basis becomes the *settled predicted mix* — what
                    # the live shares will read once the transition has
                    # passed
                    if budgets == fleet.plan.budget_histogram():
                        # the partition already fits the shifted mix: adopt
                        # the target shares so the trailing window cannot
                        # re-trigger a redundant swap while it catches up
                        self.basis_shares = dict(pred.shares)
                        return None
                    self.early_fires += 1
                    self._fired_shares = dict(pred.shares)
                    return budgets
        return None

    def on_repartitioned(self, fleet, tau):
        """Predictive fires adopt their target shares as the basis (the
        trailing demand window still remembers the old phase for ~t_win/2
        after the shift, and adopting it would re-arm the trigger against
        the mix the swap just provisioned); reactive fallback swaps adopt
        the freshest observed rates when available, the trailing window
        otherwise."""
        if self._fired_shares is not None:
            self.basis_shares = self._fired_shares
            self._fired_shares = None
            return
        rates = self._recent_rates(fleet, tau)
        tot = sum(rates.values()) if rates else 0.0  # detlint: ignore[DET001] rate dict is registry-ordered
        if tot > 0.0:
            self.basis_shares = {p: v / tot
                                 for p, v in sorted(rates.items())}
        else:
            super().on_repartitioned(fleet, tau)


FLEET_SCHEDULERS = {
    "static": FleetScheduler,
    "proportional": ProportionalFleetScheduler,
    "adaptive": AdaptiveFleetScheduler,
    "predictive": PredictiveFleetScheduler,
}


# ---------------------------------------------------------------- results

@dataclasses.dataclass
class FleetResult:
    scheduler: str
    num_chips: int
    oom: bool
    n_requests: int
    n_finished: int
    n_request_oom: int
    slo_attainment: float
    goodput: float                    # on-time completions / s of trace span
    mean_latency: float
    p95_latency: float
    per_pipeline: Dict[str, Dict[str, float]]
    # cumulative RuntimeEngine counters per lane, summed across the engines
    # retired by re-partitions (Lane.bank_engine_stats)
    engine_stats: Dict[str, Dict[str, float]]
    repartitions: List[Tuple[float, Dict[str, int]]]
    swap_cost_s: float
    units_reloaded: int
    sched_wakeups: int
    # cross-pipeline unit lending (zeros unless FleetConfig.lending)
    loans: int = 0
    borrowed_unit_seconds: float = 0.0
    lend_swap_cost_s: float = 0.0
    borrowed_stage_runs: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    # predictive re-partitioning (zeros unless mode="predictive")
    prewarm_units: int = 0             # target units staged ahead of shifts
    prewarm_cost_s: float = 0.0        # staging reload time charged
    prewarm_hits: int = 0              # cutover units whose reload was
                                       # fully averted by staged weights
    prewarm_loan_returns: int = 0      # loans force-closed by staging
    predictive_repartitions: int = 0   # swaps fired by the forecaster
    # cross-lane dynamic batching (zeros unless
    # FleetConfig.cross_lane_batching)
    cross_lane_merges: int = 0         # fused multi-lane launches charged
    cross_lane_merged_requests: int = 0  # batch items across all fusions
    # elastic capacity (zeros unless FleetConfig.elastic; a fixed pool
    # reports its size as the surviving pool)
    capacity_events: int = 0           # join/preempt/degrade/recover landed
    nodes_joined: int = 0
    nodes_lost: int = 0
    requeued_requests: int = 0         # in-flight work revoked + requeued
    drained_units: int = 0             # units drained on preemption notice
    quarantined_units: int = 0         # degraded units detected + removed
    elastic_prewarm_chips: int = 0     # announced-join chips staged ahead
    final_chips: int = 0               # surviving pool size at run end

    def summary(self) -> str:
        if self.oom:
            return f"{self.scheduler:15s} OOM (no feasible fleet plan)"
        lend = (f"  loans={self.loans} "
                f"borrowed={self.borrowed_unit_seconds:.0f}unit-s"
                if self.loans else "")
        return (f"{self.scheduler:15s} SLO={self.slo_attainment * 100:5.1f}%  "
                f"goodput={self.goodput:6.2f}/s  "
                f"mean={self.mean_latency:7.2f}s  "
                f"p95={self.p95_latency:7.2f}s  "
                f"fin={self.n_finished}/{self.n_requests}  "
                f"swaps={len(self.repartitions) - 1}{lend}")


class FleetSimulator:
    """Co-serving simulator: one clock, one chip pool, one fleet placement
    plan; per-pipeline lanes run the single-pipeline scheduler code
    unchanged.  A multi-lane ``ClockDriver`` over the ``EventClock`` kernel
    the single-pipeline ``Simulator`` drives, so the 1-pipeline fleet is
    the same loop."""

    def __init__(self, registry: PipelineRegistry, scheduler: FleetScheduler,
                 trace: Sequence[Request], cfg: Optional[FleetConfig] = None):
        self.reg = registry
        self.fleet_sched = scheduler
        self.orch = scheduler.orch
        self.trace = sorted(trace, key=lambda r: r.arrival)
        self.cfg = cfg or FleetConfig()
        assert all(r.pipeline in registry for r in self.trace), \
            "trace contains requests for unregistered pipelines"
        self.fleet_monitor = FleetMonitor(t_win=self.cfg.t_win,
                                          lend_win=self.cfg.lend_win)
        self.lanes: Dict[str, Lane] = {}
        self.plan: Optional[FleetPlacementPlan] = None
        trace_end = self.trace[-1].arrival if self.trace else 0.0
        self.clock = EventClock(
            self.cfg.clock_cfg(trace_end + self.cfg.horizon_slack))
        self._ai = 0                   # arrival cursor into the trace
        self._fp_cache: Dict[tuple, float] = {}   # class -> footprint
        self.repartition_log: List[Tuple[float, Dict[str, int]]] = []
        self.swap_cost_s = 0.0
        self.units_reloaded = 0
        self._track_flips = (self.cfg.mode == "event"
                             and self.cfg.adaptive_idle_gap)
        self._repartition_capable = (
            type(scheduler).maybe_repartition
            is not FleetScheduler.maybe_repartition)
        # unit lending (core/lending.py): the broker exists only when the
        # knob is on
        self.broker: Optional[LendingBroker] = None
        if self.cfg.lending:
            self.broker = LendingBroker(self.cfg, registry)
        # predictive pre-warm (core/forecast.py): chip -> (target pipeline,
        # staged stages, staging time).  Empty — and the rate history
        # disabled — unless the scheduler carries a forecaster.
        self.uses_forecast = getattr(scheduler, "uses_forecast", False)
        if self.uses_forecast:
            self.fleet_monitor.enable_rate_history(self.cfg.forecast_bin,
                                                   self.cfg.forecast_history)
        # cross-lane dynamic batching (core/dispatcher.py): the batcher is
        # only constructed when the knob is on
        self._xl = None
        if self.cfg.cross_lane_batching:
            self._xl = CrossLaneBatcher(max_batch=self.cfg.cross_lane_max_batch)
        # elastic capacity (core/elastic.py): like the broker and the
        # batcher, the injector exists only when the knob is on
        self.injector: Optional[FaultInjector] = None
        if self.cfg.elastic:
            self.injector = FaultInjector(self.cfg)
            if self._xl is not None:
                self._xl.track_units = True
        self._class_hist = (self.uses_forecast
                            and self.cfg.cross_lane_batching)
        if self._class_hist:
            # per-placement-class demand history: lets the predictive
            # scheduler pre-warm the placement-type *mix* the batcher will
            # want, not just per-pipeline totals (see maybe_prewarm)
            self.fleet_monitor.enable_class_history(self.cfg.forecast_bin,
                                                    self.cfg.forecast_history)
        self.prewarmed: Dict[int, Tuple[str, frozenset, float]] = {}
        self.prewarm_cost_s = 0.0
        self.prewarm_units = 0
        self.prewarm_hits = 0
        self.prewarm_loan_returns = 0
        self._tau_last = 0.0

    # ---------------------------------------------------------------- helpers

    @property
    def sched_wakeups(self) -> int:
        return self.clock.wakeups

    def backlog_weights(self) -> Dict[str, float]:
        """Outstanding unit-time footprint (chip-seconds) per lane queue."""
        return {pid: sum(request_footprint(lane.prof, r)
                         for r in lane.pending)
                for pid, lane in self.lanes.items()}

    # -- wake sources (registered once in run(), any lane count) --------------

    def _work_in_flight(self) -> bool:
        return (any(lane.pending for lane in self.lanes.values())
                or bool(self.clock.completions))

    def _register_wake_sources(self) -> None:
        self.clock.add_source(self._next_arrival)
        # stale-window fix: with idle_window_wakeups (forced on by lending:
        # loans must be able to return during an idle gap), Monitor-window
        # boundaries stay wake-up sources even while nothing is pending
        idle_wake = self.cfg.idle_window_wakeups or self.cfg.lending
        for lane in self.lanes.values():
            if replace_capable(lane.sched):
                self.clock.add_source(monitor_boundary_source(
                    lane.monitor,
                    lambda lane=lane: bool(lane.pending
                                           or self.clock.completions
                                           or idle_wake)))
        if self._repartition_capable:
            self.clock.add_source(monitor_boundary_source(
                self.fleet_monitor,
                lambda: self._work_in_flight() or idle_wake))
        if self.broker is not None:
            # borrow/return events: min-hold expiries and lend-window
            # re-checks while any loan is outstanding
            self.clock.add_source(self.broker.next_wake)
        if self.uses_forecast:
            # predictive pre-warm events: rate-history bin boundaries (fits
            # and staging only move there) and the armed shift time
            self.clock.add_source(self.fleet_sched.forecast_wake)
        if self.injector is not None:
            # capacity events: join/preempt notices and landings fire at
            # exact schedule times in both clock modes
            self.clock.add_source(self.injector.next_wake)
        if self.cfg.scheduler_wake_hooks:
            self.clock.add_source(
                lambda tau: self.fleet_sched.next_wake(self, tau))

    # ---------------------------------------------------------------- main

    def run(self) -> FleetResult:
        # single-run objects: a second run would admit nothing and
        # double-register every wake source — fail loudly
        assert self.clock.wakeups == 0, \
            "FleetSimulator instances are single-run"
        budgets = self.fleet_sched.initial_budgets(self.trace)
        sub_traces = {pid: [r for r in self.trace if r.pipeline == pid]
                      for pid in self.reg.pipelines}
        recent = {pid: sub_traces[pid][:64] for pid in self.reg.pipelines}
        self.plan = self.orch.generate(recent, budgets)
        if self.plan is None:
            return self._oom_result()
        for pid in self.reg.pipelines:
            prof = self.reg.profiler(pid)
            lane = make_lane(pid, prof, self.cfg.lane_sim_cfg(budgets[pid]),
                             sub_traces[pid],
                             aggregate_ilp=self.cfg.aggregate_ilp,
                             cross_lane_batching=self.cfg.cross_lane_batching)
            lane.engine = RuntimeEngine(
                prof, self.plan.subplans[pid],
                proactive_push=self.cfg.proactive_push,
                adjust_on_dispatch=self.cfg.adjust_on_dispatch)
            lane.base_units = len(lane.engine.units)
            lane.track_borrowed = self.broker is not None
            lane.track_units = self.injector is not None
            lane.placement_log.append(
                (0.0, self.plan.subplans[pid].type_histogram()))
            self.lanes[pid] = lane
        self.repartition_log.append((0.0, dict(budgets)))
        # the initial partition is a partition event: the swap cooldown runs
        # from deployment, so a seconds-old (near-empty) demand window can't
        # trigger an immediate re-partition
        self.fleet_monitor.last_repartition = 0.0
        self._register_wake_sources()
        self.clock.run(self)
        return self._result()

    # -- ClockDriver protocol --------------------------------------------------

    def _next_arrival(self, tau: float) -> Optional[float]:
        if self._ai < len(self.trace):
            return self.trace[self._ai].arrival
        return None

    def advance(self, tau: float) -> None:
        self._admit(tau)
        self._drain(tau)
        self._step(tau)

    def done(self) -> bool:
        return self._ai >= len(self.trace) and not self._work_in_flight()

    def heartbeat_pending(self) -> bool:
        return any(lane.pending for lane in self.lanes.values())

    def still_pending(self, lane: str, rid: int) -> bool:
        return self.lanes[lane].pending.has_rid(rid)

    # -- one scheduler step ---------------------------------------------------

    def _admit(self, tau: float) -> None:
        for lane in self.lanes.values():
            lane.new_arrivals = []
        trace = self.trace
        n = len(trace)
        ai = self._ai
        clock = self.clock if self._track_flips else None
        # request_footprint is a pure function of the request class: cache
        # the final float per class
        fp_cache = self._fp_cache
        while ai < n and trace[ai].arrival <= tau:
            r = trace[ai]
            lane = self.lanes[r.pipeline]
            lane.admit(r, clock)
            fk = (r.pipeline, r.resolution, r.seconds, r.cond_len)
            fp = fp_cache.get(fk)
            if fp is None:
                fp = fp_cache[fk] = request_footprint(lane.prof, r)
            self.fleet_monitor.record_arrival(r.arrival, r.pipeline, fp)
            if self._class_hist:
                # auxiliary-stage chip-seconds by placement class: what the
                # cross-lane batcher's fused E/C launches will draw on
                prof = lane.prof
                for s in ("E", "C"):
                    k = prof.optimal_degree(r, s) * prof.k_min
                    self.fleet_monitor.record_class_demand(
                        r.arrival, s, prof.stage_time(r, s, k) * k)
            ai += 1
        self._ai = ai

    def _drain(self, tau: float) -> None:
        inj = self.injector
        for t, _, pid, s, ptype, dur, members, units in self.clock.pop_due(tau):
            if inj is not None and units:
                # degrade detection feed (per-unit vs pool mean); fused
                # MERGED_LANE durations are skipped inside observe
                inj.observe(self, pid, s, ptype, dur, members, units, t)
            if pid == MERGED_LANE:
                # cross-lane fused launch: un-merge the one event back into
                # per-lane accounting — each participating lane observes the
                # completion once, each member settles under its own lane
                for lp in sorted({r.pipeline for r in members}):
                    self.lanes[lp].on_completion(t, s, ptype, dur)
                if s == "C":
                    for req in members:
                        self.fleet_monitor.record_finish(
                            t, req.pipeline, t <= req.deadline)
                continue
            self.lanes[pid].on_completion(t, s, ptype, dur)
            if s == "C":
                for req in members:
                    self.fleet_monitor.record_finish(t, pid,
                                                     t <= req.deadline)

    def _step(self, tau: float) -> None:
        self._tau_last = tau
        if self.injector is not None:
            # capacity events fire before any scheduling this wake-up: a
            # landed join/loss re-partitions here, a notice drains here
            self.injector.step(self, tau)
        self.fleet_sched.maybe_prewarm(self, tau)
        budgets = self.fleet_sched.maybe_repartition(self, tau)
        if budgets is not None:
            self._repartition(budgets, tau)
        if self.broker is not None:
            self.broker.step(self, tau)
        if self._xl is None:
            for lane in self.lanes.values():
                lane.step(tau, self.clock,
                          lambda new_plan, t, lane=lane:
                              self._apply_lane_plan(lane, new_plan, t))
        else:
            # cross-lane batching: decide every lane first, fuse matching
            # auxiliary runs across lanes, then execute.  Lanes own disjoint
            # engines and the dispatchers see only their own lane's state,
            # so decide-all-then-execute-all is equivalent to the
            # interleaved per-lane stepping above; deferred fused C launches
            # run last, once every member's decode finish is stamped.
            lane_decs = [
                (lane, lane.decide(tau,
                                   lambda new_plan, t, lane=lane:
                                       self._apply_lane_plan(lane, new_plan, t)))
                for lane in self.lanes.values()]
            cgroups = self._xl.plan(lane_decs, tau, self.clock)
            for lane, decs in lane_decs:
                lane.execute_decisions(decs, tau, self.clock)
            self._xl.finalize(cgroups, tau, self.clock)
        if self.broker is not None:
            # sample pressure after dispatch: what is still pending now is
            # genuine backlog, not the arrivals this wake-up just served
            self.broker.sample(self, tau)

    def _apply_lane_plan(self, lane: Lane, new_plan: PlacementPlan,
                         tau: float) -> None:
        """A lane-level placement switch: drop pre-warm marks the switch
        invalidates, reattach loan slots (the fresh plan must carry them
        before the engine sees it), then swap the cluster plan's
        sub-plan."""
        new_plan.pipeline = lane.pipeline
        if self.prewarmed:
            # staged pre-warm marks describe the *old* unit layout: any
            # unit whose placement this switch changes must shed them, or
            # a later re-partition would count a stale mark as a hit and
            # skip a reload the chips genuinely owe
            old = self.plan.subplans[lane.pipeline]
            lo, hi = self.plan.chip_ranges[lane.pipeline]
            if (new_plan.unit_size != old.unit_size
                    or len(new_plan.placements) != len(old.placements)):
                for c in range(lo, hi):
                    self.prewarmed.pop(c, None)
            else:
                k = old.unit_size
                for g, p in enumerate(old.placements):
                    if new_plan.placements[g] != p:
                        for c in range(lo + g * k, lo + (g + 1) * k):
                            self.prewarmed.pop(c, None)
        if self.broker is not None:
            self.broker.reattach(lane, new_plan)
        lane.engine.apply_placement(new_plan, tau)
        self.plan.subplans[lane.pipeline] = new_plan

    # -- re-partitioning ------------------------------------------------------

    def _chip_state(self) -> Tuple[Dict[int, float],
                                   Dict[int, Tuple[str, int, frozenset]]]:
        """Per-chip (free time, (owner pipeline, owner unit, resident
        stages)) over the lanes' own (non-loan) units — the inputs both the
        re-partition reload accounting and the pre-warm staging diff."""
        chip_free: Dict[int, float] = {}
        chip_owner: Dict[int, Tuple[str, int, frozenset]] = {}
        for pid, lane in self.lanes.items():
            lo, _ = self.plan.chip_ranges[pid]
            k = self.plan.subplans[pid].unit_size
            for u in lane.engine.units[:lane.base_units]:
                for c in range(lo + u.uid * k, lo + (u.uid + 1) * k):
                    chip_free[c] = u.free_at
                    chip_owner[c] = (pid, u.uid, frozenset(u.resident))
        return chip_free, chip_owner

    def _plan_inputs(self, tau: float) -> Tuple[Dict, Dict]:
        """(recent requests, measured placement rates) per pipeline — what
        ``FleetOrchestrator.generate`` plans from, shared by re-partitions
        and pre-warm target planning."""
        recent = {}
        measured = {}
        for pid, lane in self.lanes.items():
            recent[pid] = [r for r in lane.sched._recent
                           if r.arrival > tau - lane.sched.t_win][-512:]
            measured[pid] = lane.monitor.placement_rates(
                tau, self.plan.subplans[pid].type_histogram())
        return recent, measured

    def stage_prewarm(self, budgets: Dict[str, int], tau: float,
                      limit: Optional[int] = None,
                      idle_only: bool = False,
                      class_priority: Optional[List[str]] = None) -> int:
        """Stage the predicted target partition's weight loads on the chips
        that will flip, *before* the shift lands.  The owning units keep
        serving their current pipeline — each just hosts the staging DMA as
        busy time (``RuntimeEngine.stage_prewarm``) — and the staged chips
        are remembered so the next re-partition skips their reloads.

        With ``idle_only`` a unit is staged only when every owning unit is
        idle at ``tau`` (busy units are deferred to a later forecast bin).
        At most ``limit`` (default ``prewarm_budget``) target units are
        staged per call — the mis-prediction cost bound.  Already-staged
        chips are skipped, so repeated calls converge instead of re-paying.

        ``class_priority`` re-orders the staging walk by placement type
        (stable sort, so ``None`` walks the target plan in plan order).
        Returns the number of units staged."""
        recent, measured = self._plan_inputs(tau)
        target = self.orch.generate(recent, budgets, measured)
        if target is None:
            return 0
        chip_free, chip_owner = self._chip_state()
        ttl = self.cfg.prewarm_ttl
        cap = self.cfg.prewarm_budget if limit is None else limit
        staged = 0
        units_iter = [(pid, g, ptype)
                      for pid in self.reg.pipelines
                      for g, ptype in
                      enumerate(target.subplans[pid].placements)]
        if class_priority:
            rank = {c: i for i, c in enumerate(class_priority)}
            units_iter.sort(key=lambda u: rank.get(u[2], len(rank)))
        for pid, g, ptype in units_iter:
            sub = target.subplans[pid]
            prof = self.reg.profiler(pid)
            lo, _ = target.chip_ranges[pid]
            k = sub.unit_size
            if staged >= cap:
                return staged
            need = set(ptype)
            chips = range(lo + g * k, lo + (g + 1) * k)
            per_owner: Dict[Tuple[str, int], set] = {}
            for c in chips:
                owner = chip_owner.get(c)
                if owner is None:
                    continue
                missing = need if owner[0] != pid else need - owner[2]
                pw = self.prewarmed.get(c)
                if pw is not None and pw[0] == pid and tau - pw[2] <= ttl:
                    missing = missing - pw[1]
                if missing:
                    per_owner.setdefault((owner[0], owner[1]),
                                         set()).update(missing)
            if not per_owner:
                continue       # nothing (left) to stage for this unit
            if idle_only and any(
                    self.lanes[opid].engine.units[ouid].free_at > tau
                    for opid, ouid in per_owner):
                continue       # owner mid-work: defer to a later bin
            if self.broker is not None:
                for opid, ouid in sorted(per_owner):
                    if self.broker.force_return_unit(self, opid, ouid, tau):
                        # a lent-out unit scheduled for pre-warm returns its
                        # loan before anything is staged on its chips: no
                        # loan may survive the coming cutover
                        self.prewarm_loan_returns += 1
                if any(self.broker.unit_on_loan(opid, ouid)
                       for opid, ouid in sorted(per_owner)):
                    # a force-return deferred past an un-drained fused
                    # launch (core/lending.py) leaves the loan open: defer
                    # this target unit too; the next bin's retry stages it
                    continue
            for opid, ouid in sorted(per_owner):
                # sorted: a float sum over a str set is order-sensitive in
                # the last ulp, and str-set order follows PYTHONHASHSEED
                load = sum(prof.stage_load_time(s, via_host=True)
                           for s in sorted(per_owner[(opid, ouid)]))
                self.lanes[opid].engine.stage_prewarm(ouid, tau, load)
                self.prewarm_cost_s += load
            for c in chips:
                self.prewarmed[c] = (pid, frozenset(need), tau)
            self.prewarm_units += 1
            staged += 1
        return staged

    def _repartition(self, budgets: Dict[str, int], tau: float,
                     chip_map: Optional[Dict[int, int]] = None) -> None:
        """Move chips between lanes.  Per-chip in-flight work and stage
        residency carry over; units whose pipeline or placement type changed
        hands pay the weight-reload latency before becoming dispatchable —
        unless the predictive scheduler pre-warmed their chips, in which
        case the staged stages are already loaded and charge nothing.

        ``chip_map`` (capacity re-partitions after a node loss,
        core/elastic.py) translates surviving old chip indices into the
        compacted space; state on unmapped (lost) chips drops out here."""
        if self.broker is not None:
            # loans cannot outlive the partition they were struck under:
            # force-return them first (in-flight borrowed work and the
            # lender's reload land on the lender's chips via free_at below)
            self.broker.release_all(self, tau)
        chip_free, chip_owner = self._chip_state()
        if chip_map is not None:
            chip_free = {chip_map[c]: v for c, v in chip_free.items()
                         if c in chip_map}
            chip_owner = {chip_map[c]: v for c, v in chip_owner.items()
                          if c in chip_map}
            self.prewarmed = {chip_map[c]: v
                              for c, v in self.prewarmed.items()
                              if c in chip_map}
        recent, measured = self._plan_inputs(tau)
        new_plan = self.orch.generate(recent, budgets, measured)
        if new_plan is None:   # no feasible re-partition: keep the old plan
            return
        prewarmed = self.prewarmed
        ttl = self.cfg.prewarm_ttl
        for pid, lane in self.lanes.items():  # detlint: ignore[DET001] lanes dict is registry-ordered
            sub = new_plan.subplans[pid]
            prof = lane.prof
            lane.bank_engine_stats()
            engine = RuntimeEngine(
                prof, sub, proactive_push=self.cfg.proactive_push,
                adjust_on_dispatch=self.cfg.adjust_on_dispatch)
            busy: Dict[int, float] = {}
            lo, _ = new_plan.chip_ranges[pid]
            k = sub.unit_size
            for g, ptype in enumerate(sub.placements):
                chips = range(lo + g * k, lo + (g + 1) * k)
                base = max(chip_free.get(c, 0.0) for c in chips)
                need = set(ptype)
                reload = 0.0
                averted = False
                for c in chips:
                    owner = chip_owner.get(c)
                    missing = (need if owner is None or owner[0] != pid
                               else need - owner[2])
                    if missing and prewarmed:
                        pw = prewarmed.get(c)
                        if (pw is not None and pw[0] == pid
                                and tau - pw[2] <= ttl and missing & pw[1]):
                            missing = missing - pw[1]
                            averted = True
                    if missing:
                        # sorted: a 3-term float sum is order-sensitive in
                        # the last ulp, and set iteration order over str
                        # keys follows PYTHONHASHSEED
                        reload = max(reload, sum(
                            prof.stage_load_time(s, via_host=True)
                            for s in sorted(missing)))
                if averted and reload == 0.0:
                    self.prewarm_hits += 1
                if reload > 0.0:
                    self.swap_cost_s += reload
                    self.units_reloaded += 1
                    busy[g] = max(tau, base) + reload
                elif base > 0.0:
                    busy[g] = base
            engine.seed_unit_state(busy)
            lane.engine = engine
            lane.base_units = len(engine.units)
            lane.sched.orch.resize(budgets[pid])
            lane.placement_log.append((tau, sub.type_histogram()))
        self.plan = new_plan
        # staged weights were either consumed above or are stale now that
        # the chips changed hands — either way the marks are spent
        self.prewarmed.clear()
        if self.broker is not None:
            self.broker.reset_after_repartition(self)
        self.fleet_monitor.last_repartition = tau
        # the swap happened: only now does the partition's demand basis move
        # (an aborted re-partition must leave the mix-shift trigger armed)
        self.fleet_sched.on_repartitioned(self, tau)
        self.repartition_log.append((tau, dict(budgets)))
        if self.injector is not None:
            # fresh engines and sub-plans: re-derive the injector's
            # overlays (slowdowns, quarantines, a pending drain)
            self.injector.after_repartition(self, tau)

    # -- lending and elastic capacity hooks ------------------------------------

    def _evict_prewarm_unit(self, pid: str, g: int) -> None:
        """Drop staged pre-warm marks on one unit's chips: the unit was
        mutated under the marks (lent out, retyped, decommissioned), so
        they must not count as hits and avert a reload the chips owe."""
        if not self.prewarmed:
            return
        lo, hi = self.plan.unit_chips(pid, g)
        for c in range(lo, hi):
            self.prewarmed.pop(c, None)

    def _capacity_repartition(self, tau: float,
                              chip_map: Optional[Dict[int, int]] = None
                              ) -> None:
        """Re-partition to the *current* pool size: a join landed or a
        preemption compacted the chip space (core/elastic.py).  Capacity
        re-partitions bypass the mix-shift trigger and its cooldown (the
        pool changed, not the mix) and size lanes by live windowed demand
        plus queued backlog.  An infeasible one is fatal: the fleet cannot
        keep serving a plan sized for chips that no longer exist."""
        demand = self.fleet_monitor.demand(tau)
        backlog = self.backlog_weights()
        weights = {p: demand.get(p, 0.0) + backlog.get(p, 0.0)
                   for p in self.reg.pipelines}
        budgets = self.orch.budgets(
            self.fleet_sched._objective_weights(self, tau, weights))
        self._repartition(budgets, tau, chip_map=chip_map)
        assert self.plan.total_chips == self.orch.num_chips, \
            "no feasible partition for the surviving chip pool"

    # ---------------------------------------------------------------- results

    def _oom_result(self) -> FleetResult:
        return FleetResult(
            scheduler=self.fleet_sched.name, num_chips=self.cfg.num_chips,
            oom=True, n_requests=len(self.trace), n_finished=0,
            n_request_oom=len(self.trace), slo_attainment=0.0, goodput=0.0,
            mean_latency=float("inf"), p95_latency=float("inf"),
            per_pipeline={}, engine_stats={}, repartitions=[],
            swap_cost_s=0.0, units_reloaded=0, sched_wakeups=0)

    @staticmethod
    def _metrics(reqs: Sequence[Request], oom_ids: set,
                 horizon_lat: float) -> Dict[str, float]:
        lat: List[float] = []
        on_time = 0
        finished = 0
        # Request.finished/latency/on_time inlined: each property re-derives
        # the "C" finish stamp; the same floats come out of one dict probe
        for r in reqs:
            if r.rid in oom_ids:
                lat.append(horizon_lat)
                continue
            f = r.stage_done.get("C")
            if f is not None:
                finished += 1
                lat.append(f - r.arrival)
                if f <= r.deadline:
                    on_time += 1
            else:
                lat.append(horizon_lat - r.arrival)   # censored
        lat_sorted = sorted(lat)
        n = len(lat_sorted)
        return {
            "requests": n, "finished": finished, "on_time": on_time,
            "slo": on_time / max(1, n),
            "mean_s": sum(lat) / max(1, n),
            "p95_s": lat_sorted[int(0.95 * (n - 1))] if n else 0.0,
        }

    def _result(self) -> FleetResult:
        trace_end = self.trace[-1].arrival if self.trace else 0.0
        horizon_lat = trace_end + self.cfg.horizon_slack
        oom_ids = {r.rid for lane in self.lanes.values()
                   for r in lane.request_oom}
        per_pipeline: Dict[str, Dict[str, float]] = {}
        # one grouping pass instead of one full-trace scan per lane (order
        # within each group is trace order, same as the per-lane filter)
        by_pid: Dict[str, List[Request]] = {pid: [] for pid in self.lanes}
        for r in self.trace:
            grp = by_pid.get(r.pipeline)
            if grp is not None:
                grp.append(r)
        for pid, lane in self.lanes.items():
            m = self._metrics(by_pid[pid], oom_ids, horizon_lat)
            m["chips"] = self.plan.chip_ranges[pid][1] - \
                self.plan.chip_ranges[pid][0]
            per_pipeline[pid] = m
        agg = self._metrics(self.trace, oom_ids, horizon_lat)
        lend_kw = {}
        if self.broker is not None:
            self.broker.finalize(self._tau_last)
            runs: Dict[str, int] = {}
            for lane in self.lanes.values():
                for s, n in lane.borrowed_stage_runs.items():
                    runs[s] = runs.get(s, 0) + n
            lend_kw = dict(loans=self.broker.loans_granted,
                           borrowed_unit_seconds=round(
                               self.broker.borrowed_unit_seconds, 3),
                           lend_swap_cost_s=round(self.broker.swap_cost_s, 3),
                           borrowed_stage_runs=runs)
        # a fixed pool "survives" at its starting size, so the elastic
        # off path reports the same field the injector would
        elastic_kw: Dict = dict(final_chips=self.cfg.num_chips)
        if self.injector is not None:
            inj = self.injector
            elastic_kw = dict(
                capacity_events=inj.capacity_events,
                nodes_joined=inj.nodes_joined,
                nodes_lost=inj.nodes_lost,
                requeued_requests=inj.requeued_requests,
                drained_units=inj.drained_units,
                quarantined_units=inj.quarantined_units,
                elastic_prewarm_chips=inj.elastic_prewarm_chips,
                final_chips=inj.live_chips)
        return FleetResult(
            scheduler=self.fleet_sched.name, num_chips=self.cfg.num_chips,
            oom=False, n_requests=len(self.trace),
            n_finished=int(agg["finished"]), n_request_oom=len(oom_ids),
            slo_attainment=agg["slo"],
            goodput=agg["on_time"] / max(trace_end, 1e-9),
            mean_latency=agg["mean_s"], p95_latency=agg["p95_s"],
            per_pipeline=per_pipeline,
            engine_stats={pid: lane.engine_stats()
                          for pid, lane in self.lanes.items()},
            repartitions=self.repartition_log,
            swap_cost_s=self.swap_cost_s, units_reloaded=self.units_reloaded,
            sched_wakeups=self.sched_wakeups,
            prewarm_units=self.prewarm_units,
            prewarm_cost_s=round(self.prewarm_cost_s, 3),
            prewarm_hits=self.prewarm_hits,
            prewarm_loan_returns=self.prewarm_loan_returns,
            predictive_repartitions=getattr(self.fleet_sched, "early_fires",
                                            0),
            cross_lane_merges=self._xl.merges if self._xl else 0,
            cross_lane_merged_requests=(self._xl.merged_requests
                                        if self._xl else 0),
            **lend_kw, **elastic_kw)


# ---------------------------------------------------------------- convenience

def run_fleet(pipelines: Sequence[str], mode: str = "adaptive",
              duration: float = 600.0, cfg: Optional[FleetConfig] = None,
              seed: int = 0, rates: Optional[Dict[str, float]] = None,
              phases: Optional[Sequence] = None, level: str = "medium",
              trace: Optional[Sequence[Request]] = None,
              registry: Optional[PipelineRegistry] = None,
              fixed_budgets: Optional[Dict[str, int]] = None,
              hw: Hardware = H100_SXM) -> FleetResult:
    """Build registry (on ``hw``) + heterogeneous trace + fleet scheduler
    and run."""
    cfg = cfg or FleetConfig(seed=seed)
    registry = registry or PipelineRegistry(pipelines, hw=hw)
    if trace is None:
        profs = {pid: registry.profiler(pid) for pid in registry.pipelines}
        trace = workloads.fleet_trace(pipelines, duration, profs, seed=seed,
                                      rates=rates, phases=phases, level=level)
    orch = FleetOrchestrator(registry, num_chips=cfg.num_chips,
                             chips_per_node=cfg.chips_per_node)
    sched = FLEET_SCHEDULERS[mode](orch, cfg, fixed_budgets=fixed_budgets)
    return FleetSimulator(registry, sched, trace, cfg).run()
