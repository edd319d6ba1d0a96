"""Scheduler-agnostic event-clock kernel + the Lane serving abstraction.

* ``EventClock`` — the kernel: the stage-completion event heap, tick-grid
  quantization, the ``max_idle_gap`` heartbeat with its profile-guided
  adaptive widening (deadline/aging-flip tracking), and a plug-in list of
  *wake sources*.  Two clock modes share one per-step body: ``tick`` (the
  fixed-step reference loop, O(horizon/tick)) and ``event`` (wake only when
  state can change, O(events); wake-ups are quantized *up* to the tick grid
  so on traces where the skipped ticks are no-ops the two modes are
  bit-identical).
* ``WakeSource`` — a callable ``tau -> Optional[float]`` returning the
  earliest future time its subsystem can change state: arrivals,
  Monitor-window boundaries (including the opt-in idle-window wake-ups),
  and schedulers' own trigger crossings (``Scheduler.next_wake``, behind
  the opt-in ``scheduler_wake_hooks`` flag).
* ``ClockDriver`` — the protocol a simulator implements to ride the
  kernel: ``advance`` (admit arrivals, drain completions, run one
  scheduler step), ``done``, ``heartbeat_pending``, ``still_pending``.
* ``Lane`` — one pipeline's serving stack (scheduler + engine + Monitor +
  pending queue + result bookkeeping), with exactly the attribute surface
  schedulers are written against (``pending`` / ``engine`` / ``monitor`` /
  ``new_arrivals`` / ``fail_request_oom``).  ``Simulator`` is a one-lane
  subclass; ``FleetSimulator`` (core/fleet.py) holds one Lane per served
  pipeline and drives the same kernel, registering its own wake sources
  (fleet demand windows, the predictive scheduler's forecast events).
* ``Scheduler`` / ``PendingSet`` — the scheduler interface and the
  O(1)-removal pending queue.

Counterpart of ``repro/core/clock.py``.  ``Lane`` carries the hooks of
unit lending (its borrowed units and their stage-run ledger) and of elastic
capacity (draining units, unit tracking on completion events, ``requeue``);
``EventClock.remove_completions`` revokes in-flight work.  ``array_state``
backs a lane's ``PendingSet`` and ``Monitor`` with flat columns.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.monitor import Monitor
from repro_torch.core.request import Request
from repro_torch.core.runtime import EngineStats, RuntimeEngine

# A wake source answers: "earliest future time you could change state?"
# (None = never / not currently armed).  Sources are consulted after every
# scheduler step; the kernel jumps the clock to the earliest answer.
WakeSource = Callable[[float], Optional[float]]

# stage-completion event:
#   (finish, seq, lane, stage, placement type, duration, batch members,
#    units)
# — the whole batch rides along so a simulator can count every finished
# request, not one per dispatch decision.  ``units`` holds the (pipeline,
# unit) pairs the stage runs on, filled only while a fault injector is live
# (``Lane.track_units``; core/elastic.py), else ().  Heap order never
# reaches the members: (finish, seq) is already unique.
Completion = Tuple[float, int, str, str, str, float, Tuple[Request, ...],
                   Tuple[Tuple[str, int], ...]]

# Merged completion events (fleet cross-lane batching): a fused stage run
# spanning several lanes is pushed ONCE with this sentinel in the lane
# field.  Member contract: ``members`` holds every request of every fused
# decision (corequests included), sorted by (pipeline, rid) — so a simulator
# draining the event can (a) route ``on_completion`` once per participating
# lane (the sorted-unique pipelines of the members) and (b) count per-
# request SLO finishes via each member's own ``pipeline``, in an order
# independent of PYTHONHASHSEED.  The single-pipeline Simulator never sees
# the sentinel.  Fault revocation (core/elastic.py) re-pushes a merged event
# with its revoked members filtered out.
MERGED_LANE = "*merged*"


@dataclasses.dataclass
class ClockConfig:
    """Kernel knobs, distilled from SimConfig by the simulator."""
    tick: float = 0.25                # quantization grid (s)
    horizon: float = 0.0              # last grid point the loop may visit
    mode: str = "event"               # "event" (O(events)) | "tick"
    max_idle_gap: float = 1.0         # max clock jump while work is pending
    adaptive_idle_gap: bool = False   # profile-guided heartbeat widening
    idle_gap_max: float = 16.0        # ceiling for the adaptive gap (s)


class ClockDriver:
    """What a simulator implements to be driven by ``EventClock.run``."""

    def advance(self, tau: float) -> None:
        """One scheduler step at ``tau``: admit arrivals, drain completion
        events, re-place/dispatch.  The kernel never looks inside."""
        raise NotImplementedError

    def done(self) -> bool:
        """True when no arrival, pending request, or in-flight event
        remains — the clock can stop before the horizon."""
        raise NotImplementedError

    def heartbeat_pending(self) -> bool:
        """True while dispatch rewards/aging depend on the passage of time
        (requests are queued) — keeps the ``max_idle_gap`` heartbeat armed."""
        raise NotImplementedError

    def still_pending(self, lane: str, rid: int) -> bool:
        """Is request ``rid`` of ``lane`` still queued?  Consulted when the
        adaptive heartbeat drains tracked deadlines (aging flips)."""
        raise NotImplementedError


class EventClock:
    """The kernel: event heap + wake sources + one while-loop, two modes.

    The simulator owns *what* happens at a wake-up (``ClockDriver.advance``);
    the kernel owns *when* wake-ups happen: the next stage completion from
    its heap, the earliest answer among the registered wake sources, and —
    only while the simulator reports pending work — a ``max_idle_gap``
    heartbeat whose gap doubles while no tracked deadline is crossed
    (profile-guided ``adaptive_idle_gap``) and resets when one is.  Every
    wake-up is quantized up to the tick grid, so dispatch timestamps land
    exactly where the tick loop would have placed them.
    """

    def __init__(self, cfg: ClockConfig):
        self.cfg = cfg
        self.completions: List[Completion] = []   # stage-completion heap
        self._eseq = 0
        self.sources: List[WakeSource] = []
        self.wakeups = 0                  # scheduler steps taken
        # adaptive heartbeat: tracked deadlines of pending requests, drained
        # as the clock passes them to observe aging flips
        self._deadlines: List[Tuple[float, str, int]] = []

    # -- event heap ------------------------------------------------------------

    def push_completion(self, finish: float, lane: str, stage: str,
                        ptype: str, duration: float,
                        members: Tuple[Request, ...],
                        units: Tuple[Tuple[str, int], ...] = ()) -> None:
        heapq.heappush(self.completions,
                       (finish, self._eseq, lane, stage, ptype, duration,
                        members, units))
        self._eseq += 1

    def pop_due(self, tau: float) -> Sequence[Completion]:
        """Remove and return the completion events with ``finish <= tau``
        in (finish, push-order) order.  Early-exits allocation-free on the
        common no-events-due case — this sits on the per-wakeup hot path
        of the tick loop (O(horizon/tick) wake-ups)."""
        heap = self.completions
        if not heap or heap[0][0] > tau:
            return ()
        out = []
        pop = heapq.heappop
        while heap and heap[0][0] <= tau:
            out.append(pop(heap))
        return out

    def remove_completions(self, pred: Callable[[Completion], bool]
                           ) -> List[Completion]:
        """Remove and return every in-flight event matching ``pred``: the
        fault injector's revocation primitive (core/elastic.py), which
        pulls work off units about to vanish so its requests can be
        requeued.  The removed events come back sorted by (finish, seq)
        (seq is unique, so the sort never compares requests)."""
        removed = [ev for ev in self.completions if pred(ev)]
        if not removed:
            return removed
        self.completions = [ev for ev in self.completions if not pred(ev)]
        heapq.heapify(self.completions)
        removed.sort(key=lambda ev: (ev[0], ev[1]))
        return removed

    # -- wake sources ----------------------------------------------------------

    def add_source(self, source: WakeSource) -> None:
        self.sources.append(source)

    # -- adaptive heartbeat ----------------------------------------------------

    def track_deadline(self, deadline: float, lane: str, rid: int) -> None:
        heapq.heappush(self._deadlines, (deadline, lane, rid))

    def _aging_flips(self, tau: float, sim: ClockDriver) -> int:
        """Tracked deadlines crossed up to ``tau`` among still-pending
        requests — the events that change dispatch rewards while nothing
        else moves.  No flips -> the heartbeat gap doubles; a flip -> it
        resets to its base."""
        flips = 0
        heap = self._deadlines
        while heap and heap[0][0] <= tau:
            _, lane, rid = heapq.heappop(heap)
            if sim.still_pending(lane, rid):
                flips += 1
        return flips

    # -- the one loop ----------------------------------------------------------

    def run(self, sim: ClockDriver) -> None:
        cfg = self.cfg
        tick = cfg.tick
        horizon = cfg.horizon
        if cfg.mode == "tick":
            # fixed-step reference: every grid point is a wake-up
            i = 0
            while i * tick <= horizon:
                self.wakeups += 1
                sim.advance(i * tick)
                if sim.done():
                    break
                i += 1
            return
        gap_base = max(cfg.max_idle_gap, tick)
        gap_max = max(cfg.idle_gap_max, gap_base)
        gap = gap_base
        i = 0
        while i * tick <= horizon:
            tau = i * tick
            self.wakeups += 1
            sim.advance(tau)
            if sim.done():
                break
            if cfg.adaptive_idle_gap:
                gap = (gap_base if self._aging_flips(tau, sim)
                       else min(gap * 2.0, gap_max))
            t_next = math.inf
            if self.completions:
                t_next = self.completions[0][0]
            for source in self.sources:
                wake = source(tau)
                if wake is not None and wake < t_next:
                    t_next = wake
            if sim.heartbeat_pending():
                t_next = min(t_next, tau + gap)
            if t_next is math.inf:
                break   # nothing can ever change state again
            # quantize up to the tick grid; always advance at least one tick
            i = max(i + 1, int(math.ceil(t_next / tick - 1e-9)))


class PendingSet:
    """Arrival-ordered, rid-indexed set of pending requests.

    Backed by an insertion-ordered dict so dispatch bookkeeping is O(1) per
    removal instead of O(n) ``list.remove`` scans; iteration yields requests
    in arrival (admission) order.

    ``array_state=True`` also keeps a flat float64 deadline column aligned
    with an admission-ordered slot list (tombstoned on removal, compacted
    when the dead outnumber the live), so the dispatch path's deadline
    order comes from one stable argsort (``by_deadline``) instead of a key
    sort over the requests.  Deadlines are fixed at trace build time, so the
    snapshot taken on ``add`` never goes stale, and a stable argsort over
    the admission-ordered column gives exactly
    ``sorted(self, key=lambda r: r.deadline)``: ties keep admission order.
    """

    __slots__ = ("_by_rid", "_arr", "_req", "_dl", "_slot", "_dead")

    def __init__(self, array_state: bool = False):
        self._by_rid: Dict[int, Request] = {}
        self._arr = bool(array_state)
        if self._arr:
            self._req: List[Optional[Request]] = []
            self._dl = np.empty(64, dtype=np.float64)
            self._slot: Dict[int, int] = {}
            self._dead = 0

    def add(self, req: Request) -> None:
        if self._arr:
            slot = self._slot.get(req.rid)
            if slot is not None:      # re-add keeps the dict's original slot
                self._req[slot] = req
                self._dl[slot] = req.deadline
            else:
                n = len(self._req)
                if n == self._dl.shape[0]:
                    if self._dead * 2 > n:
                        self._compact()
                        n = len(self._req)
                    else:
                        dl = np.empty(max(64, 2 * n), dtype=np.float64)
                        dl[:n] = self._dl[:n]
                        self._dl = dl
                self._req.append(req)
                self._dl[n] = req.deadline
                self._slot[req.rid] = n
        self._by_rid[req.rid] = req

    def _compact(self) -> None:
        reqs = [r for r in self._req if r is not None]
        self._req = reqs
        n = len(reqs)
        dl = np.empty(max(64, 2 * n), dtype=np.float64)
        for i, r in enumerate(reqs):
            dl[i] = r.deadline
        self._dl = dl
        self._slot = {r.rid: i for i, r in enumerate(reqs)}
        self._dead = 0

    def _drop_slot(self, rid: int) -> None:
        slot = self._slot.pop(rid, None)
        if slot is not None:
            self._req[slot] = None
            self._dead += 1
            if self._dead > len(self._by_rid):
                self._compact()

    def by_deadline(self, cap: Optional[int] = None) -> List[Request]:
        """Pending requests in (deadline, admission) order: the dispatch
        path's sort, one argsort when array-backed."""
        if not self._arr:
            out = sorted(self._by_rid.values(), key=lambda r: r.deadline)  # detlint: ignore[DET004] rid-dict is admission-ordered: stable ties are deterministic (and what the array path reproduces)
            return out if cap is None else out[:cap]
        n = len(self._req)
        reqs = self._req
        if self._dead:
            idx = np.fromiter((i for i in range(n) if reqs[i] is not None),
                              dtype=np.int64, count=n - self._dead)
            order = idx[np.argsort(self._dl[idx], kind="stable")]
        else:
            order = np.argsort(self._dl[:n], kind="stable")
        if cap is not None:
            # full stable sort then truncate: sorted()[:cap]
            order = order[:cap]
        return [reqs[i] for i in order]

    def remove(self, req: Request) -> None:
        del self._by_rid[req.rid]
        if self._arr:
            self._drop_slot(req.rid)

    def discard(self, req: Request) -> None:
        if self._by_rid.pop(req.rid, None) is not None and self._arr:
            self._drop_slot(req.rid)

    def has_rid(self, rid: int) -> bool:
        return rid in self._by_rid

    def __contains__(self, req: Request) -> bool:
        return req.rid in self._by_rid

    def __iter__(self) -> Iterator[Request]:
        return iter(self._by_rid.values())

    def __len__(self) -> int:
        return len(self._by_rid)

    def __bool__(self) -> bool:
        return bool(self._by_rid)


class Scheduler:
    """Interface implemented by TridentServe and the B1-B6 baselines.

    A scheduler is also an *event-source plug-in*: ``next_wake`` may
    return the earliest future time one of its trigger conditions can
    newly fire (a pattern-change cooldown expiring, a warm-up window
    ending) so the event clock visits the crossing instead of sleeping
    through it.  Default ``None`` — and the simulator only registers the
    hook behind the opt-in ``scheduler_wake_hooks`` flag, because extra
    wake-ups (even no-op ones) change heartbeat phase.
    """

    name = "base"
    solver_time = 0.0   # wall seconds in the dispatch solver (trident's ILP)

    def __init__(self, prof, sim_cfg, trace: Sequence[Request]):
        self.prof = prof
        self.sim_cfg = sim_cfg
        self.trace = trace

    def initial_placement(self):
        raise NotImplementedError

    def tick(self, sim, tau: float):
        raise NotImplementedError

    def maybe_replace(self, sim, tau: float):
        return None

    def next_wake(self, sim, tau: float) -> Optional[float]:
        return None


class Lane:
    """One pipeline's serving stack: scheduler + engine + Monitor + queue.

    Exposes the attribute surface schedulers expect from a simulator
    (``pending`` / ``engine`` / ``monitor`` / ``new_arrivals`` /
    ``fail_request_oom``), plus the result bookkeeping.  ``Simulator`` *is*
    a one-lane subclass.
    """

    def __init__(self, pipeline: str, prof, scheduler: Scheduler,
                 array_state: bool = False):
        self.pipeline = pipeline
        self.prof = prof
        self.sched = scheduler
        self.monitor = Monitor(array_state=array_state)
        self.pending = PendingSet(array_state=array_state)
        self.new_arrivals: List[Request] = []  # admitted since the last step
        self.engine: Optional[RuntimeEngine] = None
        self.request_oom: List[Request] = []
        self.vr_histogram: Dict[int, int] = {}
        self.degree_histogram: Dict[int, int] = {}   # requests by D degree (units)
        self.throughput: Dict[int, int] = {}
        self.placement_log: List[Tuple[float, Dict[str, int]]] = []
        self._stats_base = EngineStats()   # stats of retired engines
        # unit lending (core/lending.py): borrowed foreign E/C units by
        # hosted stage, and how many stage runs landed on them.  base_units
        # is the engine's own plan size; loan slots live above it.  The
        # fleet sets track_borrowed while a broker is live.
        self.borrowed_units: Dict[str, Tuple[int, ...]] = {}
        self.borrowed_stage_runs: Dict[str, int] = {}
        self.base_units: int = 0
        self.track_borrowed: bool = False
        # elastic capacity (core/elastic.py), set by the fleet while a fault
        # injector is live: completion events carry the (pipeline, unit)
        # pairs they run on, so revocation can match them
        self.track_units: bool = False
        # stage-aware drain: unit id -> loss time while a preemption notice
        # is live; the dispatcher hands a draining unit only work that
        # finishes before then
        self.draining_units: Dict[int, float] = {}

    # -- queue ----------------------------------------------------------------

    def fail_request_oom(self, req: Request) -> None:
        self.request_oom.append(req)

    def admit(self, req: Request, clock: Optional[EventClock] = None) -> None:
        """Admit one arrival; with ``clock`` given, also track its deadline
        for the adaptive heartbeat's aging-flip observation."""
        self.pending.add(req)
        self.new_arrivals.append(req)
        if clock is not None:
            clock.track_deadline(req.deadline, self.pipeline, req.rid)

    def requeue(self, req: Request,
                clock: Optional[EventClock] = None) -> None:
        """Re-admit a request whose dispatched stage events were revoked
        (core/elastic.py) under its original arrival and deadline, so the
        SLO keeps charging the original clock, without counting it as a
        new arrival."""
        self.pending.add(req)
        if clock is not None:
            clock.track_deadline(req.deadline, self.pipeline, req.rid)

    # -- dispatch bookkeeping -------------------------------------------------

    def record(self, dec, times: Dict[str, Tuple[float, float]],
               clock: EventClock) -> None:
        """Push one decision's stage completions onto the kernel heap and
        update the lane's result accounting.

        Stages in ``dec.xl_skip`` (cross-lane fused runs) still stamp
        ``stage_done`` for the batch members, but push no per-lane event —
        the fleet batcher already pushed ONE merged event (``MERGED_LANE``)
        for the whole fused launch — and count no borrowed-unit runs here:
        the fused launch's borrowed run is charged to its *host* lane."""
        members = (dec.request,) + tuple(dec.corequests)
        skip = getattr(dec, "xl_skip", ())
        for s, (start, fin) in times.items():
            for req in members:
                req.stage_done[s] = fin
            if s in skip:
                continue
            su = (dec.d_units if s == "D" else
                  dec.e_units if s == "E" else dec.c_units)
            ptype = self.engine.plan.placements[su[0]]
            clock.push_completion(fin, self.pipeline, s, ptype, fin - start,
                                  members,
                                  tuple((self.pipeline, g) for g in su)
                                  if self.track_units else ())
        self.vr_histogram[dec.vr_type] = (self.vr_histogram.get(dec.vr_type, 0)
                                          + len(members))
        self.degree_histogram[dec.degree] = (
            self.degree_histogram.get(dec.degree, 0) + len(members))
        if self.track_borrowed:
            # lending's invariant: Diffuse never lands on a borrowed unit.
            # D is counted, not only asserted, so the result's
            # diffuse_runs_on_borrowed_units can trip a check under -O too
            for s, units in (("E", dec.e_units), ("D", dec.d_units),
                             ("C", dec.c_units)):
                if s in skip:
                    continue
                if any(g >= self.base_units for g in units):
                    self.borrowed_stage_runs[s] = \
                        self.borrowed_stage_runs.get(s, 0) + 1
            assert "D" not in self.borrowed_stage_runs, \
                "diffuse dispatched to a borrowed foreign unit"

    def on_completion(self, t: float, stage: str, ptype: str,
                      duration: float) -> None:
        """Feed one drained completion event into this lane's Monitor."""
        self.monitor.record_stage(t, stage, ptype, duration)
        if stage == "C":
            self.throughput[int(t // 60)] = (
                self.throughput.get(int(t // 60), 0) + 1)

    def decide(self, tau: float,
               apply_replacement: Callable[..., None]) -> Sequence:
        """Placement-switch check + one scheduler tick; returns the
        decisions *without* executing them.  The fleet's cross-lane batcher
        rides this split: every lane decides first, the batcher plans fused
        stage runs across the decisions, then each lane executes
        (``execute_decisions``).  Lanes own disjoint engines, so deciding
        all lanes before executing any is equivalent to the interleaved
        ``step`` — which remains the plain composition of the two."""
        new_plan = self.sched.maybe_replace(self, tau)
        if new_plan is not None:
            apply_replacement(new_plan, tau)
            self.placement_log.append((tau, new_plan.type_histogram()))
        return self.sched.tick(self, tau)

    def execute_decisions(self, decisions: Sequence, tau: float,
                          clock: EventClock) -> None:
        """Execute a tick's decisions in order: engine timing, completion
        events, pending-queue removal.

        Decisions marked ``xl_hold`` (cross-lane batching's E-hold: the
        auxiliary encode unit is backlogged) execute only if the fleet
        batcher fused them this tick (``xl_efused``); otherwise they are
        skipped entirely — nothing is reserved and the request stays in
        the pending pool for a later tick's fusion or native dispatch."""
        for dec in decisions:
            if getattr(dec, "xl_hold", False) and \
                    getattr(dec, "xl_efused", None) is None:
                continue
            times = self.engine.execute(dec, tau)
            self.record(dec, times, clock)
            self.pending.remove(dec.request)
            for co in dec.corequests:
                self.pending.remove(co)

    def step(self, tau: float, clock: EventClock,
             apply_replacement: Callable[..., None]) -> None:
        """One scheduler step for this lane: placement-switch check, then
        dispatch.  ``apply_replacement(new_plan, tau)`` is the caller's way
        a fresh plan reaches the engine (the fleet also updates the cluster
        plan)."""
        self.execute_decisions(self.decide(tau, apply_replacement), tau,
                               clock)

    # -- engine-stats banking (survives fleet re-partitions) -------------------

    def bank_engine_stats(self) -> None:
        """Fold the outgoing engine's counters into the lane total before a
        re-partition replaces it."""
        if self.engine is None:
            return
        for f in dataclasses.fields(EngineStats):
            setattr(self._stats_base, f.name,
                    getattr(self._stats_base, f.name)
                    + getattr(self.engine.stats, f.name))

    def engine_stats(self) -> Dict[str, float]:
        total = dataclasses.asdict(self._stats_base)
        if self.engine is not None:
            for k, v in dataclasses.asdict(self.engine.stats).items():
                total[k] += v
        return total


def replace_capable(scheduler: Scheduler) -> bool:
    """Monitor-window boundary wake-ups only matter to schedulers that can
    actually re-place — the simulators skip registering the source otherwise."""
    return type(scheduler).maybe_replace is not Scheduler.maybe_replace


def monitor_boundary_source(monitor: Monitor, armed: Callable[[], bool]
                            ) -> WakeSource:
    """Wake source for a Monitor's sliding-window boundaries: the earliest
    future time a retained sample exits the window (windowed rates — and
    the placement-switch trigger — can only change there or at an event).
    ``armed`` gates it: by default boundaries matter only while work is
    pending or in flight; the opt-in idle-window wake-ups keep it armed
    across idle gaps (the stale-window fix)."""
    def source(tau: float) -> Optional[float]:
        if not armed():
            return None
        boundary = monitor.next_window_boundary()
        if boundary is not None and boundary > tau:
            return boundary
        return None
    return source
