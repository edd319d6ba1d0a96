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
  ``new_arrivals`` / ``fail_request_oom``).
* ``Scheduler`` / ``PendingSet`` — the scheduler interface and the
  O(1)-removal pending queue.

Counterpart of ``repro/core/clock.py`` for one pipeline: the fleet's merged
completion events, the lending and elastic fields of ``Lane`` and the
array-backed lane state are not ported yet.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from repro_torch.core.monitor import Monitor
from repro_torch.core.request import Request
from repro_torch.core.runtime import RuntimeEngine

# A wake source answers: "earliest future time you could change state?"
# (None = never / not currently armed).  Sources are consulted after every
# scheduler step; the kernel jumps the clock to the earliest answer.
WakeSource = Callable[[float], Optional[float]]

# stage-completion event:
#   (finish, seq, lane, stage, placement type, duration, batch members)
# — the whole batch rides along so a simulator can count every finished
# request, not one per dispatch decision.  Heap order never reaches the
# members: (finish, seq) is already unique.
Completion = Tuple[float, int, str, str, str, float, Tuple[Request, ...]]


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
                        members: Tuple[Request, ...]) -> None:
        heapq.heappush(self.completions,
                       (finish, self._eseq, lane, stage, ptype, duration,
                        members))
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
    """

    __slots__ = ("_by_rid",)

    def __init__(self):
        self._by_rid: Dict[int, Request] = {}

    def add(self, req: Request) -> None:
        self._by_rid[req.rid] = req

    def remove(self, req: Request) -> None:
        del self._by_rid[req.rid]

    def has_rid(self, rid: int) -> bool:
        return rid in self._by_rid

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

    def __init__(self, pipeline: str, prof, scheduler: Scheduler):
        self.pipeline = pipeline
        self.prof = prof
        self.sched = scheduler
        self.monitor = Monitor()
        self.pending = PendingSet()
        self.new_arrivals: List[Request] = []  # admitted since the last step
        self.engine: Optional[RuntimeEngine] = None
        self.request_oom: List[Request] = []
        self.vr_histogram: Dict[int, int] = {}
        self.throughput: Dict[int, int] = {}
        self.placement_log: List[Tuple[float, Dict[str, int]]] = []

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

    # -- dispatch bookkeeping -------------------------------------------------

    def record(self, dec, times: Dict[str, Tuple[float, float]],
               clock: EventClock) -> None:
        """Push one decision's stage completions onto the kernel heap and
        update the lane's result accounting."""
        members = (dec.request,) + tuple(dec.corequests)
        for s, (start, fin) in times.items():
            for req in members:
                req.stage_done[s] = fin
            su = (dec.d_units if s == "D" else
                  dec.e_units if s == "E" else dec.c_units)
            ptype = self.engine.plan.placements[su[0]]
            clock.push_completion(fin, self.pipeline, s, ptype, fin - start,
                                  members)
        self.vr_histogram[dec.vr_type] = (self.vr_histogram.get(dec.vr_type, 0)
                                          + len(members))

    def on_completion(self, t: float, stage: str, ptype: str,
                      duration: float) -> None:
        """Feed one drained completion event into this lane's Monitor."""
        self.monitor.record_stage(t, stage, ptype, duration)
        if stage == "C":
            self.throughput[int(t // 60)] = (
                self.throughput.get(int(t // 60), 0) + 1)

    def step(self, tau: float, clock: EventClock,
             apply_replacement: Callable[..., None]) -> None:
        """One scheduler step for this lane: placement-switch check, then
        dispatch, then each decision's engine timing, completion events and
        pending-queue removal, in order.  ``apply_replacement(new_plan,
        tau)`` is the simulator's way a fresh plan reaches the engine."""
        new_plan = self.sched.maybe_replace(self, tau)
        if new_plan is not None:
            apply_replacement(new_plan, tau)
            self.placement_log.append((tau, new_plan.type_histogram()))
        for dec in self.sched.tick(self, tau):
            times = self.engine.execute(dec, tau)
            self.record(dec, times, clock)
            self.pending.remove(dec.request)
            for co in dec.corequests:
                self.pending.remove(co)


def replace_capable(scheduler: Scheduler) -> bool:
    """Monitor-window boundary wake-ups only matter to schedulers that can
    actually re-place — the simulator skips registering the source otherwise."""
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
