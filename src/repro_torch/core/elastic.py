"""Elastic, failure-prone capacity: the fault-injection wake source.

TridentServe's stage-level paradigm assumes a fixed, immortal chip pool.
A large deployment lives on elastic, failure-prone capacity — autoscale-up,
spot preemption with an eviction notice, slow-failing hardware — so the
scheduler must treat capacity itself as a dynamic input.  The event-clock kernel
(``core/clock.py``) makes that one plug-in: the ``FaultInjector`` is a
deterministic, seeded schedule of **capacity events** registered as one
more wake source, so faults land at exact grid points both clock modes
visit and every trajectory reproduces byte-for-byte.

Event kinds (``CapacityEvent.kind``):

* ``"join"`` — autoscale-up: ``n_nodes`` fresh nodes land at ``t`` and
  the logical chip space grows at the top.  With a ``lead`` (the
  announce window) and ``FleetConfig.elastic_prewarm`` on, the notice at
  ``t - lead`` stages the post-join target partition's weights onto the
  incoming chips (``core/forecast.py``, ``stage_announced_capacity``) so
  the join-time re-partition charges no reload for them.
* ``"preempt"`` — spot eviction: ``nodes`` disappear at ``t``.  The
  notice at ``t - lead`` is the eviction warning; with
  ``FleetConfig.elastic_drain`` on the fleet **drains, stage-aware**:
  doomed units stay in service but only accept launches that finish
  before the land (``Dispatcher.dispatch``'s ``draining`` filter — work
  the loss would kill is exactly the work a drain must refuse, and
  nothing else), loans riding doomed lender units are force-returned
  (deferred past an un-drained fused launch — the guard in
  ``LendingBroker.force_return_unit``), and in-flight stage work that
  would outlive the loss is revoked and requeued immediately, giving
  the surviving pool the whole lead window to re-serve it.  At the loss
  itself everything still in flight on the doomed units is requeued
  (the drain-unaware arm pays this for *all* of it), the chip space is
  compacted (higher chips shift down; ``chip_map``), and the fleet
  re-partitions sized to the surviving pool.
* ``"degrade"`` / ``"recover"`` — slow-failing units: every unit on the
  named nodes takes ``factor``x its profiled stage time
  (``RuntimeEngine.set_unit_slowdown``).  The injector's
  ``DegradeDetector`` watches drained stage completions (per-unit mean
  vs the placement-class pool mean) and **quarantines** a detected unit
  (``decommission`` — dispatch routes around it) once the evidence
  clears ``degrade_detect_ratio`` at ``degrade_min_samples``.

Requeue contract: a dispatched request's stage completions are all
pushed at decision time, so revoking it means removing every one of its
events from the kernel heap (``EventClock.remove_completions``),
clearing its ``stage_done`` stamps, and re-admitting it to its lane's
pending pool under the **original** arrival and deadline — the SLO
accounting keeps charging the original clock, which is exactly the
recovery latency the elastic scenario measures
(``launch/serve_fleet.py --scenario elastic``).  Innocent members of
a fused ``MERGED_LANE`` event keep their completion: the event is
re-pushed with the victims filtered out.  Reservations already charged
on surviving units for revoked work are deliberately left in place — a
conservative, deterministic model of work that cannot be un-launched.

Determinism: the schedule is expanded once into a sorted phase list;
victim sets and requeue walks iterate in sorted ``(pipeline, rid)`` /
``(pipeline, unit)`` order; nothing reads the wall clock or an unseeded
RNG.  With ``FleetConfig.elastic`` (the default: off) the injector is
never constructed and every touched code path behaves as without it.

Counterpart of ``repro/core/elastic.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple, TYPE_CHECKING

from repro_torch.core.clock import MERGED_LANE

if TYPE_CHECKING:   # import cycle: fleet.py builds the injector
    from repro_torch.core.fleet import FleetSimulator


@dataclasses.dataclass(frozen=True)
class CapacityEvent:
    """One scheduled capacity event.

    ``t`` is the *landing* time (the join/loss/degrade applies there);
    ``lead`` opens the announce window at ``t - lead`` (preemption
    notice, join announcement).  ``nodes`` are logical node ids valid in
    the chip space **at apply time** — the workload generators
    (``core/workloads.py``) track the live node count through their
    own event sequence so the indices always resolve."""
    t: float
    kind: str                          # "join" | "preempt" | "degrade"
                                       # | "recover"
    nodes: Tuple[int, ...] = ()        # victims (preempt/degrade/recover)
    n_nodes: int = 0                   # join size, in nodes
    lead: float = 0.0                  # notice fires at t - lead
    factor: float = 1.0                # degrade slowdown multiplier

    def __post_init__(self):
        assert self.kind in ("join", "preempt", "degrade", "recover")
        assert self.lead >= 0.0


class DegradeDetector:
    """Monitor-side detection of slow-failing units.

    Per drained (non-merged) stage completion, the duration feeds two
    running means keyed by the completion's full *work class* —
    ``(pipeline, stage, placement type, request class, batch size)`` —
    the pool mean across all units and the per-unit mean of every unit
    the stage ran on.  Keying by work class compares like with like: a
    1536-res batch legitimately runs ~10x a 128-res one, so an unkeyed
    pool mean would quarantine every unit the mix happens to hand heavy
    work (the false-positive storm this keying exists to prevent).  A
    unit whose mean exceeds ``ratio`` x its class pool mean — with at
    least ``min_samples`` of its own in that class and a 4x-deeper pool
    — is reported for quarantine.  Fused ``MERGED_LANE`` launches are
    not samples (batched cross-lane durations live on a different
    curve).  Stats reset on re-partition: unit ids remap, and a
    still-degraded node is simply re-detected on the fresh engines."""

    def __init__(self, ratio: float, min_samples: int):
        self.ratio = ratio
        self.min_samples = min_samples
        self._pool: Dict[tuple, List[float]] = {}
        self._unit: Dict[tuple, List[float]] = {}

    def reset(self) -> None:
        self._pool.clear()
        self._unit.clear()

    def sample(self, pid: str, stage: str, ptype: str, dur: float,
               cls: tuple,
               units: Tuple[Tuple[str, int], ...]) -> List[Tuple[str, int]]:
        """Feed one drained completion (``cls`` = request class + batch
        size); returns the units (if any) whose evidence now clears the
        quarantine threshold."""
        key = (pid, stage, ptype, cls)
        pool = self._pool.setdefault(key, [0.0, 0.0])
        pool[0] += 1.0
        pool[1] += dur
        suspects: List[Tuple[str, int]] = []
        deep = pool[0] >= 4.0 * self.min_samples
        for up in units:
            st = self._unit.setdefault((up, key), [0.0, 0.0])
            st[0] += 1.0
            st[1] += dur
            if (deep and st[0] >= self.min_samples
                    and st[1] / st[0] > self.ratio * (pool[1] / pool[0])):
                suspects.append(up)
        return suspects


class FaultInjector:
    """The capacity-event wake source (one per ``FleetSimulator`` when
    ``FleetConfig.elastic`` is on).

    The schedule is expanded into a sorted ``(time, seq, phase, event)``
    list — ``"notice"`` at ``t - lead`` (when a lead exists), ``"land"``
    at ``t`` — fired in order by ``step`` (called at the top of every
    fleet scheduler step) with ``next_wake`` registered on the kernel so
    the clock visits each phase exactly.  Both arms of the elastic
    scenario expand the same phases; the drain/pre-warm *actions* are gated on the config
    flags, so the arms share one wake grid."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.cpn = cfg.chips_per_node
        self.live_chips = cfg.num_chips
        phases: List[Tuple[float, int, str, CapacityEvent]] = []
        seq = 0
        for ev in sorted(cfg.elastic_schedule, key=lambda e: (e.t, e.kind)):
            if ev.kind in ("join", "preempt") and ev.lead > 0.0:
                phases.append((ev.t - ev.lead, seq, "notice", ev))
                seq += 1
            phases.append((ev.t, seq, "land", ev))
            seq += 1
        phases.sort(key=lambda p: (p[0], p[1]))
        self._phases = phases
        self._pi = 0
        self.detector = DegradeDetector(cfg.degrade_detect_ratio,
                                        cfg.degrade_min_samples)
        self.degraded: Dict[int, float] = {}    # live node id -> factor
        self.doomed_nodes: Tuple[int, ...] = () # notice fired, loss pending
        self.doomed_land: float = 0.0           # when the pending loss lands
        self.quarantined: Set[Tuple[str, int]] = set()
        # accounting (surfaced through FleetResult)
        self.capacity_events = 0
        self.nodes_joined = 0
        self.nodes_lost = 0
        self.requeued_requests = 0
        self.drained_units = 0
        self.quarantined_units = 0
        self.elastic_prewarm_chips = 0

    # -- wake source (registered by the fleet simulator) --------------------------

    def next_wake(self, tau: float) -> Optional[float]:
        """Earliest unfired phase time — ``step`` has already consumed
        everything <= tau by the time the kernel consults its sources."""
        i = self._pi
        phases = self._phases
        while i < len(phases) and phases[i][0] <= tau:
            i += 1
        return phases[i][0] if i < len(phases) else None

    # -- per-step hook ---------------------------------------------------------

    def step(self, fleet: "FleetSimulator", tau: float) -> None:
        while self._pi < len(self._phases) \
                and self._phases[self._pi][0] <= tau:
            _, _, phase, ev = self._phases[self._pi]
            self._pi += 1
            if ev.kind == "join":
                if phase == "notice":
                    self._announce_join(fleet, tau, ev)
                else:
                    self._land_join(fleet, tau, ev)
            elif ev.kind == "preempt":
                if phase == "notice":
                    self._notice_preempt(fleet, tau, ev)
                else:
                    self._land_preempt(fleet, tau, ev)
            elif ev.kind == "degrade":
                self._land_degrade(fleet, tau, ev)
            else:
                self._land_recover(fleet, tau, ev)

    # -- chip-space helpers ----------------------------------------------------

    def _chips_of(self, nodes) -> Set[int]:
        cpn = self.cpn
        return {c for n in nodes for c in range(n * cpn, (n + 1) * cpn)}

    def _doomed_pairs(self, fleet: "FleetSimulator",
                      chips: Set[int]) -> Set[Tuple[str, int]]:
        """(pipeline, unit) pairs whose chips intersect ``chips`` — the
        lanes' own units plus borrowed loan slots that physically sit on
        a doomed lender unit."""
        pairs: Set[Tuple[str, int]] = set()
        for pid, lane in fleet.lanes.items():
            lo, _ = fleet.plan.chip_ranges[pid]
            k = fleet.plan.subplans[pid].unit_size
            for g in range(lane.base_units):
                if any(c in chips
                       for c in range(lo + g * k, lo + (g + 1) * k)):
                    pairs.add((pid, g))
        if fleet.broker is not None:
            for loan in fleet.broker.active:
                if (loan.lender, loan.lender_uid) in pairs:
                    pairs.add((loan.borrower, loan.slot))
        return pairs

    # -- join ------------------------------------------------------------------

    def _announce_join(self, fleet: "FleetSimulator", tau: float,
                       ev: CapacityEvent) -> None:
        if not self.cfg.elastic_prewarm:
            return
        from repro_torch.core.forecast import stage_announced_capacity
        n = stage_announced_capacity(
            fleet, tau, self.live_chips + ev.n_nodes * self.cpn, land=ev.t)
        self.elastic_prewarm_chips += n

    def _land_join(self, fleet: "FleetSimulator", tau: float,
                   ev: CapacityEvent) -> None:
        self.live_chips += ev.n_nodes * self.cpn
        self.nodes_joined += ev.n_nodes
        self.capacity_events += 1
        fleet.orch.num_chips = self.live_chips
        # the old chip space is a prefix of the new one: no translation,
        # and any announce-time pre-warm marks on the incoming chips are
        # consumed by this re-partition's reload accounting
        fleet._capacity_repartition(tau, chip_map=None)

    # -- preemption ------------------------------------------------------------

    def _notice_preempt(self, fleet: "FleetSimulator", tau: float,
                        ev: CapacityEvent) -> None:
        self.doomed_nodes = tuple(sorted(ev.nodes))
        self.doomed_land = ev.t
        if not self.cfg.elastic_drain:
            return
        chips = self._chips_of(ev.nodes)
        pairs = self._doomed_pairs(fleet, chips)
        self._drain(fleet, pairs, tau, ev.t)
        # revoke only the in-flight work that would outlive the loss:
        # anything finishing inside the lead window completes naturally
        self.requeued_requests += self._requeue(fleet, pairs, tau,
                                                after=ev.t)

    def _land_preempt(self, fleet: "FleetSimulator", tau: float,
                      ev: CapacityEvent) -> None:
        lost = set(ev.nodes)
        chips = self._chips_of(lost)
        pairs = self._doomed_pairs(fleet, chips)
        # everything still in flight on the doomed units dies with them
        # (the drain-unaware arm pays this for the full lead window's
        # worth of dispatches)
        self.requeued_requests += self._requeue(fleet, pairs, tau)
        # compact the chip space: survivors keep their order, higher
        # chips shift down into the holes
        chip_map: Dict[int, int] = {}
        nxt = 0
        for c in range(self.live_chips):
            if c in chips:
                continue
            chip_map[c] = nxt
            nxt += 1
        self.degraded = {
            n - sum(1 for m in lost if m < n): f  # detlint: ignore[DET001] int count over int set: exact
            for n, f in sorted(self.degraded.items()) if n not in lost}
        self.live_chips -= len(lost) * self.cpn
        self.nodes_lost += len(lost)
        self.capacity_events += 1
        self.doomed_nodes = ()
        self.doomed_land = 0.0
        fleet.orch.num_chips = self.live_chips
        fleet._capacity_repartition(tau, chip_map=chip_map)

    def _drain(self, fleet: "FleetSimulator", pairs: Set[Tuple[str, int]],
               tau: float, land: float) -> None:
        """Stage-aware drain: doomed units stay in service for the rest of
        the notice window but only for launches that *finish before the
        land* (the dispatcher's ``draining`` filter) — short work keeps
        flowing through the doomed capacity while long stages, which would
        be requeued at the loss and re-run from scratch, steer clear.
        Pre-warm marks on doomed units are evicted and loans riding doomed
        lender units are force-returned (deferred past an un-drained fused
        launch)."""
        for pid, g in sorted(pairs):
            lane = fleet.lanes[pid]
            if g >= lane.base_units:
                continue   # loan slots close via the lender's force-return
            if g in lane.draining_units:
                continue
            lane.draining_units[g] = land
            self.drained_units += 1
            fleet._evict_prewarm_unit(pid, g)
            if fleet.broker is not None:
                fleet.broker.force_return_unit(fleet, pid, g, tau)

    # -- requeue ---------------------------------------------------------------

    def _requeue(self, fleet: "FleetSimulator", pairs: Set[Tuple[str, int]],
                 tau: float, after: Optional[float] = None) -> int:
        """Revoke in-flight stage events touching ``pairs`` (only those
        finishing past ``after``, when given) and requeue their requests.
        Removing one stage of a request breaks its whole chain, so every
        other event carrying a victim is removed too; fused MERGED_LANE
        events keep their innocent members via a filtered re-push."""
        clock = fleet.clock
        first = clock.remove_completions(
            lambda ev: (after is None or ev[0] > after)
            and any(u in pairs for u in ev[7]))
        if not first:
            return 0
        victims: Set[Tuple[str, int]] = set()
        reqs: Dict[Tuple[str, int], object] = {}
        for ev in first:
            for r in ev[6]:
                victims.add((r.pipeline, r.rid))
                reqs[(r.pipeline, r.rid)] = r
        while True:
            extra = clock.remove_completions(
                lambda ev: any((r.pipeline, r.rid) in victims
                               for r in ev[6]))
            grew = False
            for ev in extra:
                if ev[2] == MERGED_LANE:
                    keep = tuple(r for r in ev[6]
                                 if (r.pipeline, r.rid) not in victims)
                    if keep:
                        clock.push_completion(ev[0], MERGED_LANE, ev[3],
                                              ev[4], ev[5], keep, ev[7])
                    continue
                for r in ev[6]:
                    k = (r.pipeline, r.rid)
                    if k not in victims:
                        victims.add(k)
                        reqs[k] = r
                        grew = True
            if not grew:
                break
        for pid, rid in sorted(victims):
            r = reqs[(pid, rid)]
            r.stage_done.clear()
            fleet.lanes[pid].requeue(
                r, fleet.clock if fleet._track_flips else None)
        return len(victims)

    # -- degrade / recover -----------------------------------------------------

    def _land_degrade(self, fleet: "FleetSimulator", tau: float,
                      ev: CapacityEvent) -> None:
        for n in ev.nodes:
            self.degraded[n] = ev.factor
        self.capacity_events += 1
        self._apply_degrade(fleet)

    def _land_recover(self, fleet: "FleetSimulator", tau: float,
                      ev: CapacityEvent) -> None:
        for n in ev.nodes:
            self.degraded.pop(n, None)
        self.capacity_events += 1
        self._apply_degrade(fleet)
        # a recovered node's quarantined units rejoin the dispatch indices
        chips = self._chips_of(ev.nodes)
        healed = {p for p in self._doomed_pairs(fleet, chips)
                  if p in self.quarantined}
        for pid, g in sorted(healed):
            fleet.lanes[pid].engine.plan.commission(g)
            self.quarantined.discard((pid, g))

    def _apply_degrade(self, fleet: "FleetSimulator") -> None:
        """Sync every engine's per-unit slowdown to the current degraded
        node map (also re-applied onto fresh engines after every
        re-partition — the slow hardware does not heal when chips change
        hands)."""
        degraded = self.degraded
        cpn = self.cpn
        for pid, lane in fleet.lanes.items():
            lo, _ = fleet.plan.chip_ranges[pid]
            k = fleet.plan.subplans[pid].unit_size
            for g in range(lane.base_units):
                f = 1.0
                for c in range(lo + g * k, lo + (g + 1) * k):
                    nf = degraded.get(c // cpn, 1.0)
                    if nf > f:
                        f = nf
                if lane.engine.units[g].slow != f:
                    lane.engine.set_unit_slowdown(g, f)

    # -- detection feed (fleet._drain) -----------------------------------------

    def observe(self, fleet: "FleetSimulator", pid: str, stage: str,
                ptype: str, dur: float, members, units, tau: float) -> None:
        if pid == MERGED_LANE:
            return   # fused batched durations are not solo-run samples
        m = members[0]
        cls = (m.resolution, m.seconds, m.cond_len, len(members))
        for up in self.detector.sample(pid, stage, ptype, dur, cls, units):
            self._quarantine(fleet, up, tau)

    def _quarantine(self, fleet: "FleetSimulator", up: Tuple[str, int],
                    tau: float) -> None:
        pid, g = up
        if up in self.quarantined:
            return
        lane = fleet.lanes[pid]
        if g >= lane.base_units:
            return   # borrowed slot: the lender's unit is the slow one
        plan = lane.engine.plan
        if not plan.is_active(g) or plan.is_decommissioned(g):
            return
        if not self._covers_without(plan, g, lane.base_units):
            return   # never quarantine a lane below full stage coverage
        plan.decommission(g)
        self.quarantined.add(up)
        self.quarantined_units += 1

    @staticmethod
    def _covers_without(plan, g: int, base_units: int) -> bool:
        for s in ("E", "D", "C"):
            if not any(s in plan.placements[h]
                       for h in range(base_units)
                       if h != g and plan.is_active(h)
                       and not plan.is_decommissioned(h)):
                return False
        return True

    # -- re-partition hook -----------------------------------------------------

    def after_repartition(self, fleet: "FleetSimulator", tau: float) -> None:
        """Engines and sub-plans were rebuilt: re-derive every overlay the
        injector owns.  Detector stats and quarantine marks reset (unit
        ids remapped; still-slow units are re-detected), ground-truth
        slowdowns are re-applied, and — when a loss notice is still
        pending — the doomed chips' fresh units re-enter the drain so a
        mix-shift re-partition inside the notice window cannot hand them
        long work."""
        self.detector.reset()
        self.quarantined.clear()
        for lane in fleet.lanes.values():
            lane.draining_units.clear()   # unit ids were remapped
        self._apply_degrade(fleet)
        if self.doomed_nodes and self.cfg.elastic_drain:
            chips = self._chips_of(self.doomed_nodes)
            self._drain(fleet, self._doomed_pairs(fleet, chips), tau,
                        self.doomed_land)
