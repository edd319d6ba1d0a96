"""Runtime Engine (§5): executes placement and dispatch plans.

Implements the paper's three-step dispatch execution on NVIDIA GPUs:

* **Dynamic Reinstance** — a stage run on a set of GPUs needs an NCCL
  communicator over them.  The *hot set* (single units and contiguous
  intra-node groups of size 2/4/8) is built ahead and costs nothing at
  dispatch; other combinations pay a one-time lazy build
  (``Hardware.comm_group_init``) and are cached — the O(ms) behavior and
  bounded-memory goal of §5.2.
* **Stage Preparation** — proactive push into per-unit handoff buffers
  (bounded by Cap_hb; overflow falls back to the pinned-host path), two-step
  locality-aware transfer (inter-node link to one member, then intra-node
  broadcast), and Adjust-on-Dispatch replica loading (intra-node peer copy
  if any node peer hosts the stage, else host staging).
* **Merging Execute** — consecutive stage plans of one request on an
  identical unit set run as one atomic reservation, eliminating the
  per-dispatch CPU overhead.

The engine is backend-agnostic, and one caller runs it: the discrete-event
simulator (``core/simulator.py``), with the profiler's latencies in place of
stage executions.  ``launch/serve.py`` and ``launch/serve_pipeline.py`` go
through it; nothing runs it with real stage executions on the clock.

Counterpart of ``repro/core/runtime.py``, with the fleet's hooks (unit
seeding on a re-partition, predictive pre-warm, cross-lane fused stages):
the hooks of unit lending (loan units) and of elastic capacity (unit
slowdowns) wait for those modules.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Sequence, Set, Tuple

from repro_torch.core.dispatcher import DispatchDecision
from repro_torch.core.placement import PlacementPlan
from repro_torch.core.profiler import Profiler

CAP_HB = 1 * 2 ** 30          # handoff-buffer capacity per unit (bytes)


@dataclasses.dataclass
class Unit:
    uid: int
    node: int
    placement: str               # metadata placement (may lead residency)
    resident: Set[str]           # stages actually loaded
    free_at: float = 0.0
    hb_staged: float = 0.0       # staged handoff bytes (drained at launch)


@dataclasses.dataclass
class EngineStats:
    dispatches: int = 0
    merged_runs: int = 0
    lazy_group_inits: int = 0
    adjust_loads: int = 0
    adjust_load_time: float = 0.0
    host_path_pushes: int = 0
    device_pushes: int = 0
    transfer_time: float = 0.0
    placement_switches: int = 0
    downtime: float = 0.0
    prewarm_loads: int = 0
    prewarm_load_time: float = 0.0
    # dispatch ILP solutions reused across wake-ups without a re-solve: the
    # reference's incremental ILP, which waits for the array-backed slice,
    # sets it; here it reads 0
    ilp_reuses: int = 0


class RuntimeEngine:
    def __init__(self, profiler: Profiler, plan: PlacementPlan, *,
                 proactive_push: bool = True, adjust_on_dispatch: bool = True):
        self.prof = profiler
        self.plan = plan
        self.proactive_push = proactive_push
        self.adjust_on_dispatch = adjust_on_dispatch
        self.units: List[Unit] = [
            Unit(uid=g, node=plan.node_of(g), placement=p, resident=set(p))
            for g, p in enumerate(plan.placements)]
        self._groups: Set[frozenset] = set()
        self.stats = EngineStats()
        # idle tracking: busy units sit in a (free_at, uid) heap and migrate
        # back to the idle set lazily as the clock passes their release time
        # — idle_units() is then O(released) instead of O(units) per wake-up.
        # Stale heap entries (unit re-reserved meanwhile) are dropped on pop.
        self._idle: Set[int] = {u.uid for u in self.units}
        self._busy_heap: List[Tuple[float, int]] = []
        # mirror of every unit's free_at, maintained at the (few) mutation
        # sites so ``free_at()`` is O(1) instead of an O(units) dict build
        # on every dispatch round
        self._free_map: Dict[int, float] = {u.uid: u.free_at
                                            for u in self.units}

    # ------------------------------------------------------------------ state

    def _mark_busy(self, uid: int, until: float) -> None:
        self._idle.discard(uid)
        heapq.heappush(self._busy_heap, (until, uid))

    def idle_units(self, tau: float) -> Set[int]:
        """Units idle at ``tau``.  Returns the engine's *live* idle set —
        treat it as read-only and consume it before the next engine
        mutation (every scheduler fetches it fresh per wake-up)."""
        heap = self._busy_heap
        while heap and heap[0][0] <= tau:
            _, uid = heapq.heappop(heap)
            if self.units[uid].free_at <= tau:   # else: re-reserved since
                self._idle.add(uid)
        return self._idle

    def free_at(self) -> Dict[int, float]:
        """Live ``{uid: free_at}`` view (same read-only contract as
        ``idle_units``)."""
        return self._free_map

    def seed_unit_state(self, busy_until: Dict[int, float]) -> None:
        """Pre-busy freshly built units (fleet re-partition, core/fleet.py):
        a unit inherits the in-flight work of the chips it now owns plus the
        weight-reload latency charged when its pipeline or placement type
        changed hands."""
        for uid, t in busy_until.items():
            u = self.units[uid]
            if t > u.free_at:
                u.free_at = t
                self._free_map[uid] = t
            if u.free_at > 0.0:
                self._mark_busy(uid, u.free_at)

    def stage_prewarm(self, uid: int, tau: float, load_time: float) -> float:
        """Predictive pre-warm (core/fleet.py): stage a *future* partition's
        weights on a unit that keeps serving its current pipeline until the
        cutover.  The staging DMA occupies the unit like a reload (charged
        through ``seed_unit_state``, the same entry point re-partition
        swaps pay), but the unit stays in its engine and remains
        dispatchable afterwards — the load overlaps the tail of the old
        mix instead of charging downtime at the re-partition.  Returns the
        time the unit is busy until."""
        u = self.units[uid]
        until = max(tau, u.free_at) + load_time
        self.seed_unit_state({uid: until})
        self.stats.prewarm_loads += 1
        self.stats.prewarm_load_time += load_time
        return until

    # ----------------------------------------------------------- placement plan

    def apply_placement(self, new_plan: PlacementPlan, tau: float,
                        downtime_adjust: bool = False) -> float:
        """Switch placements.  Adjust-on-Dispatch: metadata flips now, replica
        movement deferred to the next dispatch needing it.  The naive
        ``downtime_adjust`` baseline (Fig. 13) halts the cluster while every
        replica change is applied synchronously."""
        assert new_plan.num_units == self.plan.num_units
        self.stats.placement_switches += 1
        cost = 0.0
        if downtime_adjust or not self.adjust_on_dispatch:
            for u, new_p in zip(self.units, new_plan.placements):
                # sorted: str-set iteration order is hash-seed dependent
                # and float accumulation is order-sensitive
                for s in sorted(set(new_p) - u.resident):
                    cost += self.prof.stage_load_time(s, via_host=True)
                u.resident = set(new_p)
            barrier = max([tau] + [u.free_at for u in self.units]) + cost
            for u in self.units:
                u.free_at = barrier
                self._free_map[u.uid] = barrier
                self._mark_busy(u.uid, barrier)
            self.stats.downtime += cost
        for u, new_p in zip(self.units, new_plan.placements):
            u.placement = new_p
        self.plan = new_plan
        return cost

    # ------------------------------------------------------------ internals

    def _reinstance(self, unit_ids: Tuple[int, ...]) -> float:
        """Dynamic Reinstance cost: 0 for the hot set / cached combos."""
        key = frozenset(unit_ids)
        if key in self._groups:
            return 0.0
        nodes = {self.units[g].node for g in unit_ids}
        k = len(unit_ids)
        contiguous = (max(unit_ids) - min(unit_ids) + 1) == k
        hot = len(nodes) == 1 and k in (1, 2, 4, 8) and contiguous
        self._groups.add(key)
        if hot:
            return 0.0
        self.stats.lazy_group_inits += 1
        return self.prof.hw.comm_group_init

    def _prepare_stage(self, stage: str, unit_ids: Tuple[int, ...],
                       tau: float) -> float:
        """Adjust-on-Dispatch replica load if the stage is not yet resident."""
        cost = 0.0
        for g in unit_ids:
            u = self.units[g]
            if stage in u.resident:
                continue
            peer = any(self.units[o].uid != g and self.units[o].node == u.node
                       and stage in self.units[o].resident
                       for o in range(len(self.units)))
            t = self.prof.stage_load_time(stage, via_host=not peer)
            cost = max(cost, t)      # loads proceed in parallel across units
            u.resident.add(stage)
            self.stats.adjust_loads += 1
            self.stats.adjust_load_time += t
        return cost

    def _push(self, nbytes: float, src: Tuple[int, ...], dst: Tuple[int, ...],
              pred_finish: float) -> float:
        """Proactive push of inter-stage tensors; returns data-ready time.

        Two-step locality-aware: inter-node to one destination member, then
        intra-node broadcast.  HB overflow falls back to the host path."""
        if set(src) == set(dst):
            return pred_finish
        src_nodes = {self.units[g].node for g in src}
        dst_nodes = {self.units[g].node for g in dst}
        intra = bool(src_nodes & dst_nodes)
        du = self.units[dst[0]]
        if du.hb_staged + nbytes <= CAP_HB:
            du.hb_staged += nbytes           # drained when the stage launches
            t = self.prof.transfer_time(nbytes, intra_node=intra)
            if not intra:
                t += self.prof.transfer_time(nbytes, intra_node=True)  # bcast
            self.stats.device_pushes += 1
        else:
            t = nbytes / self.prof.hw.host_bw + 1e-3   # pinned-host overflow path
            self.stats.host_path_pushes += 1
        self.stats.transfer_time += t
        if self.proactive_push:
            return pred_finish + t           # overlaps successor compute
        return pred_finish + t + self.prof.hw.dispatch_overhead

    def _reserve(self, unit_ids: Sequence[int], finish: float):
        fm = self._free_map
        for g in unit_ids:
            u = self.units[g]
            u.free_at = finish
            fm[g] = finish
            u.hb_staged = 0.0
            self._mark_busy(g, finish)

    def push_cross(self, nbytes: float) -> float:
        """Transfer cost of pushing inter-stage tensors to a *foreign*
        engine's units (cross-lane fused stage runs, core/dispatcher.py's
        ``CrossLaneBatcher``): always the two-step inter-node path — lanes
        occupy disjoint chip ranges, so source and destination never share
        a node — with no handoff-buffer staging on the destination (the
        host engine owns that unit's buffer accounting).  Returns the
        added latency; stats are charged to this (the member's) engine,
        mirroring ``_push``."""
        t = (self.prof.transfer_time(nbytes, intra_node=False)
             + self.prof.transfer_time(nbytes, intra_node=True))
        self.stats.device_pushes += 1
        self.stats.transfer_time += t
        if self.proactive_push:
            return t
        return t + self.prof.hw.dispatch_overhead

    # ----------------------------------------------------------- dispatch plans

    def execute(self, dec: DispatchDecision, tau: float) -> Dict[str, Tuple[float, float]]:
        """Execute one request's stage plans; returns {stage: (start, finish)}.

        Timing honors: unit availability, reinstance, Adjust-on-Dispatch
        loads, proactive push, and merging of co-located consecutive stages.

        Cross-lane fused stages (fleet dynamic batching) override parts of
        the plan via decision attributes set by the batcher:

        * ``dec.xl_efused = (start, fin, native, host_units)`` — Encode ran
          (or will run) as one fused launch on the *host* lane's units;
          this engine only models the activation push from those units to
          its own Diffuse set (``_push`` when the host is this engine,
          ``push_cross`` otherwise) and never touches ``dec.e_units``.
        * ``dec.xl_cdefer`` — Decode is fused downstream: release the
          Diffuse units at D-finish and return without a "C" entry; the
          batcher schedules the fused decode from the recorded D-finish.
        """
        req = dec.request
        prof = self.prof
        overhead = prof.hw.dispatch_overhead
        k_chips = dec.degree * prof.k_min
        bs = dec.batch   # App. E.1 dynamic batching
        xl_e = getattr(dec, "xl_efused", None)
        t_d = prof.batched_stage_time(req, "D", k_chips, bs)

        out: Dict[str, Tuple[float, float]] = {}
        units = self.units
        if xl_e is not None:
            e_start, e_fin, native, host_units = xl_e
            out["E"] = (e_start, e_fin)
            nbytes = prof.comm_bytes(req, "ED")
            if native:
                data_ready = self._push(nbytes, host_units, dec.d_units,
                                        e_fin)
            else:
                data_ready = e_fin + self.push_cross(nbytes)
            d_start = max(data_ready,
                          max(units[g].free_at for g in dec.d_units))
            d_start += self._reinstance(dec.d_units)
            d_start += self._prepare_stage("D", dec.d_units, tau)
            d_fin = d_start + t_d
            out["D"] = (d_start, d_fin)
        else:
            t_e = prof.batched_stage_time(
                req, "E", max(1, len(dec.e_units)) * prof.k_min, bs)
            merged_ed = tuple(dec.e_units) == tuple(dec.d_units)

            # --- E -----------------------------------------------------------
            e_ready = tau
            for g in dec.e_units:
                t = units[g].free_at
                if t > e_ready:
                    e_ready = t
            e_ready += self._reinstance(dec.e_units)
            e_ready += self._prepare_stage("E", dec.e_units, tau)
            if merged_ed:
                # merging execute: E+D single atomic run (one dispatch overhead)
                d_ready = e_ready
                for g in dec.d_units:
                    t = units[g].free_at
                    if t > d_ready:
                        d_ready = t
                d_ready += self._reinstance(dec.d_units)
                d_ready += self._prepare_stage("D", dec.d_units, tau)
                start = d_ready
                e_fin = start + t_e
                d_fin = e_fin + t_d - overhead  # merged: one overhead
                self.stats.merged_runs += 1
                out["E"] = (start, e_fin)
                out["D"] = (e_fin, d_fin)
            else:
                e_fin = e_ready + t_e
                out["E"] = (e_ready, e_fin)
                self._reserve(dec.e_units, e_fin)
                data_ready = self._push(prof.comm_bytes(req, "ED"),
                                        dec.e_units, dec.d_units, e_fin)
                d_start = data_ready
                for g in dec.d_units:
                    t = units[g].free_at
                    if t > d_start:
                        d_start = t
                d_start += self._reinstance(dec.d_units)
                d_start += self._prepare_stage("D", dec.d_units, tau)
                d_fin = d_start + t_d
                out["D"] = (d_start, d_fin)

        if getattr(dec, "xl_cdefer", False):
            # fused decode downstream: hold the Diffuse units through D only
            self._reserve(dec.d_units, d_fin)
            self.stats.dispatches += 1 if xl_e is not None else 2
            return out

        # --- C ---------------------------------------------------------------
        t_c = prof.batched_stage_time(req, "C",
                                      max(1, len(dec.c_units)) * prof.k_min, bs)
        if set(dec.c_units) <= set(dec.d_units):
            # merging execute: D+C on D's units (one dispatch overhead)
            c_start = d_fin
            c_fin = c_start + t_c - overhead
            self.stats.merged_runs += 1
            self._prepare_stage("C", dec.c_units, tau)
            out["C"] = (c_start, c_fin)
            self._reserve(dec.d_units, c_fin)
        else:
            self._reserve(dec.d_units, d_fin)
            data_ready = self._push(prof.comm_bytes(req, "DC"),
                                    dec.d_units, dec.c_units, d_fin)
            c_start = data_ready
            for g in dec.c_units:
                t = units[g].free_at
                if t > c_start:
                    c_start = t
            c_start += self._reinstance(dec.c_units)
            c_start += self._prepare_stage("C", dec.c_units, tau)
            c_fin = c_start + t_c
            out["C"] = (c_start, c_fin)
            self._reserve(dec.c_units, c_fin)

        self.stats.dispatches += 2 if xl_e is not None else 3
        return out
