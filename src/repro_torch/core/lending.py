"""Cross-pipeline unit lending (fleet layer, between re-partitions).

Fleet sub-plans are hard range-partitioned (core/fleet.py): until the next
re-partition, a backlogged pipeline cannot touch a neighbour's idle chips
even when both sit on the same cluster.  Re-partitioning is the right tool
for *sustained* mix shifts — it moves whole node-quantized budgets and pays
full weight reloads — but bursts shorter than the hysteresis/cooldown
window strand exactly the capacity GENSERVE-style co-serving recovers.

The ``LendingBroker`` fills that gap with *loans*: an idle unit owned by
pipeline A temporarily hosts **E/C (encode / vae-decode) stage work** for a
backlogged pipeline B.  Hard invariants:

* **Diffuse never moves.**  A borrowed unit enters B's plan as an ⟨E⟩ or
  ⟨C⟩ auxiliary; it can never carry a primary (D) placement, so B's diffuse
  placement — and the ILP's primary budget columns — are untouched.
* **Reloads are charged.**  A loan pays the borrower's weight-reload
  latency when granted and the lender's when returned (both via
  ``RuntimeEngine.seed_unit_state``, the same entry point re-partition
  swaps are charged through).
* **Min-hold beats thrash.**  A loan is held at least ``lend_min_hold``
  seconds, so flapping between borrow and return can never out-compete the
  re-partition path on reload cost.

Matching runs on ``FleetMonitor``'s lending windows (per-pipeline backlog
pressure and idle-unit supply over ``lend_win`` seconds) against the fleet
plan's per-node ``lending_map``: aux-class (⟨E⟩/⟨C⟩) units are the
preferred stock, primary-class units are tapped only while the lender keeps
``lend_reserve`` idle units of its own.  With ``FleetConfig.lending=False``
(the default) the broker is never constructed and every touched code path
is bit-identical to the lending-free fleet.

Wake sources and trigger gates (the clock.py standard): the fleet simulator
registers the broker's ``next_wake`` — the earliest loan min-hold expiry
and the next lending-window boundary — and lending forces
``idle_window_wakeups`` on (a loan must be returnable during an idle gap
the heartbeat would otherwise widen past).  The trigger gate lives in
``step``: a wake-up only makes the broker *look*; the pressure/supply
thresholds (``lend_min_pressure``, idle-window-clean supply,
``lend_min_stage_s`` — stage runs shorter than that gate never justify a
reload round-trip) and the min-hold decide whether a loan actually moves.

Counterpart of ``repro/core/lending.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, TYPE_CHECKING, Tuple

if TYPE_CHECKING:   # import cycle: fleet.py builds the broker
    from repro_torch.core.clock import Lane
    from repro_torch.core.fleet import FleetSimulator

# synthetic node-id space for borrowed units inside a borrower engine:
# disjoint from any plan-local node id, so locality modelling treats pushes
# to a borrowed unit as inter-node traffic (the data really does cross the
# partition boundary)
FOREIGN_NODE_BASE = 1_000_000


@dataclasses.dataclass
class Loan:
    """One active loan: lender unit ``lender_uid`` hosts ``ptype`` work for
    ``borrower`` through slot ``slot`` of the borrower's engine.

    No return-cost snapshot is kept: a lane re-placement may retype the
    lender's unit while it is on loan, so ``_close`` always recomputes the
    return reload from the lender's *live* plan — one source of truth."""
    lender: str
    lender_uid: int
    borrower: str
    slot: int
    ptype: str                   # "E" | "C"
    start: float
    borrow_cost: float
    # a force-return arrived while the borrowed slot hosted an un-drained
    # cross-lane fused launch (MERGED_LANE event in flight): the close is
    # deferred to the merge drain — ``step`` retries it on every wake-up
    force_return_pending: bool = False


class LendingBroker:
    def __init__(self, cfg, registry):
        self.cfg = cfg
        self.reg = registry
        self.active: List[Loan] = []
        self._free_slots: Dict[str, List[int]] = {}
        self._map_plan = None          # lending-map cache key (plan identity)
        self._map = None
        # accounting (surfaced through FleetResult)
        self.loans_granted = 0
        self.borrowed_unit_seconds = 0.0
        self.swap_cost_s = 0.0
        self.reloads = 0
        self.forced_returns = 0        # re-partition force-closed loans
        self.loans_by_pair: Dict[Tuple[str, str], int] = {}

    # ---------------------------------------------------------------- helpers

    def _lend_map(self, fleet: "FleetSimulator"):
        if self._map is None or self._map_plan is not fleet.plan:
            self._map = fleet.plan.lending_map(self.reg)
            self._map_plan = fleet.plan
        return self._map

    @staticmethod
    def _idle_active_units(lane: "Lane", tau: float) -> List[int]:
        """Idle, still-active, non-borrowed units of one lane.  Units
        decommissioned by the fault injector (draining ahead of a
        preemption, or quarantined as degraded) are never lendable stock —
        their chips are about to vanish or are suspect."""
        plan = lane.engine.plan
        return [g for g in lane.engine.idle_units(tau)
                if g < lane.base_units and plan.is_active(g)
                and not plan.is_decommissioned(g)]

    def _loans_of(self, pid: str, role: str = "borrower") -> List[Loan]:
        key = "borrower" if role == "borrower" else "lender"
        return [ln for ln in self.active if getattr(ln, key) == pid]

    def has_lent(self, pid: str) -> bool:
        return any(ln.lender == pid for ln in self.active)

    def _sync_borrowed(self, fleet: "FleetSimulator", pid: str) -> None:
        lane = fleet.lanes[pid]
        by_stage: Dict[str, Tuple[int, ...]] = {}
        for ln in self._loans_of(pid):
            by_stage[ln.ptype] = by_stage.get(ln.ptype, ()) + (ln.slot,)
        lane.borrowed_units = by_stage

    # ---------------------------------------------------------------- grants

    def _want_loans(self, pressure: float) -> int:
        """Loan target: ``lend_demand_frac`` units per second of backlog
        pressure (queued chip-seconds per chip), capped."""
        return min(self.cfg.lend_max_loans,
                   int(math.ceil(pressure * self.cfg.lend_demand_frac)))

    def _stage_worth(self, lane: "Lane", stage: str) -> float:
        """Typical per-request time of ``stage`` at its optimal degree over
        the borrower's queued work — the payload a borrowed unit would
        actually host.  Millisecond stages can never amortize the reloads."""
        prof = lane.prof
        sample = [r for _, r in zip(range(16), lane.pending)]
        if not sample:
            return 0.0
        tot = 0.0
        for r in sample:
            k = prof.optimal_degree(r, stage) * prof.k_min
            tot += prof.stage_time(r, stage, k)
        return tot / len(sample)

    def _pick_ptype(self, lane: "Lane") -> str:
        """Hosted-stage heuristic: ⟨E⟩ only when the borrower's plan has
        E-needing primaries (⟨DC⟩/⟨D⟩) and no native ⟨E⟩ auxiliaries at all;
        Decode is otherwise always the stage worth offloading (it dwarfs
        Encode on every profiled pipeline)."""
        plan = lane.engine.plan
        needs_e = bool(plan.units_of_type("DC") or plan.units_of_type("D"))
        has_e = bool(plan.units_of_type("E"))
        if needs_e and not has_e and not lane.borrowed_units.get("E"):
            return "E"
        return "C"

    def _grant(self, fleet: "FleetSimulator", tau: float, borrower: str,
               lu, stage: str) -> None:
        lender_lane = fleet.lanes[lu.pipeline]
        borrower_lane = fleet.lanes[borrower]
        cost = lu.borrow_cost[(borrower, stage)]
        lender_lane.engine.plan.set_active(lu.unit, False)
        node = FOREIGN_NODE_BASE + lu.node
        slots = self._free_slots.get(borrower)
        if slots:
            slot = slots.pop()
            borrower_lane.engine.revive_loan_unit(slot, stage, node,
                                                  tau + cost)
        else:
            slot = borrower_lane.engine.add_loan_unit(stage, node, tau + cost)
        self.active.append(Loan(
            lender=lu.pipeline, lender_uid=lu.unit, borrower=borrower,
            slot=slot, ptype=stage, start=tau, borrow_cost=cost))
        self.loans_granted += 1
        pair = (lu.pipeline, borrower)
        self.loans_by_pair[pair] = self.loans_by_pair.get(pair, 0) + 1
        self.swap_cost_s += cost
        self.reloads += 1
        self._sync_borrowed(fleet, borrower)
        # the lender unit's chips now host borrower weights: any staged
        # pre-warm marks there are physically overwritten (a stale
        # mark would under-charge the next re-partition's reload)
        fleet._evict_prewarm_unit(lu.pipeline, lu.unit)
        fleet.mark_lane_dirty(lu.pipeline)
        fleet.mark_lane_dirty(borrower)

    # ---------------------------------------------------------------- returns

    def _close(self, fleet: "FleetSimulator", loan: Loan, tau: float) -> None:
        """Return one loan: the borrower's slot goes inactive, the lender's
        unit comes back after its weight reload.  The reload covers the
        unit's *current* placement type — a lane re-placement may have
        retyped it since the loan was struck, so the grant-time snapshot in
        ``loan.return_cost`` would be stale."""
        borrower_lane = fleet.lanes[loan.borrower]
        lender_lane = fleet.lanes[loan.lender]
        slot_free = borrower_lane.engine.units[loan.slot].free_at
        t_free = max(tau, slot_free)
        borrower_lane.engine.plan.set_active(loan.slot, False)
        self._free_slots.setdefault(loan.borrower, []).append(loan.slot)
        prof = lender_lane.prof
        ret_cost = sum(prof.stage_load_time(s, via_host=True)
                       for s in lender_lane.engine.plan.placements[
                           loan.lender_uid])
        lender_lane.engine.plan.set_active(loan.lender_uid, True)
        lender_lane.engine.seed_unit_state(
            {loan.lender_uid: t_free + ret_cost})
        self.borrowed_unit_seconds += t_free - loan.start
        self.swap_cost_s += ret_cost
        self.reloads += 1
        self.active.remove(loan)
        self._sync_borrowed(fleet, loan.borrower)
        fleet.mark_lane_dirty(loan.lender)
        fleet.mark_lane_dirty(loan.borrower)

    def release_all(self, fleet: "FleetSimulator", tau: float) -> None:
        """Force-return every loan (called right before a re-partition —
        the whole pool is about to change hands anyway).  Forced closes may
        legitimately cut a loan short of its min-hold."""
        self.forced_returns += len(self.active)
        for loan in list(self.active):
            self._close(fleet, loan, tau)

    @staticmethod
    def _fused_inflight(fleet: "FleetSimulator", loan: Loan,
                        tau: float) -> bool:
        """Does the borrowed slot host an un-drained cross-lane fused
        launch?  Closing the loan mid-flight would hand the lender chips
        that are still executing another lane's merged batch."""
        xl = fleet._xl
        return xl is not None and xl.fused_busy(loan.borrower, loan.slot,
                                                tau)

    def unit_on_loan(self, lender: str, uid: int) -> bool:
        return any(ln.lender == lender and ln.lender_uid == uid
                   for ln in self.active)

    def force_return_unit(self, fleet: "FleetSimulator", lender: str,
                          uid: int, tau: float, hard: bool = False) -> bool:
        """Force-close the loan (if any) riding on one lender unit.  The
        predictive pre-warm path (core/fleet.py) must reclaim a lent-out
        unit before staging the next partition's weights on its chips — a
        loan must never survive a cutover, and staging under a live loan
        would double-book the chips; the fault injector reclaims doomed
        lender units the same way when a preemption notice lands.  Counted
        like re-partition forced returns (min-hold does not apply; the
        usual return reload is charged by ``_close``).

        Guard: when the borrowed slot hosts an un-drained ``MERGED_LANE``
        fused launch, the close is *deferred* (``force_return_pending``) —
        ``step`` closes it at the merge drain.  ``hard=True`` skips the
        guard (re-partition semantics: the engines are about to be
        rebuilt anyway).  Returns True when a loan was closed now."""
        for loan in list(self.active):
            if loan.lender == lender and loan.lender_uid == uid:
                if not hard and self._fused_inflight(fleet, loan, tau):
                    loan.force_return_pending = True
                    return False
                self.forced_returns += 1
                self._close(fleet, loan, tau)
                return True
        return False

    def reset_after_repartition(self, fleet: "FleetSimulator") -> None:
        """Engines were rebuilt from a fresh plan: loan slots are gone."""
        assert not self.active, "loans must be released before re-partition"
        self._free_slots.clear()
        self._map = None
        self._map_plan = None
        for lane in fleet.lanes.values():
            lane.borrowed_units = {}

    def reattach(self, lane: "Lane", new_plan) -> None:
        """A lane-level placement switch replaced this lane's sub-plan:
        re-append its loan slots (uid-aligned) so the engine's
        ``apply_placement`` sees a consistent unit count, keep lent-out
        base units deactivated in the fresh plan (their chips are serving
        another pipeline — reactivating them would double-book), and drop
        the cached lending map (unit types/costs may have changed)."""
        old_plan = lane.engine.plan
        for uid in range(lane.base_units, len(lane.engine.units)):
            new_uid = new_plan.extend(lane.engine.units[uid].placement)
            assert new_uid == uid
            if not old_plan.is_active(uid):
                new_plan.set_active(uid, False)
        for loan in self.active:
            if loan.lender == lane.pipeline:
                new_plan.set_active(loan.lender_uid, False)
        self._map = None
        self._map_plan = None

    def finalize(self, tau: float) -> None:
        """End-of-run accounting for still-open loans (no return charge —
        the simulation is over, nothing runs after)."""
        for loan in self.active:
            self.borrowed_unit_seconds += max(0.0, tau - loan.start)

    # ---------------------------------------------------------------- step

    def next_wake(self, tau: float) -> Optional[float]:
        """Earliest future borrow/return event the clock must visit: the
        next min-hold expiry, else the next lend-window re-check while any
        loan is outstanding.  Registered by the fleet simulator as a wake
        source on the event-clock kernel (``core/clock.py``), so loans are
        granted/returned for any lane count without loop plumbing."""
        if not self.active:
            return None
        expiries = [ln.start + self.cfg.lend_min_hold for ln in self.active
                    if ln.start + self.cfg.lend_min_hold > tau]
        nxt = tau + self.cfg.lend_win
        if expiries:
            nxt = min(nxt, min(expiries))
        return nxt

    def sample(self, fleet: "FleetSimulator", tau: float) -> None:
        """Record one pressure sample per lane into the Monitor's lending
        windows: queued chip-seconds per owned chip — the fleet's footprint
        currency, so pipelines of very different request rates compare
        fairly.  Called *after* the dispatch loop: what is still pending
        then is genuine backlog, not the batch that just arrived."""
        from repro_torch.core.fleet import request_footprint
        for pid, lane in fleet.lanes.items():
            chips = max(1, lane.base_units * lane.engine.plan.unit_size)
            queued = sum(request_footprint(lane.prof, r)
                         for r in lane.pending)
            fleet.fleet_monitor.record_util(
                tau, pid, queued / chips,
                len(self._idle_active_units(lane, tau)))

    def _lend_budgets(self, fleet: "FleetSimulator", tau: float
                      ) -> Dict[str, int]:
        """How many units each pipeline can have out on loan right now: its
        own windowed-mean busy units are grossed up to ``lend_util_target``
        utilization (a lender never lends itself hot), plus an absolute
        ``lend_reserve`` floor."""
        cfg = self.cfg
        supply = fleet.fleet_monitor.idle_supply(tau)
        lent = {}
        for ln in self.active:
            lent[ln.lender] = lent.get(ln.lender, 0) + 1
        budgets: Dict[str, int] = {}
        for pid, lane in fleet.lanes.items():
            active_now = lane.base_units - lent.get(pid, 0)
            busy_mean = max(0.0, active_now - supply.get(pid, 0.0))
            keep = int(math.ceil(busy_mean / cfg.lend_util_target))
            budgets[pid] = max(0, lane.base_units - keep - cfg.lend_reserve)
        return budgets

    def step(self, fleet: "FleetSimulator", tau: float) -> None:
        cfg = self.cfg
        # 1. deferred force-returns: close as soon as the fused launch that
        #    pinned the borrowed slot has drained (its completion event is
        #    itself a wake-up, so the close is never missed)
        for loan in list(self.active):
            if loan.force_return_pending \
                    and not self._fused_inflight(fleet, loan, tau):
                self.forced_returns += 1
                self._close(fleet, loan, tau)
        pressure = fleet.fleet_monitor.backlog_pressure(tau)
        budgets = self._lend_budgets(fleet, tau)
        lent_count: Dict[str, int] = {}
        for ln in self.active:
            lent_count[ln.lender] = lent_count.get(ln.lender, 0) + 1

        # 2. returns, as soon as the slot is idle:
        #    * reclaim — the lender is over its lending budget (its own
        #      load came back): min-hold does NOT apply.  The hold exists
        #      so borrow/return thrash can't beat the re-partition path on
        #      reload cost, but a hot lender's demand justifies the extra
        #      reload — and a hot lender won't re-lend, so no thrash loop;
        #    * drained — the borrower's burst is over: respects min-hold.
        over = {pid: n - budgets.get(pid, 0)
                for pid, n in lent_count.items() if n > budgets.get(pid, 0)}
        for loan in list(self.active):
            drained = pressure.get(loan.borrower, 0.0) < cfg.lend_low_pressure
            reclaim = over.get(loan.lender, 0) > 0
            if not reclaim and (tau - loan.start < cfg.lend_min_hold
                                or not drained):
                continue
            lane = fleet.lanes[loan.borrower]
            if lane.engine.units[loan.slot].free_at > tau:
                continue   # mid-flight work: return at a later wake-up
            if over.get(loan.lender, 0) > 0:
                over[loan.lender] -= 1
            lent_count[loan.lender] -= 1
            self._close(fleet, loan, tau)

        # 3. grants: most-pressured borrower first, aux-class stock first,
        #    cheapest reload first.  A pipeline with units lent out is never
        #    also a borrower (and vice versa) — reciprocal lending would
        #    just shuttle reload costs back and forth.
        lending_out = {ln.lender for ln in self.active}
        borrowing = {ln.borrower for ln in self.active}
        borrowers = sorted(  # detlint: ignore[DET004] equal-pressure ties keep lane registry order
            (pid for pid, lane in fleet.lanes.items()
             if pressure.get(pid, 0.0) >= cfg.lend_min_pressure
             and lane.pending and pid not in lending_out),
            key=lambda p: -pressure.get(p, 0.0))
        if not borrowers:
            return
        lend_map = self._lend_map(fleet)
        on_loan = {(ln.lender, ln.lender_uid) for ln in self.active}
        idle_by_pid = {pid: set(self._idle_active_units(lane, tau))
                       for pid, lane in fleet.lanes.items()}
        for pid in borrowers:
            have = len(self._loans_of(pid))
            want = self._want_loans(pressure[pid])
            if have >= want:
                continue
            lane = fleet.lanes[pid]
            stage = self._pick_ptype(lane)
            if self._stage_worth(lane, stage) < cfg.lend_min_stage_s:
                continue   # reloads can never pay for millisecond stages
            cands = []
            for node_units in lend_map.values():
                for lu in node_units:
                    if lu.pipeline == pid or (pid, stage) not in lu.borrow_cost:
                        continue
                    if (lu.pipeline, lu.unit) in on_loan:
                        continue
                    if lu.pipeline in borrowing:
                        continue   # an active borrower never lends
                    if pressure.get(lu.pipeline, 0.0) >= cfg.lend_low_pressure:
                        continue   # lender is backlogged itself
                    if budgets.get(lu.pipeline, 0) \
                            <= lent_count.get(lu.pipeline, 0):
                        continue   # lender has no surplus beyond its target
                    idle = idle_by_pid[lu.pipeline]
                    if lu.unit not in idle:
                        continue
                    cands.append(lu)
            cands.sort(key=lambda lu: (not lu.aux_class,
                                       lu.borrow_cost[(pid, stage)]))
            for lu in cands:
                if have >= want:
                    break
                if budgets.get(lu.pipeline, 0) \
                        <= lent_count.get(lu.pipeline, 0):
                    continue
                self._grant(fleet, tau, pid, lu, stage)
                on_loan.add((lu.pipeline, lu.unit))
                idle_by_pid[lu.pipeline].discard(lu.unit)
                lent_count[lu.pipeline] = lent_count.get(lu.pipeline, 0) + 1
                have += 1
