"""Resource-Aware Dispatcher (§6.2): the two-step dispatch-plan generator.

Step 1 — solve the per-tick myopic ILP for Γ^D (OBJ, C0–C4) with the
paper's Appendix-C.2 weights: completion reward W_r (SLO-aware, with aging
past the starvation threshold α), communication penalty Q_{r,i} = β_i · l_r.

Step 2 — derive Γ^E and Γ^C from Γ^D: reuse the primary's unit set when the
stage co-resides (E merges with D; C takes a subset of D's units), otherwise
route to an idle/earliest-free auxiliary replica at the profiled optimal
parallelism.

``CrossLaneBatcher`` extends the dispatch step one level up (fleet-level
dynamic batching, ``FleetConfig.cross_lane_batching``): when the fleet's
per-lane dispatchers produce auxiliary E/C stage runs in two or more lanes
whose units share a ``(placement_type, stage)`` shape, the batcher merges
them into ONE batched launch on a single host lane's units.  Member
selection is a grouped ILP with multi-dimensional columns
(``ilp.solve_grouped``), capped by the profiler's batch-latency curve; the
fused run is charged as one merged completion event (``clock.MERGED_LANE``)
whose members span lanes.

Counterpart of ``repro/core/dispatcher.py``, with the hooks of unit
lending (borrowed E/C units as discounted auxiliary candidates, the decode
offload onto them, a fused launch's borrowed run charged to its host lane)
and of elastic capacity (the stage-aware drain of doomed units).  The
incremental re-solve waits for the array-backed slice.
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import ilp
from repro_torch.core.placement import (PRIMARY_PLACEMENTS, PlacementPlan,
                                        primary_of_vr)
from repro_torch.core.profiler import PARALLEL_DEGREES, Profiler
from repro_torch.core.request import DispatchPlan, Request

# Appendix C.2 constants
C_ON = 1000.0
C_LATE = 200.0
ALPHA_STARVE = 5.0
BETAS = {0: 0.0, 1: 1e-6, 2: 5e-6, 3: 6e-6}   # per Virtual-Replica index
EFF_THRESHOLD = 0.8                            # E_{r,k} filter
# Runtime-preference weight: among on-time (i,k) choices the paper's OBJ is
# indifferent, which lets the solver park requests at degree 1 and inflate
# mean latency.  A small per-second penalty (<< C_on - C_late) breaks the
# tie toward faster configs without ever flipping an SLO decision.
GAMMA_TIME = 2.0
# Unit lending: reward discount on options whose auxiliary stage would land
# on a borrowed foreign unit (well below C_LATE, so a borrow never outbids a
# native on-time config, but the solver still prefers native capacity).
BORROW_PENALTY = 25.0


@dataclasses.dataclass
class DispatchDecision:
    request: Request
    vr_type: int                  # chosen Virtual Replica index (0..3)
    degree: int                   # units for the D stage
    d_units: Tuple[int, ...]
    e_units: Tuple[int, ...]
    c_units: Tuple[int, ...]
    # App. E.1 dynamic batching: same-class requests served in this run
    corequests: Tuple[Request, ...] = ()

    @property
    def batch(self) -> int:
        return 1 + len(self.corequests)

    def plans(self) -> Dict[str, DispatchPlan]:
        r = self.request
        return {
            "E": DispatchPlan(r.rid, "E", self.e_units, max(1, len(self.e_units))),
            "D": DispatchPlan(r.rid, "D", self.d_units, self.degree),
            "C": DispatchPlan(r.rid, "C", self.c_units, max(1, len(self.c_units))),
        }


class Dispatcher:
    def __init__(self, profiler: Profiler, max_batch: int = 64,
                 solver_time_cap: float = 0.05, aggregate: bool = False):
        """``aggregate`` turns on multiplicity-aware ILP aggregation:
        pending requests with identical option lists (same class, same
        reward state) enter the solver once with a count instead of N
        times (see ``ilp.solve_grouped``).  Off by default so the
        single-pipeline dispatch path keeps its behavior; the fleet layer
        (core/fleet.py) turns it on."""
        self.prof = profiler
        self.max_batch = max_batch
        self.solver_time_cap = solver_time_cap
        self.aggregate = aggregate
        self.last_solve_stats: Dict[str, float] = {}
        # previous solve's surviving (dim, usage) per request id — warm-starts
        # the ILP incumbent under steady load (requests pending across ticks)
        self._warm: Dict[int, Tuple[int, int]] = {}
        # per-class feasibility cache: (req.key(), cond_len) -> the budget-
        # independent (runtime, vr, k) triples of build_options' nested scan,
        # in scan order.  Pure memoization of profiler-table functions of the
        # request class, byte-identical to the uncached scan.
        self._feas: Dict[tuple, Tuple[Tuple[float, int, int], ...]] = {}

    # -- reward / penalty (App. C.2) ----------------------------------------

    def _w_r(self, req: Request, tau: float, best_finish: float) -> float:
        """App. C.2 completion reward with aging.  The overtime factor is
        measured in *relative* time (how many deadline-windows the request
        is overdue) so escalation is bounded and gradual: a request must be
        α=5 windows late before its C_late reward starts growing — fresh
        on-time requests (C_on) always dominate until then."""
        if best_finish <= req.deadline:
            return C_ON
        window = max(req.deadline - req.arrival, 1e-6)
        scale = max(1.0, (best_finish - req.arrival) / window)
        return C_LATE * max(1.0, scale - ALPHA_STARVE + 1.0)

    def _q_ri(self, req: Request, vr: int) -> float:
        l_r = self.prof.proc_len(req, "D")
        return BETAS[vr] * l_r * C_ON  # scaled to stay orders below W_r

    def _req_runtime(self, req: Request, vr: int, k_units: int) -> float:
        """t_{r,i,k}: runtime of the stages hosted by primary type i at k."""
        prim = primary_of_vr(vr)
        k_chips = k_units * self.prof.k_min
        t = self.prof.stage_time(req, "D", k_chips)
        if "E" in prim:
            t += self.prof.stage_time(req, "E", k_chips)
        if "C" in prim:
            kc = min(k_chips, self.prof.optimal_degree(req, "C") * self.prof.k_min)
            t += self.prof.stage_time(req, "C", kc)
        return t

    # -- ILP construction ------------------------------------------------------

    def _feas_configs(self, req: Request) -> Tuple[Tuple[float, int, int], ...]:
        """Budget-independent feasible (runtime, vr, k) triples for one
        request class, in ``build_options``' scan order (vr outer 0..3, k
        inner over the efficient degrees).  Budgets — the only tau- or
        state-dependent input of the scan — are filtered at use time, so
        the cached triples reproduce the uncached loop bit-for-bit."""
        key = (req.key(), req.cond_len)
        cached = self._feas.get(key)
        if cached is None:
            # E_{r,k}: efficient degrees only (plus degree 1, always
            # allowed); capped at one node's worth of units (intra-machine
            # SP)
            eff_ks = [k for k in PARALLEL_DEGREES
                      if k <= self.prof.max_degree_units
                      and (k == 1 or self.prof.efficiency(
                          req, "D", k * self.prof.k_min) > EFF_THRESHOLD)]
            cached = tuple(
                (self._req_runtime(req, vr, k), vr, k)
                for vr in range(4)
                for k in eff_ks
                if self.prof.fits(req, primary_of_vr(vr), k))   # F_{r,i,k}
            self._feas[key] = cached
        return cached

    # auxiliary stages each Virtual Replica routes off-primary (Table 3)
    _VR_AUX = {0: (), 1: ("E",), 2: ("C",), 3: ("E", "C")}

    def build_options(self, reqs: Sequence[Request], tau: float,
                      idle_by_type: Dict[str, int],
                      aux_penalty: Optional[Dict[str, float]] = None
                      ) -> Tuple[List[List[ilp.Option]], List[int]]:
        budgets = [idle_by_type.get(primary_of_vr(v), 0) for v in range(4)]
        vr_pen = [0.0] * 4
        if aux_penalty:
            # lending: a VR whose auxiliary stage would land on a borrowed
            # foreign unit carries the borrow discount
            vr_pen = [sum(aux_penalty.get(s, 0.0) for s in self._VR_AUX[v])
                      for v in range(4)]
        options: List[List[ilp.Option]] = []
        # per-call class cache: budgets, tau and vr_pen are fixed for the whole
        # call, so the budget-filtered triples, the best/worst predicted
        # finishes, and — for requests every config beats the deadline of —
        # the complete option list are functions of the request *class*
        # alone.  Same-class requests then build their options once;
        # cached option lists are shared (ilp.Option is frozen and no
        # downstream consumer mutates an option list).
        cache: Dict[tuple, list] = {}
        for req in reqs:
            ckey = (req.key(), req.cond_len)
            ent = cache.get(ckey)
            if ent is None:
                # the class feasibility cache holds the budget-independent
                # triples; the budget filter reproduces the original nested
                # scan's order
                filt = [t for t in self._feas_configs(req)
                        if budgets[t[1]] > 0 and t[2] <= budgets[t[1]]]
                best_finish = max_f = None
                for rt, vr, k in filt:
                    f = tau + rt
                    if best_finish is None or f < best_finish:
                        best_finish = f
                    if max_f is None or f > max_f:
                        max_f = f
                ent = cache[ckey] = [filt, best_finish, max_f, None]
            filt, best_finish, max_f = ent[0], ent[1], ent[2]
            if best_finish is None:
                options.append([])
                continue
            deadline = req.deadline
            if max_f <= deadline:
                # every config makes the deadline: W_r = C_on and no option
                # is filtered, so the list is deadline-independent — reuse
                # the class's cached on-time list
                opts = ent[3]
                if opts is None:
                    base: List[Optional[float]] = [None] * 4
                    opts = []
                    for rt, vr, k in filt:
                        f = tau + rt
                        b = base[vr]
                        if b is None:
                            b = base[vr] = (C_ON - self._q_ri(req, vr)
                                            - vr_pen[vr])
                        opts.append(ilp.Option(
                            dim=vr, usage=k,
                            reward=b - GAMMA_TIME * (f - tau)))
                    ent[3] = opts
                options.append(opts)
                continue
            w = self._w_r(req, tau, best_finish)
            # per-VR reward base hoisted out of the option loop; the final
            # subtraction keeps the original left-to-right association so
            # rewards stay bit-identical
            base = [None] * 4
            opts = []
            for rt, vr, k in filt:
                f = tau + rt
                # per C3a: drop configs that blow the deadline unless
                # nothing makes it (then keep the fastest)
                if f <= deadline or f == best_finish:
                    b = base[vr]
                    if b is None:
                        b = base[vr] = w - self._q_ri(req, vr) - vr_pen[vr]
                    opts.append(ilp.Option(
                        dim=vr, usage=k,
                        reward=b - GAMMA_TIME * (f - tau)))
            options.append(opts)
        return options, budgets

    def _solve_grouped(self, reqs: Sequence[Request],
                       options: List[List[ilp.Option]], budgets: List[int]
                       ) -> Tuple[Dict[int, ilp.Option], Dict[str, float]]:
        """Multiplicity-aware solve: requests with identical option lists
        form one group with a count.  Granted copies map back to the
        group's members in deadline order (``reqs`` is deadline-sorted),
        best-reward option first, so the earliest-deadline member gets the
        fastest grant."""
        groups: Dict[Tuple[ilp.Option, ...], int] = {}
        members: List[List[int]] = []
        gopts: List[List[ilp.Option]] = []
        for ri, opts in enumerate(options):
            if not opts:
                continue
            key = tuple(opts)
            g = groups.get(key)
            if g is None:
                g = groups[key] = len(gopts)
                gopts.append(opts)
                members.append([])
            members[g].append(ri)
        warm: Dict[int, List[Tuple[int, int]]] = {}
        for g, mem in enumerate(members):
            seeds = [self._warm[reqs[ri].rid] for ri in mem
                     if reqs[ri].rid in self._warm]
            if seeds:
                warm[g] = seeds
        gsol = ilp.solve_grouped(gopts, budgets,
                                 [len(mem) for mem in members],
                                 time_cap=self.solver_time_cap, warm=warm)
        choices: Dict[int, ilp.Option] = {}
        for g, granted in gsol.alloc.items():
            for ri, opt in zip(members[g], granted):
                choices[ri] = opt
        return choices, {"nodes": gsol.nodes, "optimal": gsol.optimal,
                         "reward": gsol.reward, "n_solved": gsol.n_slots,
                         "n_groups": len(gopts)}

    # -- unit selection ---------------------------------------------------------

    @staticmethod
    def select_units(plan: PlacementPlan, ptype: str, k: int,
                     idle_units: set) -> Optional[Tuple[int, ...]]:
        """k idle units of placement ``ptype`` within one node (intra-machine
        constraint §6.2); contiguous-first for link locality.  The baselines
        and trident's ablations select units through this."""
        upn = plan.units_per_node
        by_node: Dict[int, List[int]] = {}
        for g in plan.units_of_type(ptype):
            if g in idle_units:
                by_node.setdefault(g // upn, []).append(g)
        # node id as total tie-break: insertion is already ascending-node
        # (units_of_type walks unit ids), so this is byte-neutral but makes
        # the equal-count order explicit rather than stability-dependent
        for node, units in sorted(by_node.items(),
                                  key=lambda kv: (-len(kv[1]), kv[0])):
            if len(units) >= k:
                return tuple(sorted(units)[:k])
        return None

    def _aux_units(self, plan: PlacementPlan, stage: str, k: int,
                   idle_units: set, free_at: Dict[int, float], tau: float,
                   borrowed: Optional[set] = None,
                   exclude: Optional[Dict[int, float]] = None
                   ) -> Tuple[int, ...]:
        """Idle-or-earliest-free auxiliary units for E/C (Monitor-reported).

        With loans out (``borrowed``), native units win ties: a borrowed
        unit is taken only when it is strictly the better host.
        ``exclude`` steers auxiliary work off draining units, but only while
        a healthy candidate exists: a lane whose sole auxiliary sits on a
        doomed node keeps serving through it."""
        cands = plan.units_of_type(stage)
        if exclude:
            healthy = [g for g in cands if g not in exclude]
            if healthy:
                cands = healthy
        if not cands:
            return ()
        # nsmallest == sorted(...)[:k] (stable, documented), at O(n) instead
        # of O(n log n) — k is a profiled optimal degree, i.e. tiny, while
        # the candidate list is every auxiliary unit of the stage type
        if borrowed:
            return tuple(heapq.nsmallest(k, cands,
                                         key=lambda g: (g not in idle_units,
                                                        free_at.get(g, tau),
                                                        g in borrowed)))
        return tuple(heapq.nsmallest(k, cands,
                                     key=lambda g: (g not in idle_units,
                                                    free_at.get(g, tau))))

    # -- main entry ---------------------------------------------------------------

    def dispatch(self, pending: Sequence[Request], plan: PlacementPlan,
                 idle_units: set, free_at: Dict[int, float], tau: float,
                 borrowed: Optional[Dict[str, Tuple[int, ...]]] = None,
                 draining: Optional[Dict[int, float]] = None
                 ) -> List[DispatchDecision]:
        """One dispatch round over the pending set.

        ``idle_units`` and ``free_at`` are the caller's *live* views of the
        units: never mutated here — grants consume from a private ``avail``
        copy — and only valid until the caller applies the returned
        decisions.

        ``borrowed`` (unit lending, core/lending.py) holds the lane's
        borrowed foreign units by hosted stage: E/C-only candidates, whose
        options carry the borrow discount, and the pool of the decode
        offload.  ``draining`` maps doomed unit ids to their loss time (a
        preemption notice is live, core/elastic.py): a draining unit hosts
        only a primary launch that finishes before its loss, and auxiliary
        stages avoid it.  ``None`` for both takes the plain path.
        """
        # candidate set scales with idle capacity: a fixed cap would only
        # ever show the solver the oldest (often already-late) requests
        # under high-churn workloads and starve fresh feasible ones
        cap = max(self.max_batch, 2 * len(idle_units))
        reqs = sorted(pending, key=lambda r: r.deadline)[:cap]
        if not reqs:
            return []
        # a draining unit counts toward its type's budget only while its
        # remaining window can still host the *shortest* candidate launch
        # of that type: promise more and the solver grants work that unit
        # selection must refuse; promise less and doomed capacity idles
        budget_idle = idle_units
        if draining:
            min_rt: Dict[str, float] = {}
            seen_cls = set()
            for req in reqs:
                ck = (req.key(), req.cond_len)
                if ck in seen_cls:
                    continue
                seen_cls.add(ck)
                for rt, vr, _k in self._feas_configs(req):
                    t = primary_of_vr(vr)
                    if t not in min_rt or rt < min_rt[t]:
                        min_rt[t] = rt
            inf = float("inf")
            budget_idle = idle_units - {
                g for g, land in draining.items()
                if land - tau < min_rt.get(plan.placements[g], inf)}
        idle_by_type = {t: len(budget_idle & plan.type_set(t))
                        for t in PRIMARY_PLACEMENTS}
        # unit lending: borrowed foreign units are E/C-only candidates; an
        # option whose auxiliary stage would land on one (no idle native
        # auxiliary of that type) carries the borrow discount
        borrowed_all: set = set()
        aux_penalty: Optional[Dict[str, float]] = None
        if borrowed:
            borrowed_all = {g for gs in borrowed.values() for g in gs}
            aux_penalty = {}
            for s in ("E", "C"):
                native_idle = any(g in idle_units and g not in borrowed_all
                                  for g in plan.units_of_type(s))
                lent_idle = any(free_at.get(g, 0.0) <= tau
                                for g in borrowed.get(s, ()))
                if lent_idle and not native_idle:
                    aux_penalty[s] = BORROW_PENALTY
        options, budgets = self.build_options(reqs, tau, idle_by_type,
                                              aux_penalty)
        if self.aggregate:
            choices, stats = self._solve_grouped(reqs, options, budgets)
        else:
            warm = {ri: self._warm[req.rid] for ri, req in enumerate(reqs)
                    if req.rid in self._warm}
            sol = ilp.solve(options, budgets, time_cap=self.solver_time_cap,
                            warm=warm)
            choices = sol.choices
            stats = {"nodes": sol.nodes, "optimal": sol.optimal,
                     "reward": sol.reward, "n_solved": len(reqs)}
        self._warm = {reqs[ri].rid: (opt.dim, opt.usage)
                      for ri, opt in choices.items()}
        self.last_solve_stats = {**stats, "n_reqs": len(reqs)}

        decisions: List[DispatchDecision] = []
        avail = set(idle_units)
        # Maintained unit pools: placement types partition the unit space
        # and only primary grants consume from ``avail``, so each type's
        # by-node map is built once per dispatch round (lazily, from the
        # then-current ``avail``) and maintained across grants instead of
        # walking every unit of the type on each grant.  Selection is
        # ``select_units``': the node with the most idle units of the type,
        # the lowest node id on ties, and its lowest unit ids.
        upn = plan.units_per_node
        pools: Dict[str, Dict[int, List[int]]] = {}
        # lazy max-heap per type over (-count, node): the top valid entry is
        # the max-count node with the smallest node id.  Entries go stale
        # when a node's count changes; they are popped (never trusted) once
        # the stored count mismatches.
        heaps: Dict[str, List[Tuple[int, int]]] = {}

        def _pool(ptype: str) -> Dict[int, List[int]]:
            by_node = pools.get(ptype)
            if by_node is None:
                by_node = pools[ptype] = {}
                for g in plan.units_of_type(ptype):
                    if g in avail:
                        by_node.setdefault(g // upn, []).append(g)
                h = heaps[ptype] = [(-len(u), nd) for nd, u in by_node.items()]
                heapq.heapify(h)
            return by_node

        def _take(ptype: str, k: int) -> Optional[Tuple[int, ...]]:
            by_node = _pool(ptype)
            heap = heaps[ptype]
            best, best_n = None, 0
            while heap:
                neg, node = heap[0]
                if -neg == len(by_node[node]):
                    best, best_n = node, -neg
                    break
                heapq.heappop(heap)   # stale count
            if best_n < k:
                return None
            units = by_node[best]
            out = tuple(units[:k])
            del units[:k]
            heapq.heapreplace(heap, (k - best_n, best))
            return out

        def _give_back(ptype: str, units: Tuple[int, ...]) -> None:
            by_node = _pool(ptype)
            heap = heaps[ptype]
            for g in units:
                node = g // upn
                bisect.insort(by_node[node], g)
                heapq.heappush(heap, (-len(by_node[node]), node))

        # grants in reward order; equal rewards keep the solver's order
        for ri, opt in sorted(choices.items(), key=lambda kv: -kv[1].reward):  # detlint: ignore[DET004] choices is solver-walk-ordered; equal-reward order is BENCH-byte-frozen
            req = reqs[ri]
            prim = primary_of_vr(opt.dim)
            if draining:
                # stage-aware drain: a doomed unit is eligible only when this
                # launch lands before the unit does (plain selection, no
                # pools: only inside a notice window)
                rt = self._req_runtime(req, opt.dim, opt.usage)
                elig = {g for g in avail
                        if g not in draining or tau + rt <= draining[g]}
                units = self.select_units(plan, prim, opt.usage, elig)
            else:
                units = _take(prim, opt.usage)
            if units is None:
                continue   # stay undispatched for next round (paper §6.2)
            avail -= set(units)
            # Γ^E: merge with D when co-resident, else aux ⟨E⟩ replicas
            if "E" in prim:
                e_units = units
            else:
                ke = self.prof.optimal_degree(req, "E")
                e_units = self._aux_units(plan, "E", ke, avail, free_at, tau,
                                          borrowed_all or None,
                                          exclude=draining)
            # Γ^C: subset of D's units when co-resident, else aux ⟨C⟩
            kc = self.prof.optimal_degree(req, "C")
            if "C" in prim:
                c_units = units[: max(1, min(kc, len(units)))]
            else:
                c_units = self._aux_units(plan, "C", kc, avail, free_at, tau,
                                          borrowed_all or None,
                                          exclude=draining)
            if not e_units or not c_units:
                avail |= set(units)
                if not draining:
                    _give_back(prim, units)
                continue   # no auxiliary capacity -> undispatched this tick
            decisions.append(DispatchDecision(
                request=req, vr_type=opt.dim, degree=opt.usage,
                d_units=units, e_units=tuple(e_units), c_units=tuple(c_units)))
        if borrowed:
            self._offload_decode(decisions, pending, borrowed, free_at, tau)
        return decisions

    def _offload_decode(self, decisions: List[DispatchDecision],
                        pending: Sequence[Request],
                        borrowed: Dict[str, Tuple[int, ...]],
                        free_at: Dict[int, float], tau: float) -> None:
        """Work-conserving decode offload onto borrowed foreign units.

        While requests are still left waiting after this round's grants, a
        decision whose primary co-hosts C (⟨EDC⟩/⟨DC⟩) hands its Decode to
        an idle borrowed ⟨C⟩ unit instead of merging it: the primary frees
        t_C earlier.  D never moves."""
        pool = [g for g in borrowed.get("C", ())
                if free_at.get(g, 0.0) <= tau]
        if not pool:
            return
        granted = sum(d.batch for d in decisions)
        if len(pending) <= granted:
            return   # no backlog: merged execution stays strictly better
        # offload the heaviest decodes first: they strand the most time
        order = sorted(
            (d for d in decisions
             if "C" in primary_of_vr(d.vr_type)
             and set(d.c_units) <= set(d.d_units)),
            key=lambda d: -self.prof.stage_time(
                d.request, "C", len(d.c_units) * self.prof.k_min))
        for dec in order:
            if not pool:
                return
            req = dec.request
            kc = min(self.prof.optimal_degree(req, "C"), len(dec.c_units))
            take = pool[:max(1, min(kc, len(pool)))]
            if not self.prof.fits(req, "C", len(take)):
                continue
            # degree- and deadline-aware: a thinner pool slows this
            # request's decode, and the offload pays the inter-node latent
            # push (and a possible communicator build) that merged execution
            # avoids — degrade only when the request still makes its SLO,
            # or misses it either way
            k = self.prof.k_min
            t_merged = self.prof.stage_time(req, "C", kc * k)
            t_off = self.prof.stage_time(req, "C", len(take) * k)
            q_dc = self.prof.comm_bytes(req, "DC")
            t_push = (self.prof.transfer_time(q_dc, intra_node=False)
                      + self.prof.transfer_time(q_dc, intra_node=True)
                      + self.prof.hw.comm_group_init)
            runtime = self._req_runtime(req, dec.vr_type, dec.degree)
            # start when the granted primary units actually free up, not at
            # tau: a queueing-blind estimate would bless offloads that push
            # the real finish past the deadline
            start = max([tau] + [free_at.get(g, tau) for g in dec.d_units])
            fin_merged = start + runtime
            fin_off = fin_merged - t_merged + t_off + t_push
            if fin_off > req.deadline and fin_merged <= req.deadline:
                continue
            dec.c_units = tuple(take)
            del pool[:len(take)]


class CrossLaneBatcher:
    """Fleet-level cross-lane dynamic batching (``FleetConfig.cross_lane_batching``).

    After every lane's dispatcher has produced its tick decisions (but
    before any engine executes them), the batcher scans the fleet-wide
    decision set for auxiliary E/C stage runs whose units share a
    ``(stage, placement_type, unit_size)`` shape across two or more lanes,
    and fuses each such group into ONE batched launch on a single *host*
    lane's auxiliary units:

    * **Member selection** is the ILP's multiplicity-aware aggregation with
      the grouping key extended across lanes: each candidate run becomes a
      grouped column with a *multi-dimensional* ``ilp.Option`` spanning the
      shared batch-capacity dimension and its own lane's dimension
      (``dim=(0, lane)``, ``usage=(b, b)``), so one ``solve_grouped`` call
      packs the launch under both the fleet-wide batch cap and each lane's
      own batch-curve cap.  Rewards are the native solo stage times the
      fusion releases.
    * **Batch cap** comes from the profiler's batch-latency curve
      (``Profiler.optimal_batch``) unless ``max_batch`` overrides it.
    * **Duration** charged is the *batched* stage time at the combined
      batch size — conservatively the max over the member lanes' profiles —
      on the host units only; every other member lane's native auxiliary
      selection goes unused (that is the capacity the fusion pools).
    * **Completion** is one merged event under the ``clock.MERGED_LANE``
      sentinel whose members span lanes; the fleet simulator's drain loop
      un-merges it (one ``on_completion`` per participating lane, per-member
      finish accounting).

    E-groups launch at plan time (E has no intra-tick dependency); C-groups
    are deferred via ``dec.xl_cdefer`` and scheduled in :meth:`finalize`
    once every lane's engine has executed and stamped ``stage_done["D"]``.

    Only constructed when the fleet knob is on.  The reference's warm
    grants across ticks (``incremental_ilp``) are not ported.
    """

    def __init__(self, max_batch: int = 0, solver_time_cap: float = 0.05):
        self.max_batch = max_batch          # 0 = profiler batch-curve cap
        self.solver_time_cap = solver_time_cap
        self.merges = 0                     # fused launches charged
        self.merged_requests = 0            # batch items across all fusions
        # host units of un-drained fused launches: (host pid, unit) ->
        # latest fused finish.  The lending broker asks ``fused_busy``
        # before it force-returns a borrowed host unit; entries are pruned
        # lazily
        self.inflight_hosts: Dict[Tuple[str, int], float] = {}
        # set by the fleet while a fault injector is live: merged events
        # then carry their host (pipeline, unit) pairs so revocation can
        # match them (core/elastic.py)
        self.track_units: bool = False

    # -- candidate assembly ---------------------------------------------------

    @staticmethod
    def _units(dec: DispatchDecision, stage: str) -> Tuple[int, ...]:
        return dec.e_units if stage == "E" else dec.c_units

    def _collect(self, lane_decs) -> Dict[tuple, list]:
        """Group fusable (lane, dec, stage) candidates by shape key.

        The key is ``(stage, placement_type, unit_size)`` — the contract the
        merged launch relies on: same stage weights resident, same replica
        shape, same per-unit chip count.  Same placement_type but different
        stage deliberately yields distinct keys (a ⟨C⟩-typed unit hosting a
        warm E replica must not merge with a C run)."""
        groups: Dict[tuple, list] = {}
        for lane, decs in lane_decs:
            plan = lane.engine.plan
            for dec in decs:
                for stage in getattr(dec, "xl_candidate", ()):
                    units = self._units(dec, stage)
                    if not units:
                        continue
                    key = (stage, plan.placements[units[0]], plan.unit_size)
                    groups.setdefault(key, []).append((lane, dec))
        return groups

    # -- member selection (grouped ILP, cross-lane columns) -------------------

    def _select(self, stage: str, per_lane: Dict[str, list]):
        """Pick the fused member set for one shape group.

        Returns ``(fused, host_lane, host_units, n_total, T)`` or ``None``
        when no fusion spanning >= 2 lanes fits under the caps."""
        # host = lane whose leading candidate's aux units free up earliest
        # (its units carry the fused launch); deterministic pipeline tiebreak
        host_pid = min(
            sorted(per_lane),
            key=lambda pid: (max(per_lane[pid][0][0].engine.units[g].free_at
                                 for g in self._units(per_lane[pid][0][1], stage)),
                             pid))
        host, anchor = per_lane[host_pid][0]
        host_units = self._units(anchor, stage)
        k_chips = len(host_units) * host.prof.k_min
        # per-lane batch caps from each profile's batch curve, at the HOST
        # launch shape (that is where the fused run executes); a positive
        # max_batch override replaces BOTH the shared and the per-lane curve
        # caps (the operator is asserting a throughput/latency trade the
        # 1.2x-single curve knee would refuse)
        cap_of = {}
        for pid, cands in per_lane.items():
            rep = min(cands, key=lambda c: (c[1].request.deadline,
                                            c[1].request.rid))[1].request
            cap_of[pid] = (self.max_batch if self.max_batch > 0
                           else cands[0][0].prof.optimal_batch(rep, stage,
                                                               k_chips))
        shared_cap = (self.max_batch if self.max_batch > 0
                      else max(cap_of[p] for p in sorted(cap_of)))
        b_anchor = anchor.batch
        if shared_cap - b_anchor < 1:
            return None            # no room to span a second lane
        # grouped ILP: dim 0 = shared fleet batch budget, dims 1..L = lanes
        lane_dim = {pid: i + 1 for i, pid in enumerate(per_lane)}
        budgets = [shared_cap - b_anchor] + [
            max(0, cap_of[pid] - (b_anchor if pid == host_pid else 0))
            for pid in per_lane]
        gindex: Dict[tuple, int] = {}
        gopts: List[List[ilp.Option]] = []
        counts: List[int] = []
        gmembers: List[list] = []
        for pid, cands in per_lane.items():
            for lane, dec in cands:
                if dec is anchor:
                    continue
                b = dec.batch
                units = self._units(dec, stage)
                # reward: native solo auxiliary time this member releases
                saving = lane.prof.batched_stage_time(
                    dec.request, stage, len(units) * lane.prof.k_min, b)
                gkey = (lane_dim[pid], b, saving)
                g = gindex.get(gkey)
                if g is None:
                    g = gindex[gkey] = len(gopts)
                    gopts.append([ilp.Option(dim=(0, lane_dim[pid]),
                                             usage=(b, b), reward=saving)])
                    counts.append(0)
                    gmembers.append([])
                counts[g] += 1
                gmembers[g].append((lane, dec))
        if not gopts:
            return None
        sol = ilp.solve_grouped(gopts, budgets, counts,
                                time_cap=self.solver_time_cap)
        fused = [(host, anchor)]
        for g in sorted(sol.alloc):
            grants = sol.alloc[g]
            # deadline-ordered un-merging: earliest-deadline members of the
            # class take the granted slots
            ordered = sorted(gmembers[g],
                             key=lambda c: (c[1].request.deadline,
                                            c[1].request.pipeline,
                                            c[1].request.rid))
            fused.extend(ordered[:len(grants)])
        if len({lane.pipeline for lane, _ in fused}) < 2:
            return None            # fusion must actually span lanes
        n_total = sum(dec.batch for _, dec in fused)
        # batched duration at the combined size: conservative max over the
        # member lanes' profiles (sorted walk -> deterministic float max)
        reps: Dict[str, Request] = {}
        for lane, dec in fused:
            cur = reps.get(lane.pipeline)
            r = dec.request
            if cur is None or (r.deadline, r.rid) < (cur.deadline, cur.rid):
                reps[lane.pipeline] = r
        by_lane = {lane.pipeline: lane for lane, _ in fused}
        T = max(by_lane[pid].prof.batched_stage_time(reps[pid], stage,
                                                     k_chips, n_total)
                for pid in sorted(reps))
        return fused, host, host_units, n_total, T

    # -- fused launch scheduling ----------------------------------------------

    @staticmethod
    def _members(fused) -> Tuple[Request, ...]:
        """All batch items of all fused decisions, in the merged event's
        canonical (pipeline, rid) member order (detlint DET001: sorted
        before any accumulation downstream)."""
        return tuple(sorted(
            (r for _, dec in fused
             for r in (dec.request,) + tuple(dec.corequests)),
            key=lambda r: (r.pipeline, r.rid)))

    @staticmethod
    def _charge_borrowed(host, host_units, stage: str) -> None:
        """A fused launch spanning a borrowed (unit-lending) unit counts ONE
        stage run against the host lane's borrow ledger."""
        if host.track_borrowed and any(g >= host.base_units for g in host_units):
            host.borrowed_stage_runs[stage] = \
                host.borrowed_stage_runs.get(stage, 0) + 1

    def _launch_e(self, fused, host, host_units, n_total: float, T: float,
                  tau: float, clock) -> None:
        from repro_torch.core.clock import MERGED_LANE
        eng = host.engine
        start = max(tau, max(eng.units[g].free_at for g in host_units))
        start += eng._reinstance(host_units)
        start += eng._prepare_stage("E", host_units, tau)
        fin = start + T
        eng._reserve(host_units, fin)
        eng.stats.dispatches += 1
        self._charge_borrowed(host, host_units, "E")
        ptype = eng.plan.placements[host_units[0]]
        clock.push_completion(fin, MERGED_LANE, "E", ptype, T,
                              self._members(fused),
                              tuple((host.pipeline, g) for g in host_units)
                              if self.track_units else ())
        self._note_inflight(host.pipeline, host_units, fin)
        for lane, dec in fused:
            dec.xl_efused = (start, fin, lane is host, host_units)
            dec.xl_skip = tuple(getattr(dec, "xl_skip", ())) + ("E",)
        self.merges += 1
        self.merged_requests += n_total

    def plan(self, lane_decs, tau: float, clock) -> list:
        """Fuse this tick's cross-lane candidates.

        ``lane_decs`` is the ordered ``(lane, decisions)`` list for every
        lane, produced by ``Lane.decide`` *before* any lane executes.
        E-groups are scheduled immediately (the fused E run depends on
        nothing this tick); C-groups are returned for :meth:`finalize`
        after the lanes' engines have stamped ``stage_done["D"]``."""
        cgroups = []
        groups = self._collect(lane_decs)
        for key in sorted(groups):
            stage = key[0]
            per_lane: Dict[str, list] = {}
            for lane, dec in groups[key]:
                per_lane.setdefault(lane.pipeline, []).append((lane, dec))
            if len(per_lane) < 2:
                continue
            picked = self._select(stage, per_lane)
            if picked is None:
                continue
            fused, host, host_units, n_total, T = picked
            if stage == "E":
                self._launch_e(fused, host, host_units, n_total, T, tau, clock)
            else:
                for _, dec in fused:
                    dec.xl_cdefer = True
                    dec.xl_skip = tuple(getattr(dec, "xl_skip", ())) + ("C",)
                cgroups.append((fused, host, host_units, n_total, T))
        return cgroups

    def finalize(self, cgroups: list, tau: float, clock) -> None:
        """Schedule the deferred fused C launches.

        Runs after every lane executed its decisions: each member's
        ``stage_done["D"]`` now holds its decode finish, so the fused C
        start is gated on the slowest member's latent push to the host
        units (host-lane members use the engine's locality-aware push;
        foreign members pay the two-step cross-lane path)."""
        from repro_torch.core.clock import MERGED_LANE
        for fused, host, host_units, n_total, T in cgroups:
            eng = host.engine
            ready = tau
            for lane, dec in fused:
                d_fin = dec.request.stage_done["D"]
                nbytes = lane.prof.comm_bytes(dec.request, "DC")
                if lane is host:
                    dr = eng._push(nbytes, dec.d_units, host_units, d_fin)
                else:
                    dr = d_fin + lane.engine.push_cross(nbytes)
                ready = max(ready, dr)
            start = max(ready, max(eng.units[g].free_at for g in host_units))
            start += eng._reinstance(host_units)
            start += eng._prepare_stage("C", host_units, tau)
            fin = start + T
            eng._reserve(host_units, fin)
            eng.stats.dispatches += 1
            self._charge_borrowed(host, host_units, "C")
            members = self._members(fused)
            for r in members:
                r.stage_done["C"] = fin
            ptype = eng.plan.placements[host_units[0]]
            clock.push_completion(fin, MERGED_LANE, "C", ptype, T, members,
                                  tuple((host.pipeline, g)
                                        for g in host_units)
                                  if self.track_units else ())
            self._note_inflight(host.pipeline, host_units, fin)
            self.merges += 1
            self.merged_requests += n_total

    # -- in-flight host tracking -----------------------------------------------

    def _note_inflight(self, pid: str, host_units, fin: float) -> None:
        for g in host_units:
            key = (pid, g)
            if fin > self.inflight_hosts.get(key, 0.0):
                self.inflight_hosts[key] = fin

    def fused_busy(self, pid: str, unit: int, tau: float) -> bool:
        """Is a fused launch hosted on ``(pid, unit)`` still un-drained at
        ``tau``?  The lending broker's force-return guard: a borrowed host
        unit inside a live ``MERGED_LANE`` event must not change hands until
        the merge drains; stale entries are pruned lazily."""
        fin = self.inflight_hosts.get((pid, unit))
        if fin is None:
            return False
        if fin <= tau:
            del self.inflight_hosts[(pid, unit)]
            return False
        return True
