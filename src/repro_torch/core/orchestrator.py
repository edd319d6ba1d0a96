"""Dynamic Orchestrator (§6.1, Algorithm 2 + Appendix C.1).

Generates placement plans:
  1. OptVR(r) per request: first feasible Virtual-Replica type in the order
     V0 ≺ V1 ≺ V2 ≺ V3 (minimal inter-stage communication).
  2. Provision VR-type counts proportionally to the OptVR distribution.
  3. Split() each type's budget into primary/auxiliary replicas inversely
     proportional to monitored service rates.
  4. PackPerMachine(): pad D-carrying primaries to whole nodes (so SP
     degrees up to a full node stay selectable) and pack homogeneous blocks.
"""
from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Optional, Sequence

from repro_torch.core.placement import (C, D, DC, E, ED, EDC, PRIMARY_PLACEMENTS,
                                        PlacementPlan, primary_of_vr)
from repro_torch.core.profiler import Profiler
from repro_torch.core.request import Request


class Orchestrator:
    def __init__(self, profiler: Profiler, num_chips: int = 128,
                 chips_per_node: int = 8):
        self.prof = profiler
        self.num_units = num_chips // profiler.k_min
        self.units_per_node = max(1, chips_per_node // profiler.k_min)

    def resize(self, num_chips: int) -> None:
        """Re-target the orchestrator at a new chip budget.  Used by the
        fleet layer (core/fleet.py) when the shared-cluster partition moves
        chips between pipelines; subsequent ``generate`` calls plan within
        the new budget."""
        self.num_units = num_chips // self.prof.k_min

    # -- Algorithm 2, lines 1-2 ----------------------------------------------

    def opt_vr(self, req: Request) -> int:
        k = self.prof.optimal_degree(req, "D")
        for vr in range(4):
            prim = primary_of_vr(vr)
            if self.prof.fits(req, prim, k):
                return vr
        return 3  # ⟨D⟩ with max degree as last resort

    # -- service rates (v_pi) ---------------------------------------------------

    def _service_rates(self, reqs: Sequence[Request], vr: int,
                       measured: Optional[Dict[str, float]] = None
                       ) -> Dict[str, float]:
        """Requests/s per replica for the primary and auxiliaries of type vr.
        Measured Monitor rates take precedence; the profiler seeds bootstrap."""
        prim = primary_of_vr(vr)
        sample = [r for r in reqs] or [Request(self.prof.cfg.name, 512)]

        def avg_time(stage_set: str) -> float:
            tot = 0.0
            for r in sample:
                k = self.prof.optimal_degree(r, "D") * self.prof.k_min
                for s in stage_set:
                    ks = (k if s == "D" else
                          self.prof.optimal_degree(r, s) * self.prof.k_min)
                    tot += self.prof.stage_time(r, s, ks)
            return tot / len(sample)

        rates = {
            "prim": 1.0 / max(avg_time(prim), 1e-9),
            "auxE": 1.0 / max(avg_time("E"), 1e-9),
            "auxC": 1.0 / max(avg_time("C"), 1e-9),
        }
        if measured:
            for key, pi in (("prim", prim), ("auxE", E), ("auxC", C)):
                if measured.get(pi, 0.0) > 0.0:
                    rates[key] = measured[pi]
        return rates

    # -- Appendix C.1: Split() -----------------------------------------------------

    @staticmethod
    def split(n_t: int, vr: int, rates: Dict[str, float]) -> Dict[str, int]:
        """(n_prim, n_auxE, n_auxC) summing to n_t with aux capacity >= prim."""
        prim = primary_of_vr(vr)
        v_p, v_e, v_c = rates["prim"], rates["auxE"], rates["auxC"]
        if vr == 0:                                   # EDC: trivial
            return {prim: n_t}
        if vr == 1:                                   # DC + auxE
            rho = v_p / v_e
            n_p = max(1, math.floor(n_t / (1 + rho))) if n_t > 1 else n_t
            return {prim: n_p, E: n_t - n_p}
        if vr == 2:                                   # ED + auxC
            rho = v_p / v_c
            n_p = max(1, math.floor(n_t / (1 + rho))) if n_t > 1 else n_t
            return {prim: n_p, C: n_t - n_p}
        # V3: D + auxE + auxC, proportional to (1, a, b)
        a, b = v_p / v_e, v_p / v_c
        tot = 1 + a + b
        n_p = max(1, round(n_t / tot)) if n_t > 2 else max(1, n_t - 2)
        n_e = max(1 if n_t >= 3 else 0, round(n_t * a / tot))
        n_c = n_t - n_p - n_e
        if n_c < (1 if n_t >= 3 else 0):
            n_c = max(0, n_c)
            n_p = n_t - n_e - n_c
        # degenerate guard (n_t <= 2 with extreme rates): the rounding above
        # can let the aux buckets swallow the whole budget; shrink the larger
        # aux until the primary keeps at least one unit
        while n_p < 1 and (n_e > 0 or n_c > 0):
            if n_e >= n_c:
                n_e -= 1
            else:
                n_c -= 1
            n_p += 1
        # feasibility: aux capacity must cover the primary's service rate
        while n_p > 1 and (n_e * v_e < n_p * v_p or n_c * v_c < n_p * v_p):
            n_p -= 1
            if n_e * v_e < n_p * v_p + v_p:
                n_e += 1
            else:
                n_c += 1
        return {primary_of_vr(3): n_p, E: n_e, C: n_c}

    # -- Appendix C.1: PackPerMachine() -----------------------------------------------

    def pack_per_machine(self, counts: Dict[str, int]) -> PlacementPlan:
        """Pad D-carrying primaries to node multiples (borrowing from their
        auxiliaries), then pack homogeneous whole nodes, then first-fit."""
        counts = dict(counts)
        upn = self.units_per_node
        total = self.num_units
        # normalize: drop zero/negative
        counts = {t: c for t, c in counts.items() if c > 0}
        # pad primaries up to multiples of upn by borrowing from auxiliaries
        for prim in (EDC, ED, DC, D):
            c = counts.get(prim, 0)
            if c == 0 or c % upn == 0:
                continue
            want = min(total, (c + upn - 1) // upn * upn)
            need = want - c
            borrowable = counts.get(E, 0) + counts.get(C, 0)
            if need <= borrowable - 2 * (1 if borrowable else 0):
                for aux in (E, C):
                    take = min(need, max(0, counts.get(aux, 0) - 1))
                    counts[aux] = counts.get(aux, 0) - take
                    need -= take
                    if need == 0:
                        break
                counts[prim] = want - need
        # fix total
        drift = total - sum(counts.values())  # detlint: ignore[DET001] int unit counts: exact
        if drift > 0:
            # surplus units go to the largest bucket
            t = max(counts, key=lambda t: counts[t])  # detlint: ignore[DET004] counts is split-ordered; tie winner is BENCH-byte-frozen
            counts[t] += drift
        elif drift < 0:
            # shed units largest-bucket-first.  A single lump subtraction
            # could silently zero the largest bucket — including the only
            # D-carrying one, leaving a plan that can never run Diffuse —
            # so shed one unit at a time and never take a primary bucket's
            # last unit while it is the only primary left.
            for _ in range(-drift):
                pick = None
                n_prim = sum(c for t, c in counts.items()  # detlint: ignore[DET001] int unit counts: exact
                             if t in PRIMARY_PLACEMENTS)
                for t in sorted(counts, key=lambda t: -counts[t]):  # detlint: ignore[DET004] equal-count shed order = insertion order; BENCH-byte-frozen
                    if counts[t] <= 0:
                        continue
                    if t in PRIMARY_PLACEMENTS and n_prim <= 1:
                        continue
                    pick = t
                    break
                if pick is None:   # only a lone primary unit remains
                    break
                counts[pick] -= 1
            counts = {t: c for t, c in counts.items() if c > 0}
        # pack: homogeneous blocks node by node, primaries first
        order = [t for t in (EDC, DC, ED, D, E, C) if counts.get(t, 0) > 0]
        placements: List[str] = []
        for t in order:
            placements.extend([t] * counts[t])
        placements = placements[:total]
        while len(placements) < total:
            placements.append(order[0] if order else EDC)
        return PlacementPlan(placements, unit_size=self.prof.k_min,
                             units_per_node=upn)

    # -- Algorithm 2 main -----------------------------------------------------------

    def feasible(self) -> bool:
        """A plan exists iff there is at least one unit and every stage's
        MP-folded parameters fit a single unit (V3 disaggregates fully, so
        per-stage fit is both necessary and sufficient)."""
        if self.num_units < 1:
            return False
        hw = self.prof.hw
        return all(self.prof.unit_param_bytes(s) + hw.mem_reserve <= hw.hbm_bytes
                   for s in "EDC")

    def generate(self, reqs: Sequence[Request],
                 measured_rates: Optional[Dict[str, float]] = None
                 ) -> Optional[PlacementPlan]:
        """Algorithm 2.  Returns ``None`` when no feasible placement exists —
        the same contract ``Scheduler.initial_placement`` exposes, so both
        bootstrap and re-placement callers handle infeasibility uniformly
        (the simulator reports OOM; ``maybe_replace`` keeps the old plan).

        VR-type proportions weight each request by its unit-time footprint
        (the reference's "demand" mode, its default) rather than counting
        requests as Algorithm 2 is written: this keeps heavy classes, whose
        per-request consumption dwarfs the light ones, from starving."""
        if not self.feasible():
            return None
        sample = list(reqs)
        if not sample:
            # bootstrap with a nominal mid-size request
            sample = [Request(self.prof.cfg.name, 1024,
                              4.0 if self.prof.cfg.is_video else 0.0)]
        opt: Counter = Counter()
        for r in sample:
            k = self.prof.optimal_degree(r, "D")
            w = self.prof.stage_time(r, "D", k * self.prof.k_min) * k
            opt[self.opt_vr(r)] += w
        total = sum(opt.values())  # detlint: ignore[DET001] Counter keyed in sample order: insertion-ordered
        counts: Dict[str, int] = Counter()
        # lines 3-4: N_t proportional to OptVR distribution
        n_assigned = 0
        n_by_vr = {}
        for vr in range(4):
            n_by_vr[vr] = int(opt.get(vr, 0) / total * self.num_units)
            n_assigned += n_by_vr[vr]
        # leftover units go to the most demanded type
        if total:
            best = max(range(4), key=lambda v: opt.get(v, 0))
            n_by_vr[best] += self.num_units - n_assigned
        # lines 5-6: Split each N_t
        for vr in range(4):
            if n_by_vr[vr] <= 0:
                continue
            rates = self._service_rates(sample, vr, measured_rates)
            for ptype, c in self.split(n_by_vr[vr], vr, rates).items():
                counts[ptype] += c
        # line 7
        return self.pack_per_machine(counts)
