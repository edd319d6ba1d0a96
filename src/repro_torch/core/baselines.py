"""Baselines B1-B6 (§8.1, Appendix D.2) over the same engine/simulator.

B1-B4 are colocated pipeline-level systems *without* the Appendix-E.2 MP
fold (that is the paper's setting: xDiT-style deployments colocate the full
pipeline per GPU — which is why they OOM on Flux/HunyuanVideo wherever one
chip holds less than the whole pipeline; one 80 GB H100 holds each of the
four).
B5/B6 disaggregate stages manually (an expert operator would also apply MP
where a stage doesn't fit, so they inherit the automatic k_min fold).

Counterpart of ``repro/core/baselines.py``; the memory limit is the
profiler's ``Hardware`` set's.
"""
from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Optional, Tuple

from repro_torch.core.clock import Scheduler
from repro_torch.core.dispatcher import DispatchDecision, Dispatcher
from repro_torch.core.placement import PlacementPlan
from repro_torch.core.profiler import Profiler
from repro_torch.core.request import Request
from repro_torch.core.simulator import Simulator
from repro_torch.core.workloads import MIXES


def _max_load_class(pipeline: str) -> Tuple[int, float]:
    classes = {cls for mix in MIXES[pipeline].values() for cls, _ in mix}
    # sorted: the key is injective over (res, sec) tuples, so the wrap is
    # byte-neutral, but it pins the walk order off PYTHONHASHSEED
    return max(sorted(classes), key=lambda c: (c[0] * max(1.0, c[1]), c[1]))


class _ColocatedBase(Scheduler):
    """Shared machinery for the colocated pipeline-level baselines."""

    FORCE_KMIN = 1   # no MP fold — the paper's colocated-system setting

    def initial_placement(self) -> Optional[PlacementPlan]:
        hw = self.prof.hw
        if self.prof.unit_param_bytes("EDC") + hw.mem_reserve > hw.hbm_bytes:
            return None   # OOM: the whole pipeline cannot colocate
        n = self.sim_cfg.num_chips // self.prof.k_min
        return PlacementPlan(["EDC"] * n, unit_size=self.prof.k_min,
                             units_per_node=8 // self.prof.k_min)

    def _mk(self, sim, req: Request, units: Tuple[int, ...], k: int
            ) -> Optional[DispatchDecision]:
        if not self.prof.fits(req, "EDC", k):
            sim.fail_request_oom(req)
            sim.pending.remove(req)
            return None
        return DispatchDecision(request=req, vr_type=0, degree=k,
                                d_units=units, e_units=units, c_units=units)


class B1StaticPipeline(_ColocatedBase):
    """B1 (xDiT): one global static degree, FIFO, same resources per stage."""

    name = "B1"

    def __init__(self, prof, sim_cfg, trace):
        super().__init__(prof, sim_cfg, trace)
        heavy = Request(prof.cfg.name, *_max_load_class(prof.cfg.name))
        self.k_static = max(1, self.prof.optimal_degree(heavy, "D") // 2)

    def tick(self, sim: Simulator, tau: float) -> List[DispatchDecision]:
        out = []
        avail = set(sim.engine.idle_units(tau))
        for req in sorted(sim.pending, key=lambda r: r.arrival):
            units = Dispatcher.select_units(sim.engine.plan, "EDC",
                                            self.k_static, avail)
            if units is None:
                break   # FIFO: head-of-line blocks
            dec = self._mk(sim, req, units, self.k_static)
            if dec is None:
                continue
            avail -= set(units)
            out.append(dec)
        return out


class B2BucketedPipeline(_ColocatedBase):
    """B2: static degree buckets sized by demand x service time (D.2)."""

    name = "B2"

    def __init__(self, prof, sim_cfg, trace):
        super().__init__(prof, sim_cfg, trace)
        self.bucket_of_unit: Dict[int, int] = {}

    def initial_placement(self) -> Optional[PlacementPlan]:
        plan = super().initial_placement()
        if plan is None:
            return None
        # demand shares per degree from the trace prefix
        sample = list(self.trace[:256]) or [Request(self.prof.cfg.name, 512)]
        load = Counter()
        for r in sample:
            k = self.prof.optimal_degree(r, "D")
            load[k] += self.prof.stage_time(r, "D", k * self.prof.k_min) * k
        total = sum(load.values()) or 1.0  # detlint: ignore[DET001] Counter keyed in trace order: insertion-ordered, BENCH-byte-frozen
        n = plan.num_units
        counts = {}
        used = 0
        for k in (8, 4, 2):
            nk = int(round(n * load.get(k, 0.0) / total / k) * k)
            counts[k] = min(nk, n - used)
            used += counts[k]
        counts[1] = n - used
        uid = 0
        for k in (8, 4, 2, 1):
            for _ in range(counts.get(k, 0)):
                self.bucket_of_unit[uid] = k
                uid += 1
        return plan

    def tick(self, sim: Simulator, tau: float) -> List[DispatchDecision]:
        out = []
        avail = set(sim.engine.idle_units(tau))
        for req in sorted(sim.pending, key=lambda r: r.arrival):
            k = self.prof.optimal_degree(req, "D")
            bucket = {g for g in avail if self.bucket_of_unit.get(g, 1) == k}
            units = Dispatcher.select_units(sim.engine.plan, "EDC", k, bucket)
            if units is None:
                continue   # FIFO within bucket; other buckets proceed
            dec = self._mk(sim, req, units, k)
            if dec is None:
                continue
            avail -= set(units)
            out.append(dec)
        return out


class B3DynamicPipelineFIFO(_ColocatedBase):
    """B3: per-request optimal degree, strict FIFO (head-of-line blocking)."""

    name = "B3"

    def tick(self, sim: Simulator, tau: float) -> List[DispatchDecision]:
        out = []
        avail = set(sim.engine.idle_units(tau))
        for req in sorted(sim.pending, key=lambda r: r.arrival):
            k = self.prof.optimal_degree(req, "D")
            units = Dispatcher.select_units(sim.engine.plan, "EDC", k, avail)
            if units is None:
                break   # HOL blocking
            dec = self._mk(sim, req, units, k)
            if dec is None:
                continue
            avail -= set(units)
            out.append(dec)
        return out


def srtf_key(prof: Profiler, req: Request, tau: float):
    """SRTF with aging (D.2): overdue requests gain priority classes."""
    k = prof.optimal_degree(req, "D") * prof.k_min
    t_star = prof.stage_time(req, "D", k)
    t_hat = tau + t_star
    if t_hat <= req.deadline:
        return (0, t_star)
    scale = math.ceil((t_hat - req.deadline) / max(t_star, 1e-9))
    return (max(1, 5 - scale), t_star)


class B4DynamicPipelineSRTF(_ColocatedBase):
    """B4: as B3 but SRTF+aging; may skip blocked heads."""

    name = "B4"

    def tick(self, sim: Simulator, tau: float) -> List[DispatchDecision]:
        out = []
        avail = set(sim.engine.idle_units(tau))
        for req in sorted(sim.pending, key=lambda r: srtf_key(self.prof, r, tau)):
            k = self.prof.optimal_degree(req, "D")
            units = Dispatcher.select_units(sim.engine.plan, "EDC", k, avail)
            if units is None:
                continue   # SRTF: skip, try next
            dec = self._mk(sim, req, units, k)
            if dec is None:
                continue
            avail -= set(units)
            out.append(dec)
        return out


class _StageDisaggBase(Scheduler):
    """Shared machinery for the manual stage-disaggregated baselines."""

    FORCE_KMIN = None   # experts apply MP where a stage doesn't fit

    def initial_placement(self) -> Optional[PlacementPlan]:
        sample = list(self.trace[:256]) or [Request(self.prof.cfg.name, 512)]
        demand = {}
        for s in "EDC":
            demand[s] = sum(
                self.prof.stage_time(r, s, self.prof.optimal_degree(r, s)
                                     * self.prof.k_min)
                * self.prof.optimal_degree(r, s) for r in sample)
        total = sum(demand.values()) or 1.0  # detlint: ignore[DET001] dict filled in 'EDC' literal order: insertion-ordered
        n = self.sim_cfg.num_chips // self.prof.k_min
        g = {s: max(1, round(n * demand[s] / total)) for s in "EDC"}
        # ensure sum == n by adjusting the largest split (D.2)
        drift = n - sum(g.values())  # detlint: ignore[DET001] int unit counts: exact addition, order-free
        g["D"] += drift
        placements = ["E"] * g["E"] + ["D"] * g["D"] + ["C"] * g["C"]
        return PlacementPlan(placements[:n], unit_size=self.prof.k_min,
                             units_per_node=8 // self.prof.k_min)

    def _mk_disagg(self, sim, req, d_units, k, avail, free_at, tau
                   ) -> Optional[DispatchDecision]:
        disp = Dispatcher(self.prof)
        e_units = disp._aux_units(sim.engine.plan, "E",
                                  self.prof.optimal_degree(req, "E"),
                                  avail, free_at, tau)
        c_units = disp._aux_units(sim.engine.plan, "C",
                                  self.prof.optimal_degree(req, "C"),
                                  avail, free_at, tau)
        if not e_units or not c_units:
            return None
        return DispatchDecision(request=req, vr_type=3, degree=k,
                                d_units=d_units, e_units=tuple(e_units),
                                c_units=tuple(c_units))


class B5BucketedStage(_StageDisaggBase):
    """B5: static stage clusters + degree buckets inside D, FIFO."""

    name = "B5"

    def __init__(self, prof, sim_cfg, trace):
        super().__init__(prof, sim_cfg, trace)
        self.bucket_of_unit: Dict[int, int] = {}

    def initial_placement(self) -> Optional[PlacementPlan]:
        plan = super().initial_placement()
        d_units = plan.units_of_type("D")
        sample = list(self.trace[:256]) or [Request(self.prof.cfg.name, 512)]
        load = Counter()
        for r in sample:
            k = self.prof.optimal_degree(r, "D")
            load[k] += self.prof.stage_time(r, "D", k * self.prof.k_min) * k
        total = sum(load.values()) or 1.0  # detlint: ignore[DET001] Counter keyed in trace order: insertion-ordered, BENCH-byte-frozen
        n = len(d_units)
        used = 0
        idx = 0
        for k in (8, 4, 2, 1):
            nk = (n - used) if k == 1 else min(n - used,
                                               int(round(n * load.get(k, 0.0) / total / k) * k))
            for _ in range(nk):
                self.bucket_of_unit[d_units[idx]] = k
                idx += 1
            used += nk
        return plan

    def tick(self, sim: Simulator, tau: float) -> List[DispatchDecision]:
        out = []
        avail = set(sim.engine.idle_units(tau))
        free_at = sim.engine.free_at()
        for req in sorted(sim.pending, key=lambda r: r.arrival):
            k = self.prof.optimal_degree(req, "D")
            bucket = {g for g in avail if self.bucket_of_unit.get(g, 0) == k}
            units = Dispatcher.select_units(sim.engine.plan, "D", k, bucket)
            if units is None:
                continue
            dec = self._mk_disagg(sim, req, units, k, avail, free_at, tau)
            if dec is None:
                continue
            avail -= set(dec.d_units)
            out.append(dec)
        return out


class B6DynamicStageSRTF(_StageDisaggBase):
    """B6: stage clusters + per-stage dynamic optimal degree, SRTF+aging."""

    name = "B6"

    def tick(self, sim: Simulator, tau: float) -> List[DispatchDecision]:
        out = []
        avail = set(sim.engine.idle_units(tau))
        free_at = sim.engine.free_at()
        for req in sorted(sim.pending, key=lambda r: srtf_key(self.prof, r, tau)):
            k = self.prof.optimal_degree(req, "D")
            units = Dispatcher.select_units(sim.engine.plan, "D", k, avail)
            if units is None:
                continue
            dec = self._mk_disagg(sim, req, units, k, avail, free_at, tau)
            if dec is None:
                continue
            avail -= set(dec.d_units)
            out.append(dec)
        return out


BASELINES = {
    "B1": B1StaticPipeline,
    "B2": B2BucketedPipeline,
    "B3": B3DynamicPipelineFIFO,
    "B4": B4DynamicPipelineSRTF,
    "B5": B5BucketedStage,
    "B6": B6DynamicStageSRTF,
}
