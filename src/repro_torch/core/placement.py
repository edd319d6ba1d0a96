"""Placement types, Virtual Replicas (Table 3), and placement plans.

π_g ∈ {⟨EDC⟩, ⟨DC⟩, ⟨ED⟩, ⟨D⟩, ⟨E⟩, ⟨C⟩}; ⟨EC⟩ is omitted per the paper
(footnote 3: D dominates the critical path, so E+C co-location without D
neither improves throughput nor reduces D-bound traffic).

Virtual Replicas V0..V3 map one-to-one to the *Primary Placements* (those
containing D); their inter-stage communication grows monotonically with the
index: 0, Q_ED, Q_DC, Q_ED+Q_DC — and since l_proc^C > l_proc^E implies
Q_DC > Q_ED, the preference order is V0 ≺ V1 ≺ V2 ≺ V3.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Tuple

# placement types (stage sets, order-normalized)
EDC, DC, ED, D, E, C = "EDC", "DC", "ED", "D", "E", "C"
PLACEMENT_TYPES = (EDC, DC, ED, D, E, C)
PRIMARY_PLACEMENTS = (EDC, DC, ED, D)      # contain D

# Virtual Replica table (paper Table 3)
#   index -> (primary placement, auxiliary placements, comm stages crossed)
VIRTUAL_REPLICAS: Dict[int, Tuple[str, Tuple[str, ...], Tuple[str, ...]]] = {
    0: (EDC, (), ()),                      # V0: no inter-stage comm
    1: (DC, (E,), ("ED",)),                # V1: Q_ED
    2: (ED, (C,), ("DC",)),                # V2: Q_DC
    3: (D, (E, C), ("ED", "DC")),          # V3: Q_ED + Q_DC
}


def primary_of_vr(vr: int) -> str:
    return VIRTUAL_REPLICAS[vr][0]


@dataclasses.dataclass
class PlacementPlan:
    """P = {π_g}: placement type per scheduling unit (k_min chips).

    ``pipeline`` tags the owning pipeline when the plan is one slice of a
    shared-cluster fleet plan (core/fleet.py): each scheduling unit then
    carries ``(pipeline, placement_type)``.  Single-tenant plans leave it
    empty — the 1-pipeline special case.  The reference's unit-lending and
    elastic-decommissioning overlays are not ported.
    """
    placements: List[str]                 # index = unit id
    unit_size: int = 1                    # chips per unit (App. E.2 MP fold)
    units_per_node: int = 8               # scheduling units per 8-chip node
    pipeline: str = ""                    # owning pipeline in a fleet plan

    def __post_init__(self):
        assert all(p in PLACEMENT_TYPES for p in self.placements)

    def tagged(self, unit: int) -> Tuple[str, str]:
        """(pipeline, placement_type) of one scheduling unit."""
        return (self.pipeline, self.placements[unit])

    @property
    def num_units(self) -> int:
        return len(self.placements)

    def node_of(self, unit: int) -> int:
        return unit // self.units_per_node

    def _index(self) -> Tuple[Dict[str, List[int]], Dict[str, FrozenSet[int]],
                              FrozenSet[int]]:
        """Lazy unit indices by placement type (plans are immutable after
        construction): these lookups run on every scheduler wake-up."""
        idx = self.__dict__.get("_idx")
        if idx is None:
            by_type: Dict[str, List[int]] = {}
            for g, p in enumerate(self.placements):
                by_type.setdefault(p, []).append(g)
            primary = frozenset(g for g, p in enumerate(self.placements)
                                if p in PRIMARY_PLACEMENTS)
            idx = self.__dict__["_idx"] = (
                by_type, {p: frozenset(gs) for p, gs in by_type.items()}, primary)
        return idx

    def units_of_type(self, ptype: str) -> List[int]:
        return self._index()[0].get(ptype, [])

    def type_set(self, ptype: str) -> FrozenSet[int]:
        """``units_of_type`` as a frozenset, for set intersections with the
        idle set on the dispatch path."""
        return self._index()[1].get(ptype, frozenset())

    @property
    def primary_units(self) -> FrozenSet[int]:
        """Units whose placement carries the D stage."""
        return self._index()[2]

    def count_of_type(self, ptype: str) -> int:
        return len(self.units_of_type(ptype))

    def type_histogram(self) -> Dict[str, int]:
        return {t: self.count_of_type(t) for t in PLACEMENT_TYPES
                if self.count_of_type(t)}
