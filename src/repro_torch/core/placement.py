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
    empty — the 1-pipeline special case.

    Two overlays change which units dispatch sees without changing the
    plan's own layout: unit lending (``extend``, ``set_active``,
    ``retype``; core/lending.py) and elastic capacity (``decommission``,
    ``commission``; core/elastic.py).  Both drop the cached indices.
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

    def _index(self) -> Tuple[Dict[str, List[int]], FrozenSet[int],
                              Dict[str, FrozenSet[int]]]:
        """Lazy unit indices by placement type over the *active* units (a
        lent-out, returned-loan or decommissioned unit drops out; every
        overlay change drops the cache): these lookups run on every
        scheduler wake-up."""
        idx = self.__dict__.get("_idx")
        if idx is None:
            inactive = self.__dict__.get("_inactive") or ()
            decomm = self.__dict__.get("_decommissioned") or ()
            by_type: Dict[str, List[int]] = {}
            for g, p in enumerate(self.placements):
                if g in inactive or g in decomm:
                    continue
                by_type.setdefault(p, []).append(g)
            primary = frozenset(g for g, p in enumerate(self.placements)
                                if p in PRIMARY_PLACEMENTS
                                and g not in inactive and g not in decomm)
            idx = self.__dict__["_idx"] = (
                by_type, primary, {p: frozenset(gs) for p, gs in by_type.items()})
        return idx

    def units_of_type(self, ptype: str) -> List[int]:
        return self._index()[0].get(ptype, [])

    def type_set(self, ptype: str) -> FrozenSet[int]:
        """``units_of_type`` as a frozenset, for set intersections with the
        idle set on the dispatch path."""
        return self._index()[2].get(ptype, frozenset())

    @property
    def primary_units(self) -> FrozenSet[int]:
        """Active units whose placement carries the D stage."""
        return self._index()[1]

    # -- unit-lending overlay (core/lending.py) ------------------------------

    def extend(self, ptype: str) -> int:
        """Append one unit (a borrowed foreign unit hosting E/C work for
        this plan's pipeline) and return its id.  Loan slots are an overlay:
        the dispatch indices see them while active, but ``count_of_type``
        and ``type_histogram`` never count them."""
        assert ptype in PLACEMENT_TYPES
        self.placements.append(ptype)
        self.__dict__.setdefault("_extended", set()).add(len(self.placements) - 1)
        self.__dict__.pop("_idx", None)
        return len(self.placements) - 1

    def set_active(self, unit: int, active: bool) -> None:
        """(De)activate one unit in the dispatch indices: a lender's unit
        while it is on loan, a borrower's loan slot once it is returned.
        ``placements[unit]`` stays valid either way."""
        inactive = self.__dict__.setdefault("_inactive", set())
        if active:
            inactive.discard(unit)
        else:
            inactive.add(unit)
        self.__dict__.pop("_idx", None)

    def is_active(self, unit: int) -> bool:
        return unit not in (self.__dict__.get("_inactive") or ())

    def is_extended(self, unit: int) -> bool:
        """True for loan slots (not part of the plan's own layout)."""
        return unit in (self.__dict__.get("_extended") or ())

    def retype(self, unit: int, ptype: str) -> None:
        """Change one unit's placement type (a loan slot reused)."""
        assert ptype in PLACEMENT_TYPES
        self.placements[unit] = ptype
        self.__dict__.pop("_idx", None)

    # -- elastic-capacity overlay (core/elastic.py) --------------------------

    def decommission(self, unit: int) -> None:
        """Take one unit out of the dispatch indices (draining ahead of a
        preemption, or quarantined as slow) until ``commission``;
        ``set_active(unit, True)`` cannot bring it back.  The layout still
        owns its chips, so ``count_of_type`` counts it."""
        self.__dict__.setdefault("_decommissioned", set()).add(unit)
        self.__dict__.pop("_idx", None)

    def commission(self, unit: int) -> None:
        """Undo ``decommission`` (a quarantined unit recovering)."""
        decomm = self.__dict__.get("_decommissioned")
        if decomm is not None:
            decomm.discard(unit)
        self.__dict__.pop("_idx", None)

    def is_decommissioned(self, unit: int) -> bool:
        return unit in (self.__dict__.get("_decommissioned") or ())

    def count_of_type(self, ptype: str) -> int:
        """Count over the plan's own layout: loan slots are left out, and a
        lent-out or decommissioned unit still counts.  Dispatch uses
        ``units_of_type``, the active view."""
        ext = self.__dict__.get("_extended") or ()
        return sum(1 for g, p in enumerate(self.placements)
                   if p == ptype and g not in ext)

    def type_histogram(self) -> Dict[str, int]:
        return {t: self.count_of_type(t) for t in PLACEMENT_TYPES
                if self.count_of_type(t)}
