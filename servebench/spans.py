"""The port's spans of the traced window, matched to the run's calls and launches.

The port records spans (``repro_torch.trace``) while a profiler session is
active, so in the traced run those of the window. They are reached through
the module that ``program`` imports (``program.quickstart.trace``); a port
without them gives none, and every reader of them then gives nothing.

``matched(run)`` keeps the window's spans, pairs the ``serve`` spans with
the run's calls (each call's seed and number of requests) and the
``launch`` spans, in the order they opened, with ``run.launches`` (each
launch's batch, resolution, seconds and DDIM steps, one ``encode``,
``diffuse``, ``decode`` and ``sync`` each, and a ``step`` a DDIM step).
Anything else, such as a launch span more or fewer than ``run.launches``,
gives ``None``.
"""
from __future__ import annotations

import collections
import dataclasses
import statistics
from typing import Dict, Iterable, List, Optional, Tuple

from servebench import program

STAGES = ("encode", "diffuse", "decode")
SERVE_COVERED = STAGES + ("sync",)     # what a serve span's self time leaves out


def recorded() -> Optional[list]:
    """The port's recorded spans, device times resolved; None where the
    port records none."""
    tr = getattr(program.quickstart, "trace", None)
    return None if tr is None else tr.spans()


@dataclasses.dataclass
class Launch:
    encode: object
    diffuse: object
    decode: object
    steps: List[object]               # in step order


@dataclasses.dataclass
class Matched:
    serves: List[object]
    launches: List[Launch]            # run.launches' order
    children: Dict[int, List[object]]

    def descendants(self, sp) -> Iterable[object]:
        todo = list(self.children.get(sp.id, ()))
        while todo:
            c = todo.pop()
            yield c
            todo.extend(self.children.get(c.id, ()))


def matched(run) -> Optional[Matched]:
    found = recorded()
    if not found or not run.launches:
        return None
    window = [s for s in found if s.host_start_ns >= run.t0_ns and s.host_end_ns is not None]
    children: Dict[int, List[object]] = collections.defaultdict(list)
    for s in window:
        if s.parent is not None:
            children[s.parent].append(s)
    serves = sorted((s for s in window if s.name == "serve"), key=lambda s: s.host_start_ns)
    per_call = collections.Counter(r.call for r in run.requests)
    calls = [(c.seed, per_call[k]) for k, c in enumerate(run.calls)]
    if [(s.attrs.get("seed"), s.attrs.get("requests")) for s in serves] != calls:
        return None
    spans = sorted((s for s in window if s.name == "launch"), key=lambda s: s.host_start_ns)
    if len(spans) != len(run.launches):
        return None
    out = []
    for sp, la in zip(spans, run.launches):
        a = sp.attrs
        if (a.get("batch"), a.get("resolution"), a.get("seconds"), a.get("steps")) != \
                (len(la.members), la.resolution, la.seconds, la.steps):
            return None
        kids = collections.defaultdict(list)
        for c in children.get(sp.id, ()):
            kids[c.name].append(c)
        if any(len(kids[n]) != 1 for n in SERVE_COVERED):
            return None
        steps = sorted((c for c in children.get(kids["diffuse"][0].id, ()) if c.name == "step"),
                       key=lambda c: c.attrs.get("step"))
        if [c.attrs.get("step") for c in steps] != list(range(la.steps)):
            return None
        out.append(Launch(*(kids[n][0] for n in STAGES), steps))
    return Matched(serves, out, children)


def covered_ns(lo: int, hi: int, intervals: Iterable[Tuple[int, int]]) -> int:
    """Nanoseconds of [lo, hi) that the union of ``intervals`` covers."""
    total, end = 0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


def host_lead_ms(spans: List[object]) -> Optional[float]:
    """Median of device end less host end, in ms: how far ahead of the card
    the host had finished enqueueing each span's work. None without device
    times."""
    leads = [(s.device_end_ns - s.host_end_ns) / 1e6 for s in spans
             if s.device_end_ns is not None]
    if not leads or len(leads) != len(spans):
        return None
    return statistics.median(leads)
