"""Device time of one named part of the DDIM steps: the child of each
``step`` span that a DiT run in parts records (``double``, ``single``),
over the steps."""
from servebench import spans


def part_ms(run, name: str):
    """Mean device ms of the ``name`` spans a step; nothing where the spans
    do not pair with the run or a step has not exactly one such span (a
    DiT that records none)."""
    m = spans.matched(run)
    if m is None:
        return None
    found = [[c for c in m.children.get(s.id, ()) if c.name == name]
             for la in m.launches for s in la.steps]
    if not found or any(len(f) != 1 or f[0].device_end_ns is None for f in found):
        return None
    return sum((f[0].device_end_ns - f[0].device_start_ns) / 1e6 for f in found) / len(found)
