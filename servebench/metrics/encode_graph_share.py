"""Share of the window's launches whose Encode replayed a CUDA graph of the
encoder's pass (the ``encoder`` span inside the launch's ``encode`` span,
``graphed`` 1) rather than launching its kernels one by one (``graphed``
0). Nothing where the spans do not pair with the run, or an ``encode`` span
holds no single ``encoder`` span with the attribute (a port that records no
such thing)."""
from servebench import spans


def read(run):
    m = spans.matched(run)
    if m is None:
        return None
    flags = []
    for la in m.launches:
        kids = [c for c in m.children.get(la.encode.id, ()) if c.name == "encoder"]
        if len(kids) != 1:
            return None
        flags.append(kids[0].attrs.get("graphed"))
    if any(f not in (0, 1) for f in flags):
        return None
    return sum(flags) / len(flags)
