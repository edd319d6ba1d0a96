"""Share of the window's DDIM ``step`` spans that replayed a CUDA graph of
the step (``graphed`` 1) rather than launching its kernels one by one
(``graphed`` 0). Nothing where the spans do not pair with the run or a step
span lacks the attribute (a port that records no such thing)."""
from servebench import spans


def read(run):
    m = spans.matched(run)
    if m is None:
        return None
    flags = [s.attrs.get("graphed") for la in m.launches for s in la.steps]
    if not flags or any(f not in (0, 1) for f in flags):
        return None
    return sum(flags) / len(flags)
