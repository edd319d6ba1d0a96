"""Host time of the serving loop per launch, from the port's spans: each
``serve`` span's host time less what its ``encode``, ``diffuse``,
``decode`` and ``sync`` spans cover, summed, over the launches (the
in-program twin of ``host_gap_ms``)."""
from servebench import spans


def read(run):
    m = spans.matched(run)
    if m is None:
        return None
    self_ns = 0
    for s in m.serves:
        cover = [(d.host_start_ns, d.host_end_ns) for d in m.descendants(s)
                 if d.name in spans.SERVE_COVERED]
        self_ns += (s.host_end_ns - s.host_start_ns) - spans.covered_ns(
            s.host_start_ns, s.host_end_ns, cover)
    return self_ns / 1e6 / len(run.launches)
