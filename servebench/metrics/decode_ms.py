"""Decode's device time per launch: the mean length of the ``decode`` spans'
device intervals (the stage timer's own events, so the records'
stage_ms["C"])."""
from servebench import spans


def read(run):
    m = spans.matched(run)
    if m is None or any(la.decode.device_end_ns is None for la in m.launches):
        return None
    return sum((la.decode.device_end_ns - la.decode.device_start_ns) / 1e6
               for la in m.launches) / len(m.launches)
