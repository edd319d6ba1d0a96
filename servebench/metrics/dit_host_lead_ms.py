"""Median over the DDIM ``step`` spans of device end less host end: how far
ahead of the card the host had finished enqueueing each DiT step (near 0:
the card waited on the host)."""
from servebench import spans


def read(run):
    m = spans.matched(run)
    return None if m is None else spans.host_lead_ms([s for la in m.launches for s in la.steps])
