"""Device choice for the port's entry points, and a timer for work on it."""
from __future__ import annotations

import time
from typing import Optional, Union

import torch

from repro_torch import trace

DeviceLike = Union[str, torch.device, None]


def resolve(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Asking for CUDA where there is none raises; nothing falls back
    to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def generator(device: torch.device, seed: int) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


class StageTimer:
    """Times the work enqueued inside a ``with`` block: with CUDA events on
    the card, the host clock elsewhere. ``ms()`` waits for the end event.
    Given a ``span`` name, a traced run records the block as that span,
    whose device interval is the timer's own two events."""

    def __init__(self, dev: torch.device, span: Optional[str] = None):
        self.cuda = dev.type == "cuda"
        self.span = span

    def __enter__(self):
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
        self._span = (trace.span(self.span, events=(self.start, self.end) if self.cuda else None)
                      if self.span else trace.OFF)
        self._span.__enter__()
        if self.cuda:
            self.start.record()
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.end.record()
        else:
            self.host_ms = (time.perf_counter() - self.t0) * 1e3
        self._span.__exit__(*exc)
        return False

    def ms(self) -> float:
        if self.cuda:
            self.end.synchronize()
            return self.start.elapsed_time(self.end)
        return self.host_ms
