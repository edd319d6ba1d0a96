"""Spans of the port's served path, on the host's clock and the device's.

``span(name, **attrs)`` opens a span around a ``with`` block: its id, its
parent's (the span open around it on the calling thread), its attributes,
and its host start and end from ``time.time_ns``. A span given a CUDA
``device`` records two CUDA events of its own around the block; one given
``events`` reads the caller's (``device.StageTimer``'s); either way it also
holds its device start and end on the same clock, ``None`` on the CPU.
``spans()`` returns the recorded spans with their device times resolved,
and ``clear()`` empties the buffer. Counts ride on spans as attributes.

The recorder is on exactly while a ``torch.profiler`` session is active in
the process (``torch.autograd._profiler_enabled()``): a traced run records
spans, any other none. Off, ``span`` returns one shared no-op context: no
span object, no CUDA event, no lock.

Device times come from CUDA events through an anchor: one event recorded
behind a short spin kernel, so that the device reaches it after the host
has returned from recording it, and polled by the host. Its device time
lies between the last poll that found it pending and the first that found
it done; the anchor is their midpoint, its error half their distance, and
the narrowest of ``ANCHOR_TRIES`` readings is kept. (On an H100 under the
profiler, a synchronize in place of the polls put device times 30-60 us
early.) A span opened with ``anchor=device`` takes a fresh anchor
(``serve``, once a call) and keeps its error as ``anchor_err_ns``; a
device span opened before any anchor takes one itself.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

MAX_SPANS = 1 << 20         # the buffer's bound; spans past it are counted in ``dropped()``
ANCHOR_TRIES = 3
ANCHOR_SPIN_CYCLES = 200_000  # ~0.1 ms of the device's clock: longer than recording an event


@dataclasses.dataclass
class Anchor:
    """A CUDA event whose device time is ``host_ns`` on ``time.time_ns``'s
    clock, within ``err_ns``."""
    event: Any
    host_ns: int
    err_ns: int


class _Off:
    """The shared context of a span that is not recorded."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


OFF = _Off()


@dataclasses.dataclass(eq=False)
class Span:
    id: int
    name: str
    attrs: Dict[str, Any]
    parent: Optional[int] = None
    host_start_ns: int = 0
    host_end_ns: Optional[int] = None      # None while open
    device_start_ns: Optional[int] = None
    device_end_ns: Optional[int] = None
    # until resolved: the block's (start, end) CUDA events and their anchor
    events: Optional[Tuple[Any, Any]] = dataclasses.field(default=None, repr=False)
    anchor: Optional[Anchor] = dataclasses.field(default=None, repr=False)
    _rec: Optional["Recorder"] = dataclasses.field(default=None, repr=False)
    _own: bool = dataclasses.field(default=False, repr=False)
    _anchor_here: bool = dataclasses.field(default=False, repr=False)

    def set(self, **attrs) -> None:
        """Attributes known only inside the block (counts of its outcome)."""
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        rec = self._rec
        if self._anchor_here:
            self.attrs["anchor_err_ns"] = rec.take_anchor().err_ns
        elif (self._own or self.events is not None) and rec.anchor is None:
            rec.take_anchor()
        stack = rec.stack()
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        rec.buffer.append(self)
        self.host_start_ns = rec.clock()
        if self._own:
            self.events = (rec.event(), rec.event())
            self.events[0].record()
        if self.events is not None:
            self.anchor = rec.anchor
        return self

    def __exit__(self, *exc):
        rec = self._rec
        if self._own:
            self.events[1].record()
        self.host_end_ns = rec.clock()
        rec.stack().pop()
        return False

    def resolve(self) -> None:
        """Device start and end from the events, once both are recorded:
        the start read against the anchor, the end as the start plus the
        events' own interval (so the duration is the events' elapsed time)."""
        if self.events is None or self.host_end_ns is None:
            return
        start, end = self.events
        end.synchronize()
        self.device_start_ns = self.anchor.host_ns + round(
            self.anchor.event.elapsed_time(start) * 1e6)
        self.device_end_ns = self.device_start_ns + round(start.elapsed_time(end) * 1e6)
        self.events = self.anchor = None


def _cuda_event():
    return torch.cuda.Event(enable_timing=True)


def _spin():
    torch.cuda._sleep(ANCHOR_SPIN_CYCLES)


class Recorder:
    """The span buffer (at most ``limit`` spans), the device clock's anchor
    and each thread's stack of open spans. ``event`` makes a timing event,
    ``clock`` reads the host's nanoseconds, ``spin`` keeps the device busy
    for a moment."""

    def __init__(self, event: Callable[[], Any] = _cuda_event,
                 clock: Callable[[], int] = time.time_ns, spin: Callable[[], None] = _spin,
                 limit: int = MAX_SPANS):
        self.event, self.clock, self.spin, self.limit = event, clock, spin, limit
        self.buffer: List[Span] = []
        self.dropped = 0
        self.anchor: Optional[Anchor] = None
        self._ids = itertools.count()
        self._local = threading.local()

    def stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def take_anchor(self) -> Anchor:
        best = None
        for _ in range(ANCHOR_TRIES):
            ev = self.event()
            self.spin()
            lo = self.clock()
            ev.record()
            while True:
                t = self.clock()
                if ev.query():
                    break
                lo = t                      # pending when polled after t
            hi = self.clock()
            if best is None or hi - lo < 2 * best.err_ns:
                best = Anchor(ev, (lo + hi) // 2, (hi - lo) // 2)
        self.anchor = best
        return best

    def open(self, name: str, device=None, events=None, anchor=None, attrs=None):
        if len(self.buffer) >= self.limit:
            self.dropped += 1
            return OFF
        cuda = device is not None and torch.device(device).type == "cuda"
        return Span(next(self._ids), name, dict(attrs or {}), events=events, _rec=self,
                    _own=cuda and events is None,
                    _anchor_here=anchor is not None and torch.device(anchor).type == "cuda")

    def resolve(self) -> List[Span]:
        for sp in self.buffer:
            sp.resolve()
        return list(self.buffer)

    def clear(self) -> None:
        self.buffer.clear()
        self.dropped = 0
        self.anchor = None


_RECORDER = Recorder()


def span(name: str, device=None, events=None, anchor=None, **attrs):
    """A context recording the block as the span ``name`` while a profiler
    session is active, else the shared no-op ``OFF``. Either gives ``set``."""
    if not torch.autograd._profiler_enabled():
        return OFF
    return _RECORDER.open(name, device, events, anchor, attrs)


def spans() -> List[Span]:
    """Every recorded span, in the order opened, device times resolved."""
    return _RECORDER.resolve()


def dropped() -> int:
    """Spans not recorded because the buffer was full."""
    return _RECORDER.dropped


def clear() -> None:
    _RECORDER.clear()
