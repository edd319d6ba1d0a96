"""The traced run's device trace, reduced in memory.

``Tracer`` records the window's CUDA activity with ``torch.profiler``
(CUDA only: recording every host op as well doubled sd3's host-paced step
time on the card, against about a sixth for the device activity alone)
and ``summary`` reads the raw events once: no chrome trace is written.
From the device's operations, clipped to the traced window: the seconds
in which any ran (``busy_s``), time by operation name, and K1's calls and
time. From the gaps between them: idle time by what the host was doing,
as the harness knows it: between ``serve`` calls, planning before a
call's first kernel, or inside a call by the gap's length (short gaps are
eager kernel launches, long ones dispatch rounds and stage syncs).
"""
from __future__ import annotations

import bisect
import collections
import time
from typing import Dict, List, Sequence, Tuple

import torch

K1_KERNEL = "fa_fwd_kernel"       # csrc/flash_attention.cu's kernel, any instantiation
TOP = 10
GAP_CLASSES_NS = ((100_000, "in serve: gaps under 0.1 ms"), (1_000_000, "in serve: gaps 0.1-1 ms"),
                  (10_000_000, "in serve: gaps 1-10 ms"))


class Tracer:
    """A context that profiles its body's CUDA activity; ``summary()`` afterwards."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.t0_ns = self.t1_ns = 0

    def __enter__(self):
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.t0_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.t1_ns = time.time_ns()
        self.prof.__exit__(*exc)
        return False

    def summary(self, calls_ns: Sequence[Tuple[int, int]]) -> dict:
        """``calls_ns``: each serve call's (start, end) on ``time.time_ns``."""
        return summarize(self.prof.profiler.kineto_results.events(), self.t0_ns, self.t1_ns,
                         calls_ns)


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def summarize(events, t0_ns: int, t1_ns: int, calls_ns: Sequence[Tuple[int, int]]) -> dict:
    device: List[Tuple[int, int]] = []
    by_name: Dict[str, int] = collections.Counter()
    k1_ns, k1_calls = 0, 0
    for ev in events:
        s, e = ev.start_ns(), ev.end_ns()
        # a span's copy on the device timeline is no device operation
        if ev.device_type() == torch.autograd.DeviceType.CUDA and not ev.is_user_annotation():
            s, e = max(s, t0_ns), min(e, t1_ns)
            if e <= s:
                continue
            name = ev.name()
            device.append((s, e))
            by_name[name] += e - s
            if K1_KERNEL in name:
                k1_ns += e - s
                k1_calls += 1
    busy = _union(device)
    busy_ns = sum(e - s for s, e in busy)
    gaps = [(a_end, b_start) for (_, a_end), (b_start, _) in zip(busy, busy[1:])]
    if busy:
        gaps = [(t0_ns, busy[0][0])] + gaps + [(busy[-1][1], t1_ns)]
    return {
        "window_s": (t1_ns - t0_ns) / 1e9,
        "busy_s": busy_ns / 1e9,
        "k1_s": k1_ns / 1e9,
        "k1_calls": k1_calls,
        "device_ops": [[n, t / 1e9] for n, t in by_name.most_common(TOP)],
        "idle_gaps": [[n, t / 1e9] for n, t in _label_gaps(gaps, calls_ns).most_common(TOP)],
    }


def _label_gaps(gaps: List[Tuple[int, int]], calls_ns: Sequence[Tuple[int, int]]
                ) -> collections.Counter:
    """Idle ns by where the host was at each gap's middle."""
    calls = sorted(calls_ns)
    starts = [c[0] for c in calls]
    out: collections.Counter = collections.Counter()
    for s, e in gaps:
        mid = (s + e) // 2
        i = bisect.bisect_right(starts, mid) - 1
        if i < 0 or mid >= calls[i][1]:
            label = "between serve calls"
        elif s <= calls[i][0]:
            label = "in serve: planning before its first kernel"
        else:
            label = next((name for limit, name in GAP_CLASSES_NS if e - s < limit),
                         "in serve: gaps of 10 ms or more")
        out[label] += e - s
    return out
