"""Monitor (§5.1): clock-driven run-time statistics for the planners.

Tracks per-stage completion throughput and per-placement-type processing
rates over a sliding window T_win, plus worker status (delegated to the
engine).  Placement-switch trigger (§5.3): the fastest stage's throughput
at least 1.5x the slowest — with a secondary congestion signal (dispatch
backlog vs idle primary capacity) to catch starvation transients where
throughput ratios alone are uninformative.

Windowed aggregates (per-stage counts, per-placement busy-time sums) are
maintained incrementally on record/trim, so every query is O(1) in the
window size — this sits on the scheduler wake-up hot path.

Counterpart of ``repro/core/monitor.py`` for one pipeline: the fleet's
``FleetMonitor`` and the array-backed window columns are not ported yet.
"""
from __future__ import annotations

import collections
from typing import Deque, Dict, Optional, Tuple

SWITCH_RATIO = 1.5
MIN_SAMPLES = 8


def next_boundary(*windows) -> Optional[float]:
    """Earliest future time a retained sample exits one of the given
    sliding windows (``(deque, window_length)`` pairs; empty deques are
    skipped).  The event clock (``core/clock.py``) wakes at these
    boundaries so windowed rates — and every trigger derived from them —
    are re-evaluated exactly when they can change, instead of every tick."""
    heads = [q[0][0] + win for q, win in windows if q]
    return min(heads) if heads else None


class Monitor:
    """Per-lane window tracker."""

    def __init__(self, t_win: float = 180.0):
        self.t_win = t_win
        self._completions: Deque[Tuple[float, str, str, float]] = collections.deque()
        self._backlog: Deque[Tuple[float, int, int]] = collections.deque()
        self.last_switch: float = -1e9
        # incremental window aggregates (kept in lockstep with the samples)
        self._stage_counts: Dict[str, int] = collections.defaultdict(int)
        self._ptype_sums: Dict[str, float] = collections.defaultdict(float)
        self._ptype_counts: Dict[str, int] = collections.defaultdict(int)
        # earliest time the oldest retained sample can exit the window:
        # ``_trim`` is a strict no-op until then, so it returns in O(1)
        # off that bound instead of re-deriving it from the heads on every
        # recorded sample (``_trim`` sits on the per-sample hot path)
        self._trim_due: float = float("inf")

    # -- recording -------------------------------------------------------------

    def record_stage(self, tau: float, stage: str, ptype: str,
                     duration: float = 0.0):
        self._completions.append((tau, stage, ptype, duration))
        self._stage_counts[stage] += 1
        if duration > 0:
            self._ptype_sums[ptype] += duration
            self._ptype_counts[ptype] += 1
        if tau + self.t_win < self._trim_due:
            self._trim_due = tau + self.t_win
        self._trim(tau)

    def record_backlog(self, tau: float, pending: int, idle_primary: int):
        self._backlog.append((tau, pending, idle_primary))
        if tau + self.t_win < self._trim_due:
            self._trim_due = tau + self.t_win
        self._trim(tau)

    def _trim(self, tau: float):
        # a sample exits only when tau - t_win moves strictly past its
        # timestamp, i.e. when tau > head + t_win == _trim_due; before that
        # both scan loops below are guaranteed zero-iteration no-ops
        if tau <= self._trim_due:
            return
        cutoff = tau - self.t_win
        q = self._completions
        while q and q[0][0] < cutoff:
            _, s, p, dur = q.popleft()
            self._stage_counts[s] -= 1
            if dur > 0:
                self._ptype_sums[p] -= dur
                self._ptype_counts[p] -= 1
        b = self._backlog
        while b and b[0][0] < cutoff:
            b.popleft()
        heads = [dq[0][0] for dq in (q, b) if dq]
        self._trim_due = (min(heads) + self.t_win) if heads else float("inf")

    # -- queries ---------------------------------------------------------------

    def next_window_boundary(self) -> Optional[float]:
        """Earliest future time a retained sample exits the sliding window
        (the clock's Monitor-window wake source; see ``next_boundary``)."""
        return next_boundary((self._completions, self.t_win),
                             (self._backlog, self.t_win))

    def placement_rates(self, tau: float, plan_hist: Dict[str, int],
                        min_count: int = 8) -> Dict[str, float]:
        """v_pi: service *capacity* (1/mean busy time) per replica of each
        placement type.  Throughput-over-window would conflate idleness with
        slowness and mis-drive the Split — capacity is what balances rates."""
        self._trim(tau)
        return {p: self._ptype_counts[p] / self._ptype_sums[p]
                for p in self._ptype_counts
                if self._ptype_counts[p] >= min_count and self._ptype_sums[p] > 0}

    def pattern_change(self, tau: float, cooldown: float = 60.0) -> bool:
        if tau - self.last_switch < cooldown or tau < self.t_win / 2:
            return False   # warm-up: pipeline lag makes early ratios noise
        self._trim(tau)
        counts = self._stage_counts
        trigger = False
        if all(counts.get(s, 0) >= MIN_SAMPLES for s in "EDC"):
            rates = [counts.get(s, 0) for s in "EDC"]
            if max(rates) / min(rates) >= SWITCH_RATIO:
                trigger = True
        # congestion: backlog persistently exceeds idle primary capacity
        # (peek the newest MIN_SAMPLES right-to-left; copying the whole
        # window deque per wake-up is O(T_win))
        if len(self._backlog) >= MIN_SAMPLES:
            it = reversed(self._backlog)
            if all(p > 2 * max(1, i)
                   for _, p, i in (next(it) for _ in range(MIN_SAMPLES))):
                trigger = True
        if trigger:
            self.last_switch = tau
        return trigger
