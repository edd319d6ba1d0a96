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

``FleetMonitor`` keeps the shared-cluster fleet's cross-pipeline windows
(core/fleet.py): demand, SLO attainment, backlog pressure and idle supply,
and the rate and class histories the demand forecaster fits.

``Monitor(array_state=True)`` keeps its samples in flat parallel columns
(``_Cols``) instead of deques of tuples, with the same window sums.

Counterpart of ``repro/core/monitor.py``.
"""
from __future__ import annotations

import collections
from typing import Deque, Dict, List, Optional, Tuple

SWITCH_RATIO = 1.5
MIN_SAMPLES = 8


class _Cols:
    """Append-only parallel sample columns with a head cursor: the
    array-state twin of a deque of tuples.  Appends go at the tail, trims
    advance the head; the dead prefix is compacted away once it dominates
    the buffer, so both stay O(1) amortized and memory stays window-bounded.
    Columns are plain lists (every consumer reads scalars, and a list append
    is cheaper than a float64 element store); values are stored untouched,
    so the window sums are the deque path's bit for bit."""

    __slots__ = ("t", "cols", "h", "n")

    def __init__(self, n_cols: int):
        self.t: List[float] = []
        self.cols: List[List[float]] = [[] for _ in range(n_cols)]
        self.h = 0          # head: index of the oldest retained sample
        self.n = 0          # tail: one past the newest sample

    def __len__(self) -> int:
        return self.n - self.h

    def append(self, t: float, *vals: float) -> None:
        h = self.h
        if h > 8192 and 2 * h > self.n:
            del self.t[:h]
            for c in self.cols:
                del c[:h]
            self.n -= h
            self.h = 0
        self.t.append(t)
        for c, v in zip(self.cols, vals):
            c.append(v)
        self.n += 1

    def head_t(self) -> Optional[float]:
        return self.t[self.h] if self.n > self.h else None


def next_boundary(*windows) -> Optional[float]:
    """Earliest future time a retained sample exits one of the given
    sliding windows (``(deque, window_length)`` pairs; empty deques are
    skipped).  The event clock (``core/clock.py``) wakes at these
    boundaries so windowed rates — and every trigger derived from them —
    are re-evaluated exactly when they can change, instead of every tick."""
    heads = [q[0][0] + win for q, win in windows if q]
    return min(heads) if heads else None


class Monitor:
    """Per-lane window tracker; ``array_state=True`` swaps the deque-of-
    tuples sample stores for flat parallel columns (``_Cols``) with stage
    and placement-type strings interned to integer codes.  The incremental
    aggregates (``_stage_counts`` / ``_ptype_sums`` / ``_ptype_counts``) are
    shared by both paths and updated with the same float adds and subtracts
    in the same order, so every query is bit-identical either way."""

    def __init__(self, t_win: float = 180.0, array_state: bool = False):
        self.t_win = t_win
        self._arr = bool(array_state)
        if self._arr:
            self._c = _Cols(3)      # (stage code, ptype code, duration)
            self._b = _Cols(2)      # (pending, idle primary)
            self._code: Dict[str, int] = {}
            self._name: List[str] = []
        else:
            self._completions: Deque[Tuple[float, str, str, float]] = \
                collections.deque()
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

    def _intern(self, s: str) -> int:
        code = self._code.get(s)
        if code is None:
            code = self._code[s] = len(self._name)
            self._name.append(s)
        return code

    # -- recording -------------------------------------------------------------

    def record_stage(self, tau: float, stage: str, ptype: str,
                     duration: float = 0.0):
        if self._arr:
            self._c.append(tau, self._intern(stage), self._intern(ptype),
                           duration)
        else:
            self._completions.append((tau, stage, ptype, duration))
        self._stage_counts[stage] += 1
        if duration > 0:
            self._ptype_sums[ptype] += duration
            self._ptype_counts[ptype] += 1
        if tau + self.t_win < self._trim_due:
            self._trim_due = tau + self.t_win
        self._trim(tau)

    def record_backlog(self, tau: float, pending: int, idle_primary: int):
        if self._arr:
            self._b.append(tau, pending, idle_primary)
        else:
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
        if self._arr:
            c = self._c
            ct, cs, cp, cd = c.t, c.cols[0], c.cols[1], c.cols[2]
            h, n = c.h, c.n
            while h < n and ct[h] < cutoff:
                self._stage_counts[self._name[int(cs[h])]] -= 1
                dur = float(cd[h])
                if dur > 0:
                    p = self._name[int(cp[h])]
                    self._ptype_sums[p] -= dur
                    self._ptype_counts[p] -= 1
                h += 1
            c.h = h
            b = self._b
            h, n, bt = b.h, b.n, b.t
            while h < n and bt[h] < cutoff:
                h += 1
            b.h = h
            heads = [t for t in (c.head_t(), b.head_t()) if t is not None]
            self._trim_due = (min(heads) + self.t_win) if heads \
                else float("inf")
            return
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
        if self._arr:
            heads = [t + self.t_win for t in (self._c.head_t(), self._b.head_t())
                     if t is not None]
            return min(heads) if heads else None
        return next_boundary((self._completions, self.t_win),
                             (self._backlog, self.t_win))

    def stage_rates(self, tau: float) -> Dict[str, float]:
        self._trim(tau)
        return {s: self._stage_counts.get(s, 0) / self.t_win for s in "EDC"}

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
        if self._arr:
            b = self._b
            if len(b) >= MIN_SAMPLES:
                bp, bi = b.cols[0], b.cols[1]
                if all(bp[j] > 2 * max(1, int(bi[j]))
                       for j in range(b.n - 1, b.n - 1 - MIN_SAMPLES, -1)):
                    trigger = True
        elif len(self._backlog) >= MIN_SAMPLES:
            it = reversed(self._backlog)
            if all(p > 2 * max(1, i)
                   for _, p, i in (next(it) for _ in range(MIN_SAMPLES))):
                trigger = True
        if trigger:
            self.last_switch = tau
        return trigger


class FleetMonitor:
    """Cross-pipeline windows for the shared-cluster fleet (core/fleet.py).

    Per-pipeline sliding-window aggregates over a heterogeneous trace:

    * *demand* — unit-time footprint of arrivals (chip-seconds of Diffuse
      work at the profiled optimal degree), the quantity the fleet
      orchestrator weights chip budgets by (the Orchestrator's demand-
      weighted VR proportions lifted one level up);
    * *SLO attainment* — windowed on-time fraction per pipeline;
    * *backlog pressure* and *idle supply* on the shorter lending window;
    * the forecaster's *rate* and *class histories* (fixed-width bins).

    ``mix_shift`` is the fleet's re-partition trigger: the windowed demand
    shares have drifted from the shares the current partition was built for
    (the *basis*) by at least the hysteresis threshold, and the swap
    cooldown has elapsed — so weight-swap cost is not paid on noise.
    Aggregates are maintained incrementally (O(1) amortized per record),
    like ``Monitor``'s: queries sit on the fleet wake-up path.
    """

    def __init__(self, t_win: float = 180.0, lend_win: float = 30.0):
        self.t_win = t_win
        self._arrivals: Deque[Tuple[float, str, float]] = collections.deque()
        self._demand: Dict[str, float] = collections.defaultdict(float)
        self._fin: Deque[Tuple[float, str, bool]] = collections.deque()
        self._fin_n: Dict[str, int] = collections.defaultdict(int)
        self._fin_on: Dict[str, int] = collections.defaultdict(int)
        self.last_repartition: float = -1e9
        # unit-lending pressure windows (core/lending.py): short sliding
        # window of (backlog-pressure, idle active units) samples per
        # pipeline — borrow/return decisions react on lend_win, not the
        # re-partition window.  Pressure is measured in queued chip-seconds
        # per owned chip (the fleet's unit-time footprint currency), so a
        # 1 req/s video pipeline minutes behind outranks a 40 req/s image
        # pipeline with a healthy sub-second queue.  Empty unless the broker
        # records into them, so the lending-off path is untouched
        # (next_window_boundary skips empties).
        self.lend_win = lend_win
        self._util: Deque[Tuple[float, str, float, int]] = collections.deque()
        self._util_bl: Dict[str, float] = collections.defaultdict(float)
        self._util_idle: Dict[str, int] = collections.defaultdict(int)
        self._util_n: Dict[str, int] = collections.defaultdict(int)
        # forecast rate history (core/forecast.py): fixed-width bins of
        # per-pipeline arrival demand, retained far beyond t_win so the
        # predictive scheduler can fit diurnal structure.  Disabled (and
        # recording nothing) unless ``enable_rate_history`` is called —
        # the default fleet path is untouched.
        self._rh_bin: float = 0.0
        self._rh_keep: int = 0
        self._rh: Dict[int, Dict[str, float]] = {}
        self._rh_lo: int = 0
        # per-placement-class demand history: same binning, keyed by the
        # placement type an arrival's auxiliary stages will demand ("E"/"C")
        # instead of by pipeline.  Disabled unless ``enable_class_history``
        # is called (predictive + cross-lane batching only).
        self._ch_bin: float = 0.0
        self._ch_keep: int = 0
        self._ch: Dict[int, Dict[str, float]] = {}
        self._ch_lo: int = 0
        # earliest time any head sample (arrival/finish on t_win, util on
        # lend_win) can exit its window — same O(1) ``_trim`` gate as the
        # lane Monitor's
        self._trim_due: float = float("inf")

    # -- recording -------------------------------------------------------------

    def enable_rate_history(self, bin_s: float, span_s: float) -> None:
        """Turn on the forecast rate history: per-pipeline arrival demand
        accumulated into ``bin_s``-wide bins, the last ``span_s`` seconds
        retained.  Called once by the predictive fleet scheduler's simulator;
        every other path leaves the history disabled and records nothing."""
        self._rh_bin = bin_s
        self._rh_keep = max(2, int(round(span_s / bin_s)))

    def enable_class_history(self, bin_s: float, span_s: float) -> None:
        """Turn on the per-placement-class demand history (the cross-lane
        batching follow-up to the per-pipeline forecast): the fleet simulator
        records each admitted request's auxiliary-stage chip-seconds under
        the placement type that stage will run on, so the predictive
        scheduler can forecast the placement-type *mix* the batcher will
        want and prioritize its pre-warm staging accordingly."""
        self._ch_bin = bin_s
        self._ch_keep = max(2, int(round(span_s / bin_s)))

    def record_class_demand(self, tau: float, cls: str, cost: float) -> None:
        """One arrival's demand (chip-seconds) against one placement class.
        No-op unless ``enable_class_history`` was called."""
        if not self._ch_bin:
            return
        b = int(tau // self._ch_bin)
        d = self._ch.setdefault(b, {})
        d[cls] = d.get(cls, 0.0) + cost
        lo = b - self._ch_keep
        while self._ch_lo < lo:
            self._ch.pop(self._ch_lo, None)
            self._ch_lo += 1

    def record_arrival(self, tau: float, pipeline: str, cost: float) -> None:
        self._arrivals.append((tau, pipeline, cost))
        self._demand[pipeline] += cost
        if self._rh_bin:
            b = int(tau // self._rh_bin)
            d = self._rh.setdefault(b, {})
            d[pipeline] = d.get(pipeline, 0.0) + cost
            # rate_history queried from bin b returns bins >= b - keep:
            # pop strictly older ones only, or the window's oldest returned
            # bin would read a spurious zero
            lo = b - self._rh_keep
            while self._rh_lo < lo:
                self._rh.pop(self._rh_lo, None)
                self._rh_lo += 1
        if tau + self.t_win < self._trim_due:
            self._trim_due = tau + self.t_win
        self._trim(tau)

    def record_finish(self, tau: float, pipeline: str, on_time: bool) -> None:
        self._fin.append((tau, pipeline, on_time))
        self._fin_n[pipeline] += 1
        self._fin_on[pipeline] += int(on_time)
        if tau + self.t_win < self._trim_due:
            self._trim_due = tau + self.t_win
        self._trim(tau)

    def record_util(self, tau: float, pipeline: str, backlog: float,
                    idle_units: int) -> None:
        """One lending-pressure sample: queued chip-seconds per owned chip
        and idle active units of one pipeline's lane at ``tau``."""
        self._util.append((tau, pipeline, backlog, idle_units))
        self._util_bl[pipeline] += backlog
        self._util_idle[pipeline] += idle_units
        self._util_n[pipeline] += 1
        if tau + self.lend_win < self._trim_due:
            self._trim_due = tau + self.lend_win
        self._trim(tau)

    def _trim(self, tau: float) -> None:
        # no head sample can exit before _trim_due (strict < comparisons
        # below) — skip the three scans in O(1) until then
        if tau <= self._trim_due:
            return
        cutoff = tau - self.t_win
        q = self._arrivals
        while q and q[0][0] < cutoff:
            _, p, c = q.popleft()
            self._demand[p] -= c
        f = self._fin
        while f and f[0][0] < cutoff:
            _, p, on = f.popleft()
            self._fin_n[p] -= 1
            self._fin_on[p] -= int(on)
        u = self._util
        lend_cut = tau - self.lend_win
        while u and u[0][0] < lend_cut:
            _, p, bl, idle = u.popleft()
            self._util_bl[p] -= bl
            self._util_idle[p] -= idle
            self._util_n[p] -= 1
        heads = [h for h in
                 ((q[0][0] + self.t_win if q else None),
                  (f[0][0] + self.t_win if f else None),
                  (u[0][0] + self.lend_win if u else None))
                 if h is not None]
        self._trim_due = min(heads) if heads else float("inf")

    # -- queries ---------------------------------------------------------------

    def demand(self, tau: float) -> Dict[str, float]:
        """Raw windowed unit-time demand (chip-seconds) per pipeline."""
        self._trim(tau)
        return {p: v for p, v in self._demand.items() if v > 0}

    def demand_shares(self, tau: float) -> Dict[str, float]:
        """Windowed unit-time demand share per pipeline (sums to 1)."""
        self._trim(tau)
        total = sum(v for v in self._demand.values() if v > 0)  # detlint: ignore[DET001] _demand dict is record-ordered (lane order): insertion-ordered
        if total <= 0:
            return {}
        return {p: max(0.0, v) / total for p, v in self._demand.items()
                if v > 0}

    def slo_attainment(self, tau: float) -> Dict[str, float]:
        self._trim(tau)
        return {p: self._fin_on[p] / self._fin_n[p]
                for p in self._fin_n if self._fin_n[p] > 0}

    def backlog_pressure(self, tau: float) -> Dict[str, float]:
        """Windowed mean backlog pressure per pipeline (lend window):
        queued chip-seconds of work per owned chip."""
        self._trim(tau)
        return {p: self._util_bl[p] / self._util_n[p]
                for p in self._util_n if self._util_n[p] > 0}

    def idle_supply(self, tau: float) -> Dict[str, float]:
        """Windowed mean idle active-unit count per pipeline (lend window)."""
        self._trim(tau)
        return {p: self._util_idle[p] / self._util_n[p]
                for p in self._util_n if self._util_n[p] > 0}

    def rate_history(self, tau: float, pipelines,
                     last: Optional[int] = None) -> List[
            Tuple[float, Dict[str, float]]]:
        """Completed forecast bins as ``(bin-center time, {pipeline:
        demand rate in chip-seconds/s})``, zero-filled for bins with no
        arrivals (no traffic *is* a rate observation — the forecaster must
        see the valleys, not just the peaks).  The bin ``tau`` falls in is
        still filling and is excluded, so the same ``tau`` always yields
        the same history in both clock modes.  ``last`` restricts the
        answer to the newest ``last`` completed bins (the predictive
        scheduler's fresh-rate confirmation needs 3, not the whole
        window).  Empty unless ``enable_rate_history`` was called."""
        if not self._rh_bin:
            return []
        cur = int(tau // self._rh_bin)
        first = max(0, cur - self._rh_keep)
        if last is not None:
            first = max(first, cur - last)
        out: List[Tuple[float, Dict[str, float]]] = []
        for b in range(first, cur):
            d = self._rh.get(b, {})
            out.append(((b + 0.5) * self._rh_bin,
                        {p: d.get(p, 0.0) / self._rh_bin for p in pipelines}))
        return out

    def class_rate_history(self, tau: float, classes,
                           last: Optional[int] = None) -> List[
            Tuple[float, Dict[str, float]]]:
        """``rate_history``'s per-placement-class twin: completed bins of
        ``{placement class: demand rate}``, zero-filled, current bin
        excluded.  Empty unless ``enable_class_history`` was called."""
        if not self._ch_bin:
            return []
        cur = int(tau // self._ch_bin)
        first = max(0, cur - self._ch_keep)
        if last is not None:
            first = max(first, cur - last)
        out: List[Tuple[float, Dict[str, float]]] = []
        for b in range(first, cur):
            d = self._ch.get(b, {})
            out.append(((b + 0.5) * self._ch_bin,
                        {c: d.get(c, 0.0) / self._ch_bin for c in classes}))
        return out

    def next_window_boundary(self) -> Optional[float]:
        return next_boundary((self._arrivals, self.t_win),
                             (self._fin, self.t_win),
                             (self._util, self.lend_win))

    def mix_shift(self, tau: float, basis: Optional[Dict[str, float]],
                  threshold: float = 0.10, cooldown: float = 120.0,
                  min_arrivals: int = 32) -> bool:
        """Has the traffic mix moved away from ``basis`` (the demand shares
        underlying the current partition) by at least ``threshold`` (total
        variation distance), past the cooldown, on enough evidence?"""
        if tau - self.last_repartition < cooldown:
            return False
        if len(self._arrivals) < min_arrivals or basis is None:
            return False
        shares = self.demand_shares(tau)
        if not shares:
            return False
        # sorted: the total-variation sum is order-sensitive in the last
        # ulp and str-set iteration follows PYTHONHASHSEED; a threshold
        # comparison must not flip run-to-run
        keys = sorted(set(shares) | set(basis))
        dist = 0.5 * sum(abs(shares.get(k, 0.0) - basis.get(k, 0.0))
                         for k in keys)
        return dist >= threshold
