"""Demand forecasting for predictive fleet re-partitioning (core/fleet.py).

The adaptive fleet scheduler re-partitions only *after*
``FleetMonitor.mix_shift`` observes a demand change, so every diurnal flip
pays the full weight-reload downtime — and a detection window of
mis-partitioned serving — exactly when the new mix is already queuing.
This module supplies the missing anticipation (DiffServe-style query-aware
scaling, one level up):

* ``fit_series`` / ``SeriesFit`` — a lightweight per-pipeline demand model
  over the Monitor's windowed-rate history: an OLS linear trend, plus the
  dominant period of the detrended residuals by autocorrelation.  A
  period is *accepted* only when the one-period-back seasonal predictor
  explains the series better than the trend does (seasonal R²) — so
  square waves, tides, and any repeating shape qualify, stationary noise
  never does.
* ``DemandForecaster`` — per-pipeline fits + **seasonal-naive
  extrapolation**: a periodic pipeline's predicted rate at ``t`` is the
  (fold-averaged, 3-bin-smoothed) observed rate one or more whole periods
  earlier, which makes the predicted *phase* exact by construction — no
  harmonic approximation to mis-time a flip by half a lead window.
  Trend-only pipelines extrapolate the trend line.  ``predict_shift``
  scans the extrapolation for the next time the predicted demand shares
  drift from the model's current shares by the re-partition hysteresis
  threshold, returning both the crossing time and the *settled* new-phase
  mix (the drift maximum) that a new partition should be sized against —
  gated on a demand-weighted mean R² so stationary traffic never
  schedules a pre-warm.

Everything here is pure computation over explicit inputs: fits depend only
on the completed history bins and predictions only on (fit, tau), so the
event and tick clocks — which visit the same bin boundaries — derive
identical predictions, and every iteration order is sorted so results are
independent of ``PYTHONHASHSEED``.

Wake sources and trigger gates (the clock.py standard): this module
registers nothing itself — the fleet simulator registers the predictive
scheduler's ``forecast_wake`` closure, which answers with the next
rate-history bin boundary (fits and pre-warm staging only move there; a
fit between boundaries would see the same completed bins and return the
same answer) plus the armed predicted-shift time.  The trigger gates are
the forecaster's confidence gate (demand-weighted mean R² — stationary
traffic never schedules a pre-warm), the pre-warm cooldown, and
``forecast_grace`` (an unconfirmed shift expires; a live shift moving
away from the prediction drops it immediately).

Counterpart of ``repro/core/forecast.py``: ``stage_announced_capacity``
(pre-warming announced join capacity) waits for the elastic slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

# completed rate-history bins: (bin-center time, {key: demand rate}).
# Keys are opaque: per-pipeline demand for re-partition prediction, or
# per-placement-class demand (FleetMonitor.class_rate_history) when the
# predictive scheduler pre-warms the placement-type mix the cross-lane
# batcher will want — the fits and extrapolation are key-agnostic.
History = Sequence[Tuple[float, Dict[str, float]]]


def tv_distance(a: Dict[str, float], b: Dict[str, float]) -> float:
    """Total-variation distance between two share distributions.  Sorted
    keys: the sum is order-sensitive in the last ulp and str-set iteration
    follows PYTHONHASHSEED — a threshold comparison must not flip
    run-to-run (same rule as ``FleetMonitor.mix_shift``)."""
    keys = sorted(set(a) | set(b))
    return 0.5 * sum(abs(a.get(k, 0.0) - b.get(k, 0.0)) for k in keys)


@dataclasses.dataclass(frozen=True)
class SeriesFit:
    """One demand series' model: linear trend, and — when accepted — the
    dominant period for seasonal-naive extrapolation."""
    intercept: float
    slope: float
    period: float = 0.0                # 0.0 = no period accepted
    r2: float = 0.0                    # seasonal R² (periodic) / trend R²
    mean: float = 0.0                  # mean demand over the fitted window

    def trend(self, t: float) -> float:
        return max(0.0, self.intercept + self.slope * t)


def fit_series(ts: Sequence[float], ys: Sequence[float],
               min_autocorr: float = 0.3) -> SeriesFit:
    """Fit one demand series.

    1. OLS linear trend (and its R²).
    2. Dominant period of the detrended residuals by autocorrelation
       (lags 2..n/2, length-corrected), considered only above
       ``min_autocorr``.
    3. The period is *accepted* iff the seasonal-naive predictor — each
       sample explained by the sample one period earlier — beats the trend
       on R².  Stationary noise fails both gates (R² ~ 1/n)."""
    n = len(ys)
    mean_t = sum(ts) / n
    mean_y = sum(ys) / n
    var_t = sum((t - mean_t) ** 2 for t in ts)
    cov = sum((t - mean_t) * (y - mean_y) for t, y in zip(ts, ys))
    slope = cov / var_t if var_t > 0.0 else 0.0
    intercept = mean_y - slope * mean_t
    sst = sum((y - mean_y) ** 2 for y in ys)
    if n < 8 or sst <= 1e-12:
        # flat or tiny series: no structure worth acting on (r2 = 0)
        return SeriesFit(intercept, slope, mean=mean_y)
    sse_tr = sum((y - (intercept + slope * t)) ** 2 for t, y in zip(ts, ys))
    r2_trend = max(0.0, 1.0 - sse_tr / sst)
    resid = [y - (intercept + slope * t) for t, y in zip(ts, ys)]
    ss = sum(r * r for r in resid)
    best_lag, best_ac = 0, 0.0
    if ss > 1e-12:
        # a slowly-varying signal correlates at EVERY small lag (plateau
        # neighbours are near-equal), so the raw argmax would latch onto
        # lag 2 and call any smooth series "periodic" — only consider lags
        # past the first decorrelation dip (ac < 0), where a new peak
        # really is the waveform repeating
        dipped = False
        for lag in range(2, n // 2 + 1):
            num = sum(resid[i] * resid[i - lag] for i in range(lag, n))
            ac = (num / ss) * (n / (n - lag))   # length-corrected
            if not dipped:
                dipped = ac < 0.0
                continue
            if ac > best_ac:
                best_lag, best_ac = lag, ac
    if best_lag and best_ac >= min_autocorr:
        sse_seas = sum((ys[i] - ys[i - best_lag]) ** 2
                       for i in range(best_lag, n))
        sst_seas = sum((ys[i] - mean_y) ** 2 for i in range(best_lag, n))
        if sst_seas > 1e-12:
            r2_seas = max(0.0, 1.0 - sse_seas / sst_seas)
            if r2_seas > r2_trend:
                dt = (ts[-1] - ts[0]) / (n - 1)
                return SeriesFit(intercept, slope, period=best_lag * dt,
                                 r2=r2_seas, mean=mean_y)
    return SeriesFit(intercept, slope, r2=r2_trend, mean=mean_y)


@dataclasses.dataclass(frozen=True)
class ShiftPrediction:
    """One predicted traffic-mix shift.

    ``shares``/``demand`` describe the *settled* new phase (the point of
    maximal predicted drift after the crossing), not the mid-transition
    crossing itself — they are what a partition for the new phase should be
    sized against and what live rates are compared to when confirming."""
    t_shift: float                     # when the shares cross the threshold
    confidence: float                  # demand-weighted mean R² of the fits
    shares: Dict[str, float]           # predicted shares, settled new phase
    demand: Dict[str, float]           # predicted rates, settled new phase


class DemandForecaster:
    """Per-pipeline demand fits + the mix-shift predictor.

    ``fit`` consumes ``FleetMonitor.rate_history`` output; ``predict_shift``
    answers "when will the predicted demand shares have drifted from their
    current value by the hysteresis threshold?" — ``None`` whenever the
    fits cannot justify acting (confidence below ``min_conf``) or no
    crossing lies within the horizon.  Mis-predictions are therefore
    bounded upstream: the scheduler only ever stages pre-warm loads for a
    gated, thresholded prediction, at most once per pre-warm cooldown.
    """

    def __init__(self, bin_s: float, min_conf: float = 0.35,
                 min_autocorr: float = 0.3):
        self.bin_s = bin_s
        self.min_conf = min_conf
        self.min_autocorr = min_autocorr
        self.fits: Dict[str, SeriesFit] = {}
        self._ts: List[float] = []
        self._ys: Dict[str, List[float]] = {}

    def fit(self, history: History) -> None:
        self.fits = {}
        self._ts = [t for t, _ in history]
        self._ys = {}
        if not history:
            return
        for p in sorted(history[0][1]):
            ys = [d.get(p, 0.0) for _, d in history]
            self._ys[p] = ys
            self.fits[p] = fit_series(self._ts, ys, self.min_autocorr)

    def _seasonal_value(self, p: str, t: float) -> float:
        """Seasonal-naive rate: the fold-averaged observed rate one (and,
        when available, two) whole periods before ``t``, smoothed over
        3 bins — phase-exact because it *is* the measured waveform."""
        fit = self.fits[p]
        ts, ys = self._ts, self._ys[p]
        n = len(ys)
        dt = self.bin_s
        k = max(1, int(math.ceil((t - ts[-1]) / fit.period - 1e-9)))
        vals = []
        for fold in (k, k + 1):
            tf = t - fold * fit.period
            if tf < ts[0] - dt / 2 or tf > ts[-1] + dt / 2:
                continue
            i0 = int(round((tf - ts[0]) / dt))
            lo = max(0, i0 - 1)
            hi = min(n, i0 + 2)
            if lo < hi:
                vals.append(sum(ys[lo:hi]) / (hi - lo))
        if not vals:
            return fit.trend(t)
        return sum(vals) / len(vals)

    def predict_demand(self, t: float) -> Dict[str, float]:
        out = {}
        for p, fit in sorted(self.fits.items()):
            out[p] = (self._seasonal_value(p, t) if fit.period > 0.0
                      else fit.trend(t))
        return out

    def confidence(self) -> float:
        """Demand-weighted mean R² across the per-pipeline fits: the
        pipelines that carry the load must be the ones the model explains."""
        tot = sum(f.mean for f in self.fits.values())  # detlint: ignore[DET001] fits dict is registry-ordered; BENCH-byte-frozen
        if tot <= 0.0:
            return 0.0
        return sum(f.mean * f.r2
                   for _, f in sorted(self.fits.items())) / tot

    def predict_shift(self, tau: float, threshold: float, horizon: float,
                      step: Optional[float] = None
                      ) -> Optional[ShiftPrediction]:
        """Earliest ``t`` in ``(tau, tau + horizon]`` where the predicted
        demand shares drift from the model's *current* shares (its value at
        ``tau``) by >= ``threshold`` total variation — i.e. the next
        genuine mix shift, not a re-detection of the last one (comparing
        against the Monitor's trailing-window basis would flag "a shift is
        happening" the whole time the window is still catching up).
        ``None`` below the confidence gate or when no crossing is
        predicted."""
        if not self.fits:
            return None
        conf = self.confidence()
        if conf < self.min_conf:
            return None
        d0 = self.predict_demand(tau)
        tot0 = sum(d0.values())  # detlint: ignore[DET001] predict_demand dict is fits-ordered: insertion-ordered
        if tot0 <= 0.0:
            return None
        base = {p: v / tot0 for p, v in sorted(d0.items())}
        step = step if step is not None else self.bin_s
        t_shift = None
        best_tv = 0.0
        best: Optional[Tuple[Dict[str, float], Dict[str, float]]] = None
        k = 1
        while k * step <= horizon + 1e-9:
            t = tau + k * step
            d = self.predict_demand(t)
            tot = sum(d.values())  # detlint: ignore[DET001] predict_demand dict is fits-ordered: insertion-ordered
            if tot > 0.0:
                shares = {p: v / tot for p, v in sorted(d.items())}
                tv = tv_distance(shares, base)
                if t_shift is None:
                    if tv >= threshold:
                        t_shift = t
                        best_tv, best = tv, (shares, d)
                elif tv > best_tv:
                    # past the crossing: walk up to the settled new phase —
                    # the FIRST drift extreme (fold noise wiggles, so only
                    # a substantial fall ends the walk; a global argmax
                    # could overshoot through a whole phase into the
                    # opposite extreme of a smooth waveform)
                    best_tv, best = tv, (shares, d)
                elif tv < best_tv - threshold / 2.0:
                    break
            k += 1
        if t_shift is None or best is None:
            return None
        return ShiftPrediction(t_shift=t_shift, confidence=conf,
                               shares=best[0], demand=best[1])


def rank_classes(forecast: DemandForecaster, t: float) -> List[str]:
    """Forecast keys by descending predicted demand at ``t`` (stable
    key-ascending tiebreak — deterministic under any PYTHONHASHSEED).

    Used with a forecaster fitted on *per-placement-class* history
    (``FleetMonitor.class_rate_history``): the ranking orders the
    predictive pre-warm's staging walk so the placement types the
    cross-lane batcher will lean on hardest are staged first, inside the
    same mis-prediction budget."""
    demand = forecast.predict_demand(t)
    return [k for k, _ in sorted(demand.items(), key=lambda kv: (-kv[1],
                                                                 kv[0]))]
