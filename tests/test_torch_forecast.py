"""The port's demand forecaster, ``FleetMonitor`` and predictive fleet
against the JAX package's, on the CPU.

The forecaster (``fit_series``, ``DemandForecaster``, ``rank_classes``) on
the reference's own test series — square waves, tides, trends, stationary
noise — must give the same fits, confidences, demands and predicted shifts,
bit for bit, and pass the reference's own checks.  ``FleetMonitor`` over a
recorded stream of arrivals, finishes, pressure samples and class demand
must answer every query the same.  Pre-warm staging and the cutover it
feeds must charge the same reloads, and the predictive fleet on the diurnal
trace must give every ``FleetResult`` field bit-equal under the reference's
constants (``REF_HW``), with the reference run showing predictive fires and
pre-warm hits.  The predictive scenario's JSON matches the reference's
writer.
"""
import dataclasses
import math
import random

import pytest

from repro.core import fleet as jfleet
from repro.core import forecast as jfc
from repro.core import monitor as jmon
from repro.core import workloads as jwl
from repro.core.clock import EventClock as JClock
from repro_torch.core import fleet as tfleet
from repro_torch.core import forecast as tfc
from repro_torch.core import monitor as tmon
from repro_torch.core import workloads as twl
from repro_torch.core.clock import EventClock as TClock
from repro_torch.launch import serve_fleet
from test_torch_pipeline import REF_HW

BIN = 10.0
PERIOD = 300.0
SPAN = 600.0          # 2 periods of history — the minimum for detection


def _history(fn_a, fn_b, t_end, seed=0, noise=0.25):
    """The reference's synthetic completed-bin history, multiplicative noise."""
    rng = random.Random(seed)
    out = []
    b = int(max(0.0, t_end - SPAN) // BIN)
    while (b + 1) * BIN <= t_end:
        tc = (b + 0.5) * BIN
        out.append((tc, {"a": max(0.0, fn_a(tc) * (1 + rng.gauss(0, noise))),
                         "b": max(0.0, fn_b(tc) * (1 + rng.gauss(0, noise)))}))
        b += 1
    return out


def _square(t, hi=3.0, lo=0.5):
    return hi if (t % PERIOD) < PERIOD / 2 else lo


_W = 2 * math.pi / PERIOD
# (a, b, noise, (tau, horizon) queries) of the reference's forecaster tests
SERIES = {
    "square": (lambda t: _square(t), lambda t: _square(t + PERIOD / 2), 0.25,
               ((640.0, 250.0), (810.0, 250.0), (1000.0, 250.0))),
    "sinusoid": (lambda t: 2.0 + 1.5 * math.sin(_W * t),
                 lambda t: 2.0 - 1.5 * math.sin(_W * t), 0.15, ((600.0, 250.0),)),
    "trend": (lambda t: 1.0 + 0.004 * t, lambda t: 5.8 - 0.004 * t, 0.10,
              ((600.0, 400.0),)),
    "stationary": (lambda t: 2.0, lambda t: 2.0, 0.3, ((800.0, 250.0),)),
}


def _shift(pred):
    return None if pred is None else dataclasses.asdict(pred)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kind", sorted(SERIES))
def test_forecaster_matches_the_reference(kind, seed):
    fa, fb, noise, queries = SERIES[kind]
    preds = []
    for tau, horizon in queries:
        hist = _history(fa, fb, tau, seed=seed, noise=noise)
        ref = jfc.DemandForecaster(bin_s=BIN, min_conf=0.35)
        port = tfc.DemandForecaster(bin_s=BIN, min_conf=0.35)
        ref.fit(hist)
        port.fit(hist)
        assert {p: dataclasses.asdict(f) for p, f in port.fits.items()} == \
            {p: dataclasses.asdict(f) for p, f in ref.fits.items()}
        assert port.confidence() == ref.confidence()
        for t in (tau, tau + 45.0, tau + 160.0):
            assert port.predict_demand(t) == ref.predict_demand(t)
            assert tfc.rank_classes(port, t) == jfc.rank_classes(ref, t)
        want = ref.predict_shift(tau, threshold=0.10, horizon=horizon)
        got = port.predict_shift(tau, threshold=0.10, horizon=horizon)
        assert _shift(got) == _shift(want)
        preds.append((tau, got))
    # the reference's own checks, on the port
    if kind == "stationary":
        assert port.confidence() < 0.35 and preds[0][1] is None
    elif kind == "square":
        for tau, pred in preds:
            true_next = (int(tau // (PERIOD / 2)) + 1) * (PERIOD / 2)
            assert abs(pred.t_shift - true_next) <= 2 * BIN
            assert (pred.shares["a"] > 0.6) == ((true_next % PERIOD) < PERIOD / 2)
    elif kind == "sinusoid":
        true_cross = 600.0 + math.asin(8.0 * 0.10 / 3.0) / _W
        assert abs(preds[0][1].t_shift - true_cross) <= PERIOD / 4
        assert preds[0][1].shares["a"] > 0.5
    else:
        assert abs(preds[0][1].t_shift - 770.0) <= 80.0


def test_fit_series_rejects_short_lag_plateau_correlation():
    """A slowly-varying (but aperiodic) series correlates at every small
    lag; the dip-gated autocorrelation must not call it periodic."""
    ts = [(i + 0.5) * BIN for i in range(60)]
    rng = random.Random(7)
    level, ys = 2.0, []
    for _ in ts:
        level += rng.gauss(0, 0.05)
        ys.append(max(0.0, level))
    fit = tfc.fit_series(ts, ys)
    assert fit.period == 0.0
    assert dataclasses.asdict(fit) == dataclasses.asdict(jfc.fit_series(ts, ys))


def test_tv_distance_basics():
    assert tfc.tv_distance({"a": 1.0}, {"a": 1.0}) == 0.0
    assert tfc.tv_distance({"a": 1.0}, {"b": 1.0}) == 1.0
    a, b = {"a": 0.75, "b": 0.25}, {"a": 0.25, "b": 0.75}
    assert tfc.tv_distance(a, b) == jfc.tv_distance(a, b) == 0.5


# -- FleetMonitor ------------------------------------------------------------------

def _stream(seed, n=1500):
    """A recorded stream: (time, kind, args) with non-decreasing times."""
    rng = random.Random(seed)
    t, out = 0.0, []
    for _ in range(n):
        t += rng.expovariate(4.0)
        kind = rng.choice(("arrival", "arrival", "finish", "util", "class"))
        pid = rng.choice(("sd3", "flux", "cogvideox"))
        if kind == "arrival":
            out.append((t, kind, (pid, rng.uniform(0.1, 30.0))))
        elif kind == "finish":
            out.append((t, kind, (pid, rng.random() < 0.7)))
        elif kind == "util":
            out.append((t, kind, (pid, rng.uniform(0.0, 3.0), rng.randrange(8))))
        else:
            out.append((t, kind, (rng.choice("EC"), rng.uniform(0.0, 5.0))))
    return out


def _queries(mon, tau, basis):
    pids = ("sd3", "flux", "cogvideox")
    return (mon.demand(tau), mon.demand_shares(tau), mon.slo_attainment(tau),
            mon.backlog_pressure(tau), mon.idle_supply(tau),
            mon.rate_history(tau, pids), mon.rate_history(tau, pids, last=3),
            mon.class_rate_history(tau, ("E", "C")), mon.next_window_boundary(),
            mon.mix_shift(tau, basis, threshold=0.1, cooldown=30.0))


@pytest.mark.parametrize("seed", range(3))
def test_fleet_monitor_matches_the_reference_over_a_stream(seed):
    mons = []
    for M in (jmon, tmon):
        mon = M.FleetMonitor(t_win=60.0, lend_win=20.0)
        mon.enable_rate_history(5.0, 120.0)
        mon.enable_class_history(5.0, 120.0)
        mon.last_repartition = 0.0
        mons.append(mon)
    basis = {"sd3": 0.6, "flux": 0.25, "cogvideox": 0.15}
    shifts = 0
    for t, kind, args in _stream(seed):
        for mon in mons:
            if kind == "arrival":
                mon.record_arrival(t, *args)
            elif kind == "finish":
                mon.record_finish(t, *args)
            elif kind == "util":
                mon.record_util(t, *args)
            else:
                mon.record_class_demand(t, *args)
        want = _queries(mons[0], t, basis)
        assert _queries(mons[1], t, basis) == want
        shifts += want[-1]
    assert shifts > 0


def test_fleet_monitor_windows_slide_and_history_is_off_by_default():
    mon = tmon.FleetMonitor(t_win=50.0)
    assert mon.rate_history(50.0, ("sd3",)) == []
    mon.record_arrival(0.0, "sd3", 5.0)
    mon.record_finish(1.0, "sd3", True)
    mon.record_finish(2.0, "sd3", False)
    assert mon.slo_attainment(10.0)["sd3"] == 0.5
    assert mon.next_window_boundary() == 50.0
    mon.record_arrival(100.0, "flux", 2.0)   # slides the old samples out
    assert "sd3" not in mon.demand_shares(100.0)
    assert mon.slo_attainment(100.0) == {}


# -- pre-warm staging and the cutover ------------------------------------------------

def _bootstrap(F, clock_cls, monkeypatch, **cfg_kw):
    """A FleetSimulator with its plan, lanes and engines built and its clock
    never run, so staging and re-partitions can be driven by hand."""
    pipes = ("sd3", "cogvideox")
    cfg = F.FleetConfig(num_chips=128, **cfg_kw)
    registry = (F.PipelineRegistry(pipes) if F is jfleet
                else F.PipelineRegistry(pipes, hw=REF_HW))
    profs = {p: registry.profiler(p) for p in pipes}
    W = jwl if F is jfleet else twl
    trace = W.fleet_trace(pipes, 60.0, profs, seed=0,
                          rates={"sd3": 10.0, "cogvideox": 0.5})
    orch = F.FleetOrchestrator(registry, num_chips=128, chips_per_node=8)
    sim = F.FleetSimulator(registry, F.FLEET_SCHEDULERS["adaptive"](orch, cfg),
                           trace, cfg)
    monkeypatch.setattr(clock_cls, "run", lambda self, sim: None)
    sim.run()
    return sim


def _state(sim):
    return (sim.prewarm_units, sim.prewarm_cost_s, sim.prewarm_hits,
            sim.swap_cost_s, sim.units_reloaded, sorted(
                (c, p, sorted(s), t) for c, (p, s, t) in sim.prewarmed.items()),
            {pid: [u.free_at for u in lane.engine.units]
             for pid, lane in sim.lanes.items()},
            {pid: lane.engine_stats() for pid, lane in sim.lanes.items()})


@pytest.mark.parametrize("staging", ("budget_6", "all", "idle_only_busy", "expired"))
def test_stage_prewarm_and_cutover_match_the_reference(staging, monkeypatch):
    kw = {"budget_6": dict(prewarm_budget=6), "all": dict(prewarm_budget=10 ** 6),
          "idle_only_busy": dict(prewarm_budget=10 ** 6),
          "expired": dict(prewarm_budget=10 ** 6, prewarm_ttl=30.0)}[staging]
    states = []
    for F, clock_cls in ((jfleet, JClock), (tfleet, TClock)):
        sim = _bootstrap(F, clock_cls, monkeypatch, **kw)
        hist = sim.plan.budget_histogram()
        flipped = {"sd3": hist["cogvideox"], "cogvideox": hist["sd3"]}
        if staging == "idle_only_busy":
            for lane in sim.lanes.values():
                lane.engine.seed_unit_state({u.uid: 50.0 for u in lane.engine.units})
            assert sim.stage_prewarm(dict(flipped), 0.0, idle_only=True) == 0
        staged = sim.stage_prewarm(dict(flipped), 0.0)
        again = sim.stage_prewarm(dict(flipped), 0.0)
        sim._repartition(dict(flipped), 100.0 if staging == "expired" else 10.0)
        states.append((staged, again, _state(sim)))
    assert states[1] == states[0]
    staged, _, (units, cost, hits, swap, *_rest) = states[0]
    assert 0 < staged and cost > 0.0
    # staged weights avert the cutover's reloads until they expire
    assert (hits == 0) == (staging == "expired")
    assert (swap > 0.0) == (staging in ("budget_6", "expired"))


# -- the predictive fleet ------------------------------------------------------------

DIURNAL_PIPES = ("sd3", "cogvideox")
DIURNAL_CFG = dict(num_chips=64, t_win=60.0, cooldown=40.0, forecast_bin=5.0,
                   forecast_history=160.0, forecast_horizon=80.0, prewarm_lead=16.0,
                   prewarm_cooldown=20.0, prewarm_ttl=60.0, forecast_grace=20.0)


def _diurnal_pair(mode, phases_of, duration=240.0):
    out = []
    for F, W, kw in ((jfleet, jwl, {}), (tfleet, twl, {"hw": REF_HW})):
        reg = F.PipelineRegistry(DIURNAL_PIPES, **kw)
        trace = W.fleet_trace(DIURNAL_PIPES, duration,
                              {p: reg.profiler(p) for p in DIURNAL_PIPES}, seed=0,
                              rates={"sd3": 10.0, "cogvideox": 0.4}, phases=phases_of(W))
        res = F.run_fleet(DIURNAL_PIPES, mode=mode, duration=duration,
                          cfg=F.FleetConfig(**DIURNAL_CFG), registry=reg, trace=trace)
        out.append((res, [sorted(r.stage_done.items()) for r in trace]))
    return out


@pytest.mark.parametrize("mode", ("adaptive", "predictive"))
def test_diurnal_fleet_bit_equal(mode):
    (ref, jdone), (port, tdone) = _diurnal_pair(
        mode, lambda W: W.diurnal_phases(n_periods=3))
    if mode == "predictive":
        assert ref.predictive_repartitions >= 1 and ref.prewarm_hits >= 1
    else:
        assert len(ref.repartitions) > 1 and ref.prewarm_units == 0
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert tdone == jdone


def test_predictive_fleet_is_inert_on_stationary_traffic():
    (ref, jdone), (port, tdone) = _diurnal_pair("predictive", lambda W: None)
    assert port.predictive_repartitions == port.prewarm_units == 0
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert tdone == jdone


def test_forecast_wake_is_the_next_bin_or_the_armed_shift():
    orch = tfleet.FleetOrchestrator(tfleet.PipelineRegistry(("sd3",), hw=REF_HW),
                                    num_chips=64)
    sched = tfleet.PredictiveFleetScheduler(orch, tfleet.FleetConfig(forecast_bin=10.0))
    assert sched.forecast_wake(12.0) == 20.0
    sched._pred = tfc.ShiftPrediction(t_shift=15.0, confidence=1.0, shares={}, demand={})
    assert sched.forecast_wake(12.0) == 15.0


def test_predictive_json_is_the_references(tmp_path):
    """The predictive scenario's writer on a cut: two seeds, 240 s, 64 chips."""
    from benchmarks import e2e
    kw = dict(duration=240.0, periods=3, rates={"sd3": 10.0, "cogvideox": 0.4},
              fleet_cfg_kw=DIURNAL_CFG, seeds=(0, 1))
    e2e.run_predictive(bench_path=str(tmp_path / "ref.json"), **kw)
    runs = serve_fleet.run_predictive(hw=REF_HW, bench_path=str(tmp_path / "port.json"),
                                      **kw)
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    assert [(r.seed, r.mode) for r in runs] == [
        (0, "adaptive"), (0, "predictive"), (1, "adaptive"), (1, "predictive")]
