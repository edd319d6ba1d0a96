"""The port's elastic capacity against the JAX package's, on the CPU.

Under the reference's constant set (``REF_HW``) a fleet with
``FleetConfig(elastic=True)`` must give every ``FleetResult`` field and every
request's stage finish times bit-equal to ``repro.core.fleet.run_fleet``: both
arms of the elastic scenario at its CI size (one preemption storm on 128
chips), the reference's own mechanism cells (an announced join with
pre-warm, a preemption with and without drain, a degraded node's
quarantine, a storm on a one-pipeline fleet), a region evacuation, and the
injector beside unit lending and beside cross-lane batching.  Each cell also
asserts that the reference run shows its mechanism.

Also here: ``CapacityEvent``'s validation, both schedule generators event for
event, the degrade detector, the pre-warm eviction of one unit, and the
serving CLI's elastic JSON against the reference's writer.
"""
import dataclasses
import random
from types import SimpleNamespace

import pytest

from repro.core import elastic as jelastic
from repro.core import fleet as jfleet
from repro.core import workloads as jwl
from repro_torch.core import elastic as telastic
from repro_torch.core import fleet as tfleet
from repro_torch.core import workloads as twl
from repro_torch.launch import serve_fleet
from test_torch_fleet import assert_same
from test_torch_pipeline import REF_HW

PACKAGES = ((jfleet, jwl, jelastic, {}), (tfleet, twl, telastic, {"hw": REF_HW}))


def run_pair(pipes, mode, duration, make_trace, make_cfg):
    """(reference result, port result, reference trace, port trace); the
    config is built per package, as its CapacityEvents are."""
    out = []
    for F, W, E, kw in PACKAGES:
        reg = F.PipelineRegistry(pipes, **kw)
        trace = make_trace(W, {p: reg.profiler(p) for p in pipes})
        res = F.run_fleet(pipes, mode=mode, duration=duration,
                          cfg=F.FleetConfig(**make_cfg(W, E)), registry=reg,
                          trace=trace)
        out.append((res, trace))
    (ref, jtrace), (port, ttrace) = out
    return ref, port, jtrace, ttrace


def _events(schedule):
    return [dataclasses.asdict(ev) for ev in schedule]


# -- capacity events and their schedules ----------------------------------------

@pytest.mark.parametrize("kw", [dict(t=1.0, kind="explode"),
                                dict(t=1.0, kind="join", n_nodes=2, lead=-1.0)])
def test_capacity_event_validation_matches_the_reference(kw):
    for E in (jelastic, telastic):
        with pytest.raises(AssertionError):
            E.CapacityEvent(**kw)
    ev = telastic.CapacityEvent(t=5.0, kind="preempt", nodes=(3,), lead=2.0)
    assert ev.nodes == (3,) and ev.factor == 1.0


@pytest.mark.parametrize("args", [(900.0, 256, 0, 2, 6), (480.0, 128, 0, 1, 6),
                                  (900.0, 256, 7, 2, 4), (300.0, 64, 1, 1, 6),
                                  (1200.0, 512, 3, 3, 6)])
def test_preemption_storm_schedule_matches_the_reference(args):
    duration, chips, seed, n_storms, storm_div = args
    got, want = [_events(W.preemption_storm_schedule(
        duration, chips, seed=seed, n_storms=n_storms, storm_div=storm_div))
        for W in (twl, jwl)]
    assert got == want
    assert {e["kind"] for e in got} >= {"degrade", "recover", "preempt"}


@pytest.mark.parametrize("args", [(600.0, 128, 3), (900.0, 256, 0), (300.0, 64, 5)])
def test_region_evacuation_schedule_matches_the_reference(args):
    duration, chips, seed = args
    got, want = [_events(W.region_evacuation_schedule(duration, chips, seed=seed))
                 for W in (twl, jwl)]
    assert got == want
    assert [e["kind"] for e in got] == ["degrade", "recover", "join", "preempt"]


@pytest.mark.parametrize("seed", range(3))
def test_degrade_detector_matches_the_reference(seed):
    """Suspects from a stream of completions over two work classes, one
    unit running slow."""
    rng = random.Random(seed)
    dets = [E.DegradeDetector(1.6, 4) for E in (jelastic, telastic)]
    flagged = []
    for _ in range(300):
        cls = rng.choice(((512, 0.0, 77, 1), (1024, 0.0, 77, 2)))
        g = rng.randrange(6)
        dur = rng.uniform(0.9, 1.1) * cls[0] / 512 * (2.5 if g == 3 else 1.0)
        units = (("sd3", g),) if rng.random() < 0.7 else (("sd3", g), ("sd3", (g + 1) % 6))
        got = [d.sample("sd3", "D", "EDC", dur, cls, units) for d in dets]
        assert got[1] == got[0]
        flagged += got[1]
    assert ("sd3", 3) in flagged


# -- the elastic scenario at its CI size ------------------------------------------

SMOKE = serve_fleet.ELASTIC_SMOKE
SMOKE_PIPES = serve_fleet.ELASTIC_PIPELINES


def _smoke_trace(W, profs):
    return W.fleet_trace(SMOKE_PIPES, SMOKE["duration"], profs, seed=0,
                         rates=SMOKE["rates"], level=W.ELASTIC_LEVEL)


def _smoke_cfg(drain, **extra):
    def make(W, E):
        schedule = W.preemption_storm_schedule(SMOKE["duration"],
                                               SMOKE["cfg"]["num_chips"], seed=0,
                                               n_storms=SMOKE["n_storms"])
        return dict(SMOKE["cfg"], elastic=True, elastic_schedule=schedule,
                    elastic_drain=drain, elastic_prewarm=drain, **extra)
    return make


@pytest.mark.parametrize("arm", ("drain_aware", "drain_unaware", "drain_aware_tick"))
def test_elastic_arms_bit_equal_at_the_ci_size(arm):
    drain = arm.startswith("drain_aware")
    extra = ({"mode": "tick", "adaptive_idle_gap": False} if arm.endswith("tick")
             else {})
    ref, port, jtrace, ttrace = run_pair(SMOKE_PIPES, "adaptive", SMOKE["duration"],
                                         _smoke_trace, _smoke_cfg(drain, **extra))
    assert ref.nodes_lost > 0 and ref.nodes_joined > 0
    if drain:
        assert ref.drained_units > 0 and ref.elastic_prewarm_chips > 0
    else:
        assert ref.requeued_requests > 0 and ref.drained_units == 0
    assert_same(ref, port, jtrace, ttrace)


# -- the reference's mechanism cells (one-pipeline fleets, 64 chips) -------------

def _sd3_trace(duration, rate):
    def make(W, profs):
        return W.fleet_trace(("sd3",), duration, profs, seed=0, rates={"sd3": rate})
    return make


def _one_cfg(events, drain=True):
    def make(W, E):
        return dict(num_chips=64, t_win=500.0, cooldown=500.0, elastic=True,
                    elastic_schedule=tuple(E.CapacityEvent(**ev) for ev in events),
                    elastic_drain=drain, elastic_prewarm=drain)
    return make


MECHANISM_CELLS = {
    # an announced join: the incoming chips pre-warm, the pool grows
    "join_prewarm": (150.0, 6.0, [dict(t=60.0, kind="join", n_nodes=2, lead=20.0)],
                     True, lambda r: r.nodes_joined == 2 and r.elastic_prewarm_chips == 16
                     and r.final_chips == 80),
    # a preemption with a long notice: the drain lands everything in time
    "preempt_drain": (200.0, 14.0, [dict(t=120.0, kind="preempt", nodes=(6, 7),
                                         lead=30.0)],
                      True, lambda r: r.drained_units > 0 and r.requeued_requests == 0
                      and r.final_chips == 48),
    # the same preemption, notice ignored: the loss requeues in-flight work
    "preempt_unaware": (200.0, 14.0, [dict(t=120.0, kind="preempt", nodes=(6, 7),
                                           lead=30.0)],
                        False, lambda r: r.requeued_requests > 0 and r.drained_units == 0
                        and r.n_finished == r.n_requests),
    # a 3x-slow node: detected and quarantined
    "degrade_quarantine": (240.0, 6.0, [dict(t=20.0, kind="degrade", nodes=(0,),
                                             factor=3.0)],
                           True, lambda r: r.quarantined_units == 3),
    # a degraded node that recovers: its quarantined units rejoin
    "degrade_recover": (240.0, 6.0, [dict(t=20.0, kind="degrade", nodes=(0,), factor=3.0),
                                     dict(t=150.0, kind="recover", nodes=(0,))],
                        True, lambda r: r.quarantined_units >= 1
                        and r.capacity_events == 2),
    # an empty schedule: the injector changes nothing
    "empty": (90.0, 5.0, [], True, lambda r: r.capacity_events == 0
              and r.final_chips == 64),
}


@pytest.mark.parametrize("cell", sorted(MECHANISM_CELLS))
def test_elastic_mechanism_cells_bit_equal(cell):
    duration, rate, events, drain, shows = MECHANISM_CELLS[cell]
    ref, port, jtrace, ttrace = run_pair(("sd3",), "adaptive", duration,
                                         _sd3_trace(duration, rate),
                                         _one_cfg(events, drain))
    assert shows(ref)
    assert_same(ref, port, jtrace, ttrace)


def test_elastic_storm_on_one_pipeline_bit_equal():
    def make_cfg(W, E):
        return dict(num_chips=64, t_win=500.0, cooldown=500.0, elastic=True,
                    elastic_schedule=W.preemption_storm_schedule(300.0, 64, seed=0,
                                                                 n_storms=1))
    ref, port, jtrace, ttrace = run_pair(("sd3",), "adaptive", 300.0,
                                         _sd3_trace(300.0, 8.0), make_cfg)
    assert ref.nodes_lost > 0 and ref.nodes_joined > 0
    assert_same(ref, port, jtrace, ttrace)


def test_region_evacuation_bit_equal():
    """A quarter of the pool joins, pre-warmed, then the old top quarter is
    evacuated under a long notice."""
    def make_cfg(W, E):
        return dict(SMOKE["cfg"], elastic=True,
                    elastic_schedule=W.region_evacuation_schedule(
                        SMOKE["duration"], SMOKE["cfg"]["num_chips"], seed=0))
    ref, port, jtrace, ttrace = run_pair(SMOKE_PIPES, "adaptive", SMOKE["duration"],
                                         _smoke_trace, make_cfg)
    assert ref.nodes_joined == ref.nodes_lost == 4
    assert ref.elastic_prewarm_chips > 0 and ref.drained_units > 0
    assert_same(ref, port, jtrace, ttrace)


# -- the injector beside lending and beside cross-lane batching ----------------------

def test_elastic_with_lending_bit_equal():
    """A preemption storm on the bursty-E/C cut with lending on: doomed
    lender units force-return their loans."""
    pipes, duration = ("sd3", "cogvideox"), 300.0

    def make_trace(W, profs):
        return W.fleet_trace(pipes, duration, profs, seed=0, rates=W.LENDING_RATES,
                             phases=W.bursty_ec_phases(duration))

    def make_cfg(W, E):
        return dict(num_chips=256, lending=True, elastic=True,
                    elastic_schedule=(E.CapacityEvent(t=220.0, kind="preempt",
                                                      nodes=(28, 29, 30, 31),
                                                      lead=40.0),))
    ref, port, jtrace, ttrace = run_pair(pipes, "adaptive", duration, make_trace,
                                         make_cfg)
    assert ref.loans > 0 and ref.nodes_lost == 4 and ref.drained_units > 0
    assert ref.borrowed_stage_runs.get("D", 0) == 0
    assert_same(ref, port, jtrace, ttrace)


def test_elastic_with_cross_lane_batching_bit_equal():
    """A storm on the cross-batch burst storm at its CI size with batching
    on: merged completion events carry their host units."""
    xb = serve_fleet.CROSS_BATCH_SMOKE
    pipes = twl.CROSS_BATCH_PIPELINES

    def make_trace(W, profs):
        return W.cross_batch_trace(xb["duration"], profs, seed=0, head=xb["head"],
                                   base_rates=xb["base_rates"],
                                   wave_rates=xb["wave_rates"])

    def make_cfg(W, E):
        return dict(xb["cfg"], cross_lane_batching=True, cross_lane_max_batch=8,
                    elastic=True, elastic_drain=False,
                    elastic_schedule=W.preemption_storm_schedule(
                        xb["duration"], xb["cfg"]["num_chips"], seed=0, n_storms=1))
    ref, port, jtrace, ttrace = run_pair(pipes, "predictive", xb["duration"],
                                         make_trace, make_cfg)
    assert ref.cross_lane_merges > 0 and ref.nodes_lost > 0
    assert_same(ref, port, jtrace, ttrace)


# -- the pre-warm eviction of one unit ----------------------------------------------

def test_evict_prewarm_unit_drops_only_that_units_chips():
    """A unit mutated under staged pre-warm marks loses exactly its chips'
    marks; an empty mark table stays empty."""
    marks = {c: ("sd3", frozenset({"D"}), 1.0) for c in range(16)}
    stub = SimpleNamespace(prewarmed=dict(marks),
                           plan=SimpleNamespace(unit_chips=lambda pid, g: (8, 12)))
    tfleet.FleetSimulator._evict_prewarm_unit(stub, "sd3", 1)
    assert sorted(stub.prewarmed) == [c for c in range(16) if not 8 <= c < 12]
    stub.prewarmed = {}
    tfleet.FleetSimulator._evict_prewarm_unit(stub, "sd3", 1)
    assert stub.prewarmed == {}


# -- the serving CLI's JSON against the reference's writer ---------------------------

def test_elastic_smoke_json_is_the_references(tmp_path, capsys):
    from benchmarks import e2e
    e2e.run_elastic_smoke(bench_path=str(tmp_path / "ref.json"))
    runs = serve_fleet.main(["--scenario", "elastic", "--smoke", "--hw", "reference",
                             "--json", str(tmp_path / "port.json")])
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    assert [r.mode for r in runs] == ["drain_aware", "drain_unaware"]
    assert all(r.recovery[1] > 0 for r in runs)
    assert all("recovery p95=" in line for line in capsys.readouterr().out.splitlines())
