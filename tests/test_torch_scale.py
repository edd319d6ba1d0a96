"""The port's host-path fast paths against the JAX package's, on the CPU.

The fleet's three switches (``FleetConfig.array_state``,
``incremental_ilp``, ``step_changed_lanes_only``) must give, under the
reference's constant set (``REF_HW``), every ``FleetResult`` field and every
request's stage finish times bit-equal to ``repro.core.fleet.run_fleet`` with
the same switch: each switch alone and all three together on the
reference's randomized two-pipeline fleet (sd3 + flux, adaptive, 128 chips,
90 s, seeds 0, 3 and 7), a lending cell and an elastic cell with lane gating
on.  Each run also relates to its own switch-off run as the reference's
contract says (``tests/test_scale_parity.py``): ``array_state`` is
bit-exact; ``incremental_ilp`` keeps the headline metrics and reuses solves;
``step_changed_lanes_only`` changes the trajectory but serves the same
requests, with the same scheduler wake-ups.  Requests are compared by
position: ids come from a process-wide counter.

Also here: the single-lane simulator with ``array_state``, ``PendingSet`` and
``Monitor`` against the reference's under random operation streams,
``ilp.solve(dp=True)`` and ``solve_grouped(dp=True)`` on random instances,
the scale trace, the scale tier's smoke size through ``launch/scale.py``,
and Table 4's node counts through ``launch/dispatcher_scalability.py``; and
(marked ``slow``) the full scale tier against ``BENCH_scale.json``.
"""
import dataclasses
import functools
import importlib.util
import json
import random
from types import SimpleNamespace

import pytest

from repro.core import clock as jclock
from repro.core import fleet as jfleet
from repro.core import ilp as jilp
from repro.core import monitor as jmonitor
from repro.core import workloads as jwl
from repro.core.simulator import SimConfig as JSimConfig
from repro.core.simulator import run_sim as jrun_sim
from repro.core.trident import TridentScheduler as JTrident
from repro_torch.core import clock as tclock
from repro_torch.core import fleet as tfleet
from repro_torch.core import ilp as tilp
from repro_torch.core import monitor as tmonitor
from repro_torch.core import workloads as twl
from repro_torch.core.simulator import SimConfig as TSimConfig
from repro_torch.core.simulator import run_sim as trun_sim
from repro_torch.core.trident import TridentScheduler as TTrident
from repro_torch.launch import dispatcher_scalability, scale
from test_torch_cluster import assert_same as assert_same_sim
from test_torch_fleet import ROOT, assert_same
from test_torch_pipeline import REF_HW

SWITCHES = {
    "array_state": dict(array_state=True),
    "incremental_ilp": dict(incremental_ilp=True),
    "step_changed_lanes_only": dict(step_changed_lanes_only=True),
    "all": dict(array_state=True, incremental_ilp=True,
                step_changed_lanes_only=True),
}
SEEDS = (0, 3, 7)


def _random_fleet(F, W, kw, seed, cfg_kw):
    """The reference's randomized two-pipeline fleet (test_scale_parity)."""
    reg = F.PipelineRegistry(["sd3", "flux"], **kw)
    rates, phases = W.randomized_fleet_scenario(seed)
    trace = W.fleet_trace(["sd3", "flux"], 90.0, {p: reg.profiler(p) for p in ("sd3", "flux")},
                          seed=seed, rates=rates, phases=phases)
    cfg = F.FleetConfig(num_chips=128, t_win=60.0, cooldown=40.0, **cfg_kw)
    res = F.run_fleet(["sd3", "flux"], mode="adaptive", duration=90.0, cfg=cfg,
                      registry=reg, trace=trace)
    return res, trace


@functools.lru_cache(maxsize=None)
def _port_off(seed):
    return _random_fleet(tfleet, twl, {"hw": REF_HW}, seed, {})[0]


def _reuses(res):
    return sum(v.get("ilp_reuses", 0) for v in res.engine_stats.values())


def _relates_to_off(switch, on, off):
    """The reference's contract between a switch-on run and its switch-off
    run (tests/test_scale_parity.py)."""
    assert on.n_requests == off.n_requests
    assert on.n_finished == off.n_finished
    if switch == "array_state":
        assert dataclasses.asdict(on) == dataclasses.asdict(off)
    elif switch == "incremental_ilp":
        assert on.slo_attainment == off.slo_attainment
        assert on.goodput == off.goodput
        assert on.sched_wakeups == off.sched_wakeups
        assert on.repartitions == off.repartitions
        for pid, po in off.per_pipeline.items():
            pn = on.per_pipeline[pid]
            for k in ("requests", "finished", "on_time", "slo", "chips"):
                assert pn[k] == po[k], (pid, k)
            for k in ("mean_s", "p95_s"):
                assert pn[k] == pytest.approx(po[k], rel=0.05), (pid, k)
        assert _reuses(on) > 0 and _reuses(off) == 0
    else:
        assert on.slo_attainment == pytest.approx(off.slo_attainment, abs=0.02)
        if switch == "step_changed_lanes_only":
            # gating skips only no-op lane steps, never scheduler wake-ups
            assert on.sched_wakeups == off.sched_wakeups


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("switch", sorted(SWITCHES))
def test_fleet_switch_bit_equal_to_the_reference(switch, seed):
    ref, jtrace = _random_fleet(jfleet, jwl, {}, seed, SWITCHES[switch])
    port, ttrace = _random_fleet(tfleet, twl, {"hw": REF_HW}, seed, SWITCHES[switch])
    assert_same(ref, port, jtrace, ttrace)
    _relates_to_off(switch, port, _port_off(seed))


def test_fleet_switch_runs_are_deterministic():
    a = dataclasses.asdict(_random_fleet(tfleet, twl, {"hw": REF_HW}, 3, SWITCHES["all"])[0])
    b = dataclasses.asdict(_random_fleet(tfleet, twl, {"hw": REF_HW}, 3, SWITCHES["all"])[0])
    assert a == b


# -- lending and elastic with lane gating ------------------------------------------

LEND_PIPES = ("sd3", "cogvideox")


def _lend_fleet(F, W, kw, cfg_kw):
    reg = F.PipelineRegistry(LEND_PIPES, **kw)
    trace = W.fleet_trace(LEND_PIPES, 300.0, {p: reg.profiler(p) for p in LEND_PIPES},
                          seed=0, rates=W.LENDING_RATES, phases=W.bursty_ec_phases(300.0))
    res = F.run_fleet(LEND_PIPES, mode="adaptive", duration=300.0,
                      cfg=F.FleetConfig(num_chips=256, lending=True, **cfg_kw),
                      registry=reg, trace=trace)
    return res, trace


def _spy_dirty_marks(monkeypatch):
    """Record every ``mark_lane_dirty`` call of each package's fleet, with
    the simulated time it came at."""
    calls = {}
    for F in (jfleet, tfleet):
        calls[F] = []
        orig = F.FleetSimulator.mark_lane_dirty

        def spy(self, pid, _orig=orig, _log=calls[F]):
            _log.append((self._tau_last, pid, self._lane_gating))
            _orig(self, pid)
        monkeypatch.setattr(F.FleetSimulator, "mark_lane_dirty", spy)
    return calls[jfleet], calls[tfleet]


def test_lending_with_the_switches_bit_equal(monkeypatch):
    """Lending turns lane gating off (the broker samples every lane each
    step), so its restored ``mark_lane_dirty`` calls, made where the
    reference makes them, leave the run as it is: bit-equal to the
    reference, and ``step_changed_lanes_only`` alone changes nothing against
    the switch-off run."""
    jcalls, tcalls = _spy_dirty_marks(monkeypatch)
    ref, jtrace = _lend_fleet(jfleet, jwl, {}, SWITCHES["all"])
    port, ttrace = _lend_fleet(tfleet, twl, {"hw": REF_HW}, SWITCHES["all"])
    assert_same(ref, port, jtrace, ttrace)
    assert ref.loans > 0
    assert tcalls == jcalls and len(tcalls) >= 4 * ref.loans
    gated, _ = _lend_fleet(tfleet, twl, {"hw": REF_HW}, SWITCHES["step_changed_lanes_only"])
    off, _ = _lend_fleet(tfleet, twl, {"hw": REF_HW}, {})
    assert dataclasses.asdict(gated) == dataclasses.asdict(off)


def _elastic_fleet(F, W, kw, cfg_kw):
    """The reference's elastic gating cell (test_scale_parity)."""
    reg = F.PipelineRegistry(["sd3", "flux"], **kw)
    trace = W.fleet_trace(["sd3", "flux"], 240.0, {p: reg.profiler(p) for p in ("sd3", "flux")},
                          seed=0, rates={"sd3": 5.0, "flux": 1.0})
    sched = W.preemption_storm_schedule(240.0, 64, seed=0, n_storms=1)
    cfg = F.FleetConfig(num_chips=64, t_win=80.0, cooldown=60.0, elastic=True,
                        elastic_schedule=sched, **cfg_kw)
    res = F.run_fleet(["sd3", "flux"], mode="adaptive", duration=240.0, cfg=cfg,
                      registry=reg, trace=trace)
    return res, trace


@pytest.mark.parametrize("switch", ("step_changed_lanes_only", "all"))
def test_elastic_with_lane_gating_bit_equal(switch, monkeypatch):
    """Capacity events change a lane with no completion to show for it:
    under lane gating the restored ``mark_lane_dirty`` calls re-step it, at
    the same times and for the same lanes as the reference's."""
    jcalls, tcalls = _spy_dirty_marks(monkeypatch)
    ref, jtrace = _elastic_fleet(jfleet, jwl, {}, SWITCHES[switch])
    port, ttrace = _elastic_fleet(tfleet, twl, {"hw": REF_HW}, SWITCHES[switch])
    assert_same(ref, port, jtrace, ttrace)
    assert tcalls == jcalls and tcalls and all(gated for _, _, gated in tcalls)
    off, _ = _elastic_fleet(tfleet, twl, {"hw": REF_HW}, {})
    assert port.n_requests == off.n_requests and port.n_finished == off.n_finished
    assert port.nodes_lost == off.nodes_lost > 0
    assert port.nodes_joined == off.nodes_joined > 0
    for k in ("requeued_requests", "drained_units", "final_chips"):
        assert getattr(port, k) == getattr(off, k), k
    assert port.slo_attainment == pytest.approx(off.slo_attainment, abs=0.02)


def test_cross_lane_batching_with_incremental_ilp_bit_equal():
    """Warm grants across ticks in the cross-lane batcher's grouped solves
    (multi-dimensional options, so the search takes its span walk)."""
    out = []
    for F, W, kw in ((jfleet, jwl, {}), (tfleet, twl, {"hw": REF_HW})):
        pipes = W.CROSS_BATCH_PIPELINES
        reg = F.PipelineRegistry(pipes, **kw)
        trace = W.cross_batch_trace(300.0, {p: reg.profiler(p) for p in pipes}, seed=0,
                                    base_rates={"flux": 1.45, "hunyuanvideo": 0.35},
                                    wave_rates={"flux": 4.6, "hunyuanvideo": 0.2},
                                    head=80.0)
        cfg = F.FleetConfig(num_chips=64, t_win=120.0, cooldown=100.0,
                            cross_lane_batching=True, incremental_ilp=True)
        out.append((F.run_fleet(pipes, mode="predictive", duration=300.0, cfg=cfg,
                                registry=reg, trace=trace), trace))
    (ref, jtrace), (port, ttrace) = out
    assert_same(ref, port, jtrace, ttrace)
    assert ref.cross_lane_merges > 0


# -- the single-lane simulator ----------------------------------------------------

@pytest.mark.parametrize("workload", ("light", "medium"))
def test_single_lane_array_state_bit_equal(workload):
    ref = jrun_sim("sd3", JTrident, workload, 45.0,
                   sim_cfg=JSimConfig(num_chips=128, array_state=True), seed=2)
    port = trun_sim("sd3", TTrident, workload, 45.0,
                    sim_cfg=TSimConfig(num_chips=128, array_state=True), seed=2, hw=REF_HW)
    assert port.n_requests > 0
    assert_same_sim(ref, port)
    off = trun_sim("sd3", TTrident, workload, 45.0, sim_cfg=TSimConfig(num_chips=128),
                   seed=2, hw=REF_HW)
    a, b = dataclasses.asdict(port), dataclasses.asdict(off)
    a.pop("solver_ms")
    b.pop("solver_ms")
    assert a == b


# -- the array-backed containers ----------------------------------------------------

def test_pending_set_matches_the_reference_under_random_operations():
    """The same random stream of adds (deadline ties), removes, re-adds of
    live members (which keep their slot) and discards of absent requests
    through the reference's and the port's PendingSet, plain and
    array-backed: the deadline order, the iteration order and membership
    agree.  Removal-heavy stretches force the tombstone compaction."""
    rng = random.Random(0xE1A5)
    for _ in range(12):
        sets = [C.PendingSet(array_state=arr) for C in (jclock, tclock)
                for arr in (False, True)]
        live, rid = [], 0
        for _ in range(rng.randint(40, 140)):
            op = rng.random()
            if op < 0.5 or not live:
                r = SimpleNamespace(rid=rid, deadline=float(rng.randint(0, 9)))
                rid += 1
                live.append(r)
                for s in sets:
                    s.add(r)
            elif op < 0.8:
                r = live.pop(rng.randrange(len(live)))
                for s in sets:
                    s.remove(r)
            elif op < 0.9:
                r = rng.choice(live)
                for s in sets:
                    s.add(r)
            else:
                ghost = SimpleNamespace(rid=10 ** 6 + rid, deadline=0.0)
                for s in sets:
                    s.discard(ghost)
            cap = rng.choice((None, 1, 3, 8))
            probe = rng.choice(live) if live else SimpleNamespace(rid=-1, deadline=0.0)
            views = [([r.rid for r in s.by_deadline(cap)], [r.rid for r in s], len(s),
                      bool(s), probe in s, s.has_rid(probe.rid)) for s in sets]
            assert all(v == views[0] for v in views)
            assert views[0][2] == len(live)


def test_monitor_matches_the_reference_under_random_samples():
    """Random stage completions and backlog samples through the reference's
    and the port's Monitor, deque- and array-backed, with queries between:
    the window boundary, stage and placement rates and the switch trigger
    agree bit for bit, across window trims and the columns' compaction."""
    rng = random.Random(7)
    mons = [M.Monitor(t_win=30.0, array_state=arr) for M in (jmonitor, tmonitor)
            for arr in (False, True)]
    tau, n_stage = 0.0, 0
    for _ in range(20000):
        tau += rng.expovariate(40.0)
        if rng.random() < 0.7:
            args = (tau, rng.choice("EDC"), rng.choice(("EDC", "DC", "ED", "D", "E", "C")),
                    rng.choice((0.0, rng.uniform(0.1, 5.0))))
            n_stage += 1
            for m in mons:
                m.record_stage(*args)
        else:
            args = (tau, rng.randint(0, 40), rng.randint(0, 6))
            for m in mons:
                m.record_backlog(*args)
        if rng.random() < 0.05:
            views = [(m.next_window_boundary(), m.stage_rates(tau),
                      m.placement_rates(tau, {}), m.pattern_change(tau, cooldown=5.0))
                     for m in mons]
            assert all(v == views[0] for v in views)
    assert len(mons[3]._c.t) < n_stage        # the columns were compacted


# -- the solver's dp path -----------------------------------------------------------

def _as_tuple(o):
    return (o.dim, o.usage, o.reward)


def _same_solution(got, want):
    assert {r: _as_tuple(o) for r, o in got.choices.items()} == \
        {r: _as_tuple(o) for r, o in want.choices.items()}
    assert (got.reward, got.nodes, got.optimal) == (want.reward, want.nodes, want.optimal)


def _single_dim_instance(rng, O):
    """test_scale_parity's randomized single-dimension instances."""
    n = rng.randint(1, 10)
    dim = rng.randint(0, 2)
    budgets = [0, 0, 0]
    budgets[dim] = rng.randint(1, 60)
    options = [[O(dim=dim, usage=rng.randint(1, 12), reward=rng.uniform(0.1, 10.0))
                for _ in range(rng.randint(0, 3))] for _ in range(n)]
    return options, budgets


def _coupled_instance(rng, O):
    """Requests whose options straddle dimensions, in runs of identical
    requests: the DP declines, the canonical search runs."""
    budgets = [rng.randint(2, 12) for _ in range(3)]
    kinds = [[O(dim=rng.randint(0, 2), usage=rng.randint(1, 4),
                reward=float(rng.randint(1, 6))) for _ in range(rng.randint(1, 3))]
             for _ in range(rng.randint(1, 4))]
    return [list(rng.choice(kinds)) for _ in range(rng.randint(2, 12))], budgets


@pytest.mark.parametrize("seed", range(8))
def test_solve_dp_matches_the_reference(seed):
    rng = random.Random(seed)
    for make in (_single_dim_instance, _coupled_instance):
        for _ in range(40):
            jopts, budgets = make(rng, jilp.Option)
            topts = [[tilp.Option(o.dim, o.usage, o.reward) for o in opts] for opts in jopts]
            want = jilp.solve(jopts, budgets, time_cap=1.0, dp=True)
            got = tilp.solve(topts, budgets, time_cap=1.0, dp=True)
            _same_solution(got, want)
            plain = tilp.solve(topts, budgets, time_cap=1.0)
            assert got.reward == pytest.approx(plain.reward, rel=1e-12)
            used = [0, 0, 0]
            for o in got.choices.values():
                used[o.dim] += o.usage
            assert all(u <= b for u, b in zip(used, budgets))


def test_solve_dp_shortcuts_match_the_reference():
    cases = [
        # every dimension slack: each request's first-listed best option
        ([[(0, 2, 1.0), (0, 1, 1.0)], [(1, 2, 3.0)]], [4, 4, 0], 0),
        # per-request single dimension: decomposes into knapsacks
        ([[(0, 2, 1.0)], [(0, 2, 0.9)], [(1, 2, 1.0)]], [2, 2, 0], 0),
        # a request straddling dimensions couples the instance: the search
        ([[(0, 2, 1.0), (1, 2, 0.8)], [(0, 2, 0.9)]], [2, 2, 0], 1),
    ]
    for rows, budgets, searched in cases:
        want = jilp.solve([[jilp.Option(*o) for o in r] for r in rows], budgets,
                          time_cap=1.0, dp=True)
        got = tilp.solve([[tilp.Option(*o) for o in r] for r in rows], budgets,
                         time_cap=1.0, dp=True)
        _same_solution(got, want)
        assert got.optimal and (got.nodes > 0) == bool(searched)


@pytest.mark.parametrize("seed", range(6))
def test_solve_grouped_dp_with_warm_grants_matches_the_reference(seed):
    """Cross-lane grouped instances (tuple dimensions) with warm seeds."""
    rng = random.Random(seed)
    n_lanes = rng.randint(2, 4)
    budgets = [rng.randint(2, 10)] + [rng.randint(1, 6) for _ in range(n_lanes)]
    groups, counts, warm = [], [], {}
    for g in range(rng.randint(2, 6)):
        lane, b = rng.randint(1, n_lanes), rng.randint(1, 3)
        groups.append((lane, b, round(rng.uniform(0.5, 4.0), 3)))
        counts.append(rng.randint(1, 5))
        if rng.random() < 0.5:
            warm[g] = [((0, lane), (b, b))]
    sols = [O.solve_grouped([[O.Option(dim=(0, lane), usage=(b, b), reward=rw)]
                             for lane, b, rw in groups], budgets, counts,
                            warm=warm or None, dp=True)
            for O in (jilp, tilp)]
    want, got = sols
    assert {g: [_as_tuple(o) for o in os_] for g, os_ in got.alloc.items()} == \
        {g: [_as_tuple(o) for o in os_] for g, os_ in want.alloc.items()}
    assert (got.reward, got.nodes, got.optimal, got.n_slots) == \
        (want.reward, want.nodes, want.optimal, want.n_slots)


# -- the scale tier -----------------------------------------------------------------

def _scale_profs(F, kw):
    reg = F.PipelineRegistry(**kw)
    for pid in jwl.SCALE_PIPELINES:
        if pid not in jwl.SCALE_ALIASES:
            reg.register(pid)
    for alias, base in jwl.SCALE_ALIASES.items():
        reg.register(alias, profiler=reg.profiler(base))
    return {pid: reg.profiler(pid) for pid in jwl.SCALE_PIPELINES}


def test_scale_trace_matches_the_reference():
    assert (twl.SCALE_ALIASES, twl.SCALE_PIPELINES, twl.SCALE_BASE_CHIPS, twl.SCALE_RATES) \
        == (jwl.SCALE_ALIASES, jwl.SCALE_PIPELINES, jwl.SCALE_BASE_CHIPS, jwl.SCALE_RATES)
    for chips in (512, 4096, 1000):
        assert twl.scale_duration(2000, num_chips=chips) == \
            jwl.scale_duration(2000, num_chips=chips)
    dur = jwl.scale_duration(4000, num_chips=512)
    traces = [W.scale_trace(dur, _scale_profs(F, kw), seed=0, num_chips=512)
              for F, W, kw in ((jfleet, jwl, {}), (tfleet, twl, {"hw": REF_HW}))]
    as_rows = lambda t: [(r.pipeline, r.arrival, r.resolution, r.seconds, r.cond_len,
                          r.deadline) for r in t]
    assert as_rows(traces[1]) == as_rows(traces[0])
    assert {r.pipeline for r in traces[1]} == set(twl.SCALE_PIPELINES)


def test_scale_smoke_tier_reproduces_the_reference(tmp_path, capsys):
    """The smoke tier (512 chips, 100,000 requests) through the CLI: the
    reference's ``benchmarks/e2e.py --scale`` gives 100,361 requests, all finished,
    SLO 99.1630%, 6703 scheduler wake-ups and one re-partition."""
    run = scale.main(["--hw", "reference", "--json", str(tmp_path / "scale.json")])
    assert (run["n_requests"], run["n_finished"], run["sched_wakeups"],
            run["repartitions"]) == (100361, 100361, 6703, 1)
    assert round(run["slo"] * 100, 4) == 99.163
    # what chip_smoke.py's phase 11 holds the card's host to
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert {k: run[k] for k in smoke.SCALE_REFERENCE} == smoke.SCALE_REFERENCE
    bench = json.loads((tmp_path / "scale.json").read_text())
    committed = json.loads((ROOT / "BENCH_scale.json").read_text())
    assert set(bench) == set(committed) - {"probe", "speedup_same_tier",
                                           "speedup_extrapolated"}
    assert bench["fast_path"] == committed["fast_path"]
    assert "6703 wake-ups" in capsys.readouterr().out


@pytest.mark.slow
def test_scale_full_tier_reproduces_bench_scale(tmp_path):
    """``launch/scale.py --full --hw reference`` gives BENCH_scale.json's
    simulated fields (4096 chips, ~1M requests)."""
    scale.main(["--full", "--hw", "reference", "--json", str(tmp_path / "scale.json")])
    got = json.loads((tmp_path / "scale.json").read_text())
    want = json.loads((ROOT / "BENCH_scale.json").read_text())
    for k in ("num_chips", "pipelines", "level", "fast_path", "n_requests",
              "duration_s", "n_finished", "slo_pct", "sched_wakeups"):
        assert got[k] == want[k], k
    assert (got["n_requests"], got["n_finished"], got["slo_pct"], got["sched_wakeups"]) \
        == (1000669, 1000669, 99.94, 7895)


def test_dispatcher_scalability_node_counts_match_the_reference(capsys):
    """Table 4 through the CLI under the reference's constants: each pool
    size's dispatched count and the cold, warm and incremental solves' node
    counts, rewards and reuse are the reference script's."""
    from benchmarks import dispatcher_scalability as jtable
    want = {name: extra for name, _, extra in jtable.run(quick=True)}
    rows = dispatcher_scalability.main(["--hw", "reference"])
    assert len(rows) == 4 == len(want) // 3
    for r in rows:
        head = f"dispatcher_scalability/{r['gpus']}gpus"
        cold, warm, inc = (want[f"{head}/solve_ms"], want[f"{head}/warm_solve_ms"],
                           want[f"{head}/incremental_solve_ms"])
        assert (r["pending"], r["dispatched"]) == (cold["pending"], cold["dispatched"])
        assert r["cold"] == cold["ilp"]
        assert r["warm"] == warm["ilp"]
        assert (r["cold"]["nodes"], r["warm"]["nodes"]) == (warm["nodes_cold"],
                                                            warm["nodes_warm"])
        assert (r["incremental"]["nodes"], bool(r["incremental"].get("reused")),
                r["solve_reuses"]) == (inc["nodes"], inc["reused"], inc["solve_reuses"]) \
            == (0, True, 1)
    assert len(capsys.readouterr().out.splitlines()) == 4
