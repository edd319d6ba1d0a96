"""The port's shared-cluster fleet against the JAX package's, on the CPU.

Under the reference's own constant set (``REF_HW``) the port's ``run_fleet``
must give every ``FleetResult`` field bit-equal to the reference's, and every
request the same stage finish times, for the same trace and ``FleetConfig``:
the four fleet schedulers on the mix-flip trace at 64 chips, a one-pipeline
fleet, cross-lane batching on a cut of the burst storm, and each ported
``FleetConfig`` option turned on.  Each cell also asserts that the reference
run shows the mechanism the cell is there for.  Requests are compared by
position, never by ``rid``: ids come from a process-wide counter.

Also here: the grouped ILP, the cross-lane batcher's grouping and its
borrowed-unit ledger, the options of later slices (each must raise), byte
equality under two hash seeds, the serving CLI's JSON against the
reference's writers, and (marked ``slow``) the committed BENCH files
reproduced by ``serve_fleet --hw reference``.  Unit lending and elastic
capacity have their own files (``test_torch_lending.py``,
``test_torch_elastic.py``).
"""
import dataclasses
import json
import os
import random
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from repro.core import fleet as jfleet
from repro.core import ilp as jilp
from repro.core import workloads as jwl
import repro_torch.configs as TC
from repro_torch.core import fleet as tfleet
from repro_torch.core import ilp as tilp
from repro_torch.core import workloads as twl
from repro_torch.core.dispatcher import CrossLaneBatcher
from repro_torch.core.profiler import REFERENCE_HW, Profiler
from repro_torch.core.simulator import SimConfig, run_sim
from repro_torch.core.trident import TridentScheduler
from repro_torch.launch import serve_fleet
from test_torch_pipeline import REF_HW

ROOT = Path(__file__).resolve().parents[1]

# the mix-flip trace at 64 chips: the reference's shared-cluster rates at
# its load per chip, windows as the reference's determinism tests use them
FLIP_PIPES = ("sd3", "flux", "cogvideox")
FLIP_CHIPS = 64
FLIP_DURATION = 240.0
FLIP_CFG = dict(num_chips=FLIP_CHIPS, t_win=60.0, cooldown=40.0)
# a cut of the cross-batch CI scenario: its rates and pool, 300 s
XB_DURATION = 300.0
XB_HEAD = 80.0
XB_CFG = dict(num_chips=64, t_win=120.0, cooldown=100.0)


def _flip_trace(W, profs):
    rates = {p: v * FLIP_CHIPS / 512 for p, v in W.FLEET_RATES.items()}
    return W.fleet_trace(FLIP_PIPES, FLIP_DURATION, profs, seed=0,
                         rates=rates, phases=W.MIX_FLIP)


def _xb_trace(W, profs):
    return W.cross_batch_trace(XB_DURATION, profs, seed=0,
                               base_rates={"flux": 1.45, "hunyuanvideo": 0.35},
                               wave_rates={"flux": 4.6, "hunyuanvideo": 0.2},
                               head=XB_HEAD)


def run_pair(pipes, mode, duration, make_trace, cfg_kw):
    """(reference result, port result, reference trace, port trace)."""
    out = []
    for F, W, kw in ((jfleet, jwl, {}), (tfleet, twl, {"hw": REF_HW})):
        reg = F.PipelineRegistry(pipes, **kw)
        trace = make_trace(W, {p: reg.profiler(p) for p in pipes})
        res = F.run_fleet(pipes, mode=mode, duration=duration,
                          cfg=F.FleetConfig(**cfg_kw), registry=reg,
                          trace=trace)
        out.append((res, trace))
    (ref, jtrace), (port, ttrace) = out
    return ref, port, jtrace, ttrace


def _requests(trace):
    return [(r.pipeline, r.resolution, r.seconds, r.cond_len, r.arrival,
             r.deadline, sorted(r.stage_done.items())) for r in trace]


def assert_same(ref, port, jtrace, ttrace):
    """Every FleetResult field bit-equal; every request, by position, with
    the same class, deadline and stage finish times."""
    assert port.n_requests > 0
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert _requests(ttrace) == _requests(jtrace)


# -- the fleet plan -----------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_budgets_and_fleet_plan_match_the_reference(seed):
    """Node-quantized budgets from random weights (a pipeline at zero demand
    among them), and the pipeline-tagged plan Algorithm 2 builds in each."""
    rng = random.Random(seed)
    weights = {p: rng.choice((0.0, rng.uniform(0.1, 10.0))) for p in FLIP_PIPES}
    plans = []
    for F, kw in ((jfleet, {}), (tfleet, {"hw": REF_HW})):
        orch = F.FleetOrchestrator(F.PipelineRegistry(FLIP_PIPES, **kw), num_chips=128)
        budgets = orch.budgets(weights)
        plan = orch.generate({}, budgets)
        plans.append((budgets, plan.chip_ranges, plan.tagged_units(),
                      plan.type_histogram(), plan.budget_histogram()))
    assert plans[1] == plans[0]
    budgets, ranges, tags, _, hist = plans[1]
    assert hist == budgets and sum(budgets.values()) == 128
    assert all(chips >= 8 and chips % 8 == 0 for chips in budgets.values())
    assert [ranges[p] for p in FLIP_PIPES] == sorted(ranges.values())
    assert {t[0] for t in tags} == set(FLIP_PIPES)


def test_sub_plans_carry_their_pipeline_tag():
    orch = tfleet.FleetOrchestrator(tfleet.PipelineRegistry(FLIP_PIPES, hw=REF_HW),
                                    num_chips=128)
    plan = orch.generate({}, orch.budgets({"sd3": 2.0, "flux": 1.0, "cogvideox": 1.0}))
    for pid, sub in plan.subplans.items():
        assert sub.pipeline == pid
        assert sub.tagged(0) == (pid, sub.placements[0])
        assert sub.num_units * sub.unit_size == plan.budget_histogram()[pid]


# -- the four fleet schedulers on the mix flip ---------------------------------

def _mechanism(mode, res):
    """The reference run shows what the cell is there for."""
    swaps = len(res.repartitions) - 1
    if mode == "static":
        return swaps == 0
    if mode == "predictive":
        return res.predictive_repartitions >= 1 and res.prewarm_units >= 1
    return swaps >= 1


@pytest.mark.parametrize("mode", ("static", "proportional", "adaptive", "predictive"))
def test_fleet_bit_equal_on_the_mix_flip(mode):
    ref, port, jtrace, ttrace = run_pair(FLIP_PIPES, mode, FLIP_DURATION,
                                         _flip_trace, FLIP_CFG)
    assert _mechanism(mode, ref)
    assert_same(ref, port, jtrace, ttrace)


# each ported FleetConfig option turned on once, on the adaptive fleet
FLEET_OPTIONS = {"tick": {"mode": "tick", "adaptive_idle_gap": False},
                 "fixed_idle_gap": {"adaptive_idle_gap": False},
                 "scheduler_wake_hooks": {"scheduler_wake_hooks": True},
                 "idle_window_wakeups": {"idle_window_wakeups": True},
                 "slo_objective": {"budget_objective": "slo"},
                 "no_aggregate_ilp": {"aggregate_ilp": False},
                 "no_proactive_push": {"proactive_push": False},
                 "no_adjust_on_dispatch": {"adjust_on_dispatch": False},
                 "hysteresis": {"hysteresis": 0.2}}


@pytest.mark.parametrize("option", sorted(FLEET_OPTIONS))
def test_fleet_bit_equal_with_each_option(option):
    ref, port, jtrace, ttrace = run_pair(FLIP_PIPES, "adaptive", FLIP_DURATION,
                                         _flip_trace,
                                         {**FLIP_CFG, **FLEET_OPTIONS[option]})
    assert len(ref.repartitions) > 1
    assert_same(ref, port, jtrace, ttrace)


# -- the 1-pipeline special case -----------------------------------------------

def _one_trace(W, profs):
    return W.fleet_trace(("sd3",), 120.0, profs, seed=0, rates={"sd3": 10.0})


@pytest.mark.parametrize("mode", ("static", "adaptive"))
def test_one_pipeline_fleet_bit_equal(mode):
    ref, port, jtrace, ttrace = run_pair(("sd3",), mode, 120.0, _one_trace,
                                         dict(num_chips=32, t_win=60.0, cooldown=40.0))
    assert ref.repartitions[1:] == []         # one pipeline never moves chips
    assert_same(ref, port, jtrace, ttrace)


def test_one_pipeline_fleet_is_the_simulator():
    """The port's fleet with one pipeline reproduces the port's own
    Simulator + TridentScheduler: the single-pipeline system is its
    1-pipeline special case."""
    prof = Profiler(TC.get("sd3"), hw=REF_HW)
    trace = twl.make_trace("sd3", "medium", 45.0, prof, seed=3)
    base = run_sim("sd3", TridentScheduler, "medium", 45.0,
                   sim_cfg=SimConfig(num_chips=128), seed=3, hw=REF_HW)
    fleet = tfleet.run_fleet(
        ["sd3"], mode="static", trace=trace, hw=REF_HW,
        cfg=tfleet.FleetConfig(num_chips=128, adaptive_idle_gap=False,
                               aggregate_ilp=False))
    assert base.n_requests == fleet.n_requests > 0
    assert (fleet.slo_attainment, fleet.mean_latency, fleet.p95_latency,
            fleet.n_finished, fleet.sched_wakeups) == (
        base.slo_attainment, base.mean_latency, base.p95_latency,
        base.n_finished, base.sched_wakeups)


# -- cross-lane batching --------------------------------------------------------

XB_ARMS = {"off": {}, "batching": dict(cross_lane_batching=True, cross_lane_max_batch=8),
           "batching_curve_cap": dict(cross_lane_batching=True)}


@pytest.mark.parametrize("arm", sorted(XB_ARMS))
def test_cross_lane_batching_bit_equal(arm):
    ref, port, jtrace, ttrace = run_pair(twl.CROSS_BATCH_PIPELINES, "predictive",
                                         XB_DURATION, _xb_trace,
                                         {**XB_CFG, **XB_ARMS[arm]})
    assert (ref.cross_lane_merges >= 1) == (arm != "off")
    assert_same(ref, port, jtrace, ttrace)


def _stub_lane(pid, placements, unit_size=2):
    plan = SimpleNamespace(placements=placements, unit_size=unit_size)
    return SimpleNamespace(pipeline=pid, engine=SimpleNamespace(plan=plan))


def test_same_ptype_different_stage_never_merges():
    """A ⟨C⟩-typed unit hosting a warm E replica must not merge with a C
    run on the same placement type: the shape key includes the stage, so
    the two candidates land in distinct groups, each spanning one lane, and
    nothing fuses."""
    lane_a = _stub_lane("flux", {0: "C"})
    lane_b = _stub_lane("hunyuanvideo", {0: "C"})
    dec_e = SimpleNamespace(xl_candidate=("E",), e_units=(0,), c_units=())
    dec_c = SimpleNamespace(xl_candidate=("C",), e_units=(), c_units=(0,))
    batcher = CrossLaneBatcher()
    groups = batcher._collect([(lane_a, [dec_e]), (lane_b, [dec_c])])
    assert set(groups) == {("E", "C", 2), ("C", "C", 2)}
    assert all(len(g) == 1 for g in groups.values())
    cgroups = batcher.plan([(lane_a, [dec_e]), (lane_b, [dec_c])], 0.0, None)
    assert cgroups == [] and batcher.merges == 0
    assert not hasattr(dec_e, "xl_efused") and not hasattr(dec_c, "xl_cdefer")


def test_same_shape_same_stage_groups_together():
    lane_a = _stub_lane("flux", {0: "EC"})
    lane_b = _stub_lane("hunyuanvideo", {0: "EC"})
    dec_a = SimpleNamespace(xl_candidate=("E",), e_units=(0,), c_units=())
    dec_b = SimpleNamespace(xl_candidate=("E",), e_units=(0,), c_units=())
    groups = CrossLaneBatcher()._collect([(lane_a, [dec_a]), (lane_b, [dec_b])])
    assert set(groups) == {("E", "EC", 2)}
    assert len(groups[("E", "EC", 2)]) == 2


def test_fused_launch_on_a_borrowed_unit_charges_the_host_lane():
    """A fused launch spanning a loan slot (a unit at or above the host
    lane's own plan size) counts one run of its stage on the host lane's
    borrow ledger; a launch on own units, or on a lane that tracks no loans,
    counts nothing."""
    host = SimpleNamespace(base_units=4, track_borrowed=True, borrowed_stage_runs={})
    CrossLaneBatcher._charge_borrowed(host, (2, 3), "E")
    assert host.borrowed_stage_runs == {}
    CrossLaneBatcher._charge_borrowed(host, (3, 4, 5), "C")
    CrossLaneBatcher._charge_borrowed(host, (4,), "C")
    assert host.borrowed_stage_runs == {"C": 2}
    idle = SimpleNamespace(base_units=4, track_borrowed=False, borrowed_stage_runs={})
    CrossLaneBatcher._charge_borrowed(idle, (4,), "E")
    assert idle.borrowed_stage_runs == {}


def test_fused_busy_tracks_host_units_until_their_finish():
    b = CrossLaneBatcher()
    b._note_inflight("flux", (0, 1), 10.0)
    assert b.fused_busy("flux", 1, 9.0) and not b.fused_busy("flux", 2, 9.0)
    assert not b.fused_busy("flux", 1, 10.0)
    assert ("flux", 1) not in b.inflight_hosts


# -- the grouped, multi-dimensional ILP -----------------------------------------

def _grouped_instance(seed, mod):
    """Groups whose options mix plain columns and parallel-dim columns."""
    rng = random.Random(seed)
    n_dims = rng.randint(2, 3)
    budgets = [rng.randint(0, 5) for _ in range(n_dims)]
    options, counts = [], []
    for _ in range(rng.randint(1, 3)):
        opts = []
        for _ in range(rng.randint(1, 2)):
            reward = round(rng.uniform(-1.0, 10.0), 3)
            if rng.random() < 0.5:
                opts.append(mod.Option(dim=rng.randrange(n_dims),
                                       usage=rng.randint(1, 3), reward=reward))
            else:
                dims = tuple(sorted(rng.sample(range(n_dims), 2)))
                opts.append(mod.Option(dim=dims,
                                       usage=tuple(rng.randint(1, 2) for _ in dims),
                                       reward=reward))
        options.append(opts)
        counts.append(rng.randint(1, 3))
    return options, budgets, counts


@pytest.mark.parametrize("seed", range(8))
def test_solve_grouped_matches_the_reference_and_brute_force(seed):
    jopts, budgets, counts = _grouped_instance(seed, jilp)
    topts, _, _ = _grouped_instance(seed, tilp)
    want = jilp.solve_grouped(jopts, budgets, counts)
    got = tilp.solve_grouped(topts, budgets, counts)
    as_tuples = lambda alloc: {g: [(o.dim, o.usage, o.reward) for o in os_]
                               for g, os_ in alloc.items()}
    assert as_tuples(got.alloc) == as_tuples(want.alloc)
    assert (got.reward, got.nodes, got.optimal, got.n_slots) == (
        want.reward, want.nodes, want.optimal, want.n_slots)
    expanded = [opts for opts, m in zip(topts, counts) for _ in range(m)]
    assert got.optimal
    assert abs(got.reward - tilp.brute_force(expanded, budgets)) < 1e-9
    used = [0] * len(budgets)
    for g, granted in got.alloc.items():
        assert len(granted) <= counts[g]
        for o in granted:
            for d, u in tilp._spans(o):
                used[d] += u
    assert all(u <= b for u, b in zip(used, budgets))


def test_solve_grouped_caps_a_flood_at_its_capacity_bound():
    opts = [[tilp.Option(dim=0, usage=1, reward=10.0)]]
    gsol = tilp.solve_grouped(opts, budgets=[8], counts=[5000])
    assert gsol.n_slots == 8 and gsol.optimal and len(gsol.alloc[0]) == 8
    assert gsol.reward == 80.0


# -- options of later slices -----------------------------------------------------

@pytest.mark.parametrize("option", sorted(tfleet.CUT_OPTIONS))
def test_cut_fleet_options_raise(option):
    with pytest.raises(NotImplementedError, match=tfleet.CUT_OPTIONS[option]):
        tfleet.FleetConfig(**{option: True})


def test_cross_node_sp_raises():
    with pytest.raises(NotImplementedError, match="cross-node SP"):
        tfleet.PipelineRegistry(("sd3",), cross_node_sp=True)


# -- determinism ------------------------------------------------------------------

_FLEET_RUN = r"""
import dataclasses, json
from repro_torch.core import workloads
from repro_torch.core.fleet import FleetConfig, run_fleet
from repro_torch.core.profiler import REFERENCE_HW
res = run_fleet(["sd3", "cogvideox"], mode="predictive", duration=240.0,
                rates={"sd3": 10.0, "cogvideox": 0.4}, hw=REFERENCE_HW,
                phases=workloads.diurnal_phases(n_periods=3),
                cfg=FleetConfig(num_chips=64, t_win=60.0, cooldown=40.0,
                                forecast_bin=5.0, forecast_history=160.0,
                                forecast_horizon=80.0, prewarm_lead=16.0,
                                prewarm_cooldown=20.0, prewarm_ttl=60.0,
                                forecast_grace=20.0))
print(json.dumps(dataclasses.asdict(res), sort_keys=True))
"""


def test_fleet_run_is_hash_seed_deterministic():
    outs = []
    for seed in ("1", "31337"):
        env = dict(os.environ, PYTHONHASHSEED=seed, PYTHONPATH=str(ROOT / "src"))
        out = subprocess.run([sys.executable, "-c", _FLEET_RUN], capture_output=True,
                             text=True, cwd=str(ROOT), env=env, timeout=300, check=True)
        outs.append(out.stdout)
    assert outs[0] == outs[1]
    assert json.loads(outs[0])["prewarm_units"] >= 1


def test_reference_hw_is_the_reference_constant_set():
    assert REFERENCE_HW == dataclasses.replace(REF_HW, name="reference")


# -- the serving CLI's JSON against the reference's writers ----------------------

def test_shared_smoke_json_is_the_references(tmp_path):
    from benchmarks import e2e
    e2e.run_shared_smoke(bench_path=str(tmp_path / "ref.json"))
    serve_fleet.main(["--scenario", "shared", "--smoke", "--hw", "reference",
                      "--json", str(tmp_path / "port.json")])
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()


def test_cross_batch_smoke_json_is_the_references(tmp_path, capsys):
    from benchmarks import e2e
    e2e.run_cross_batch_smoke(bench_path=str(tmp_path / "ref.json"))
    runs = serve_fleet.main(["--scenario", "cross_batch", "--smoke", "--hw", "reference",
                             "--json", str(tmp_path / "port.json")])
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    assert [r.mode for r in runs] == ["off", "batching"]
    assert len(capsys.readouterr().out.splitlines()) == 2


# -- the committed BENCH files (slow: the scenarios at their own sizes) ----------

BENCH_GATE = {
    "shared": (["--scenario", "shared"], "BENCH_shared_cluster.json"),
    "predictive": (["--scenario", "predictive", "--full"], "BENCH_predictive.json"),
    "cross_batch": (["--scenario", "cross_batch"], "BENCH_cross_batch.json"),
    "lending": (["--scenario", "lending"], "BENCH_unit_lending.json"),
    "elastic": (["--scenario", "elastic", "--full"], "BENCH_elastic.json"),
}


@pytest.mark.slow
@pytest.mark.parametrize("scenario", sorted(BENCH_GATE))
def test_serve_fleet_reproduces_the_committed_bench(tmp_path, scenario):
    argv, baseline = BENCH_GATE[scenario]
    out = tmp_path / baseline
    env = dict(os.environ, PYTHONHASHSEED="31337", PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-m", "repro_torch.launch.serve_fleet", *argv,
                    "--hw", "reference", "--json", str(out)],
                   capture_output=True, text=True, cwd=str(ROOT), env=env,
                   timeout=3600, check=True)
    assert out.read_bytes() == (ROOT / baseline).read_bytes()
