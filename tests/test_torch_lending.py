"""The port's unit lending against the JAX package's, on the CPU.

Under the reference's constant set (``REF_HW``) a fleet with
``FleetConfig(lending=True)`` must give every ``FleetResult`` field and every
request's stage finish times bit-equal to ``repro.core.fleet.run_fleet``:
on a 300 s cut of the bursty-E/C scenario at its own 256 chips (one burst
after the 180 s sizing head) under each fleet scheduler and lending knob,
and on the cross-batch burst storm at its CI size, batching off and on.  Each cell
also asserts that the reference run grants loans and never puts a Diffuse
stage on a borrowed unit.

Also here: the fleet plan's lending map, the ``FleetMonitor`` lending
windows, the broker's wake source and its force-return deferral past a
fused launch, byte equality under two hash seeds, and the serving CLI's
lending and cross-batch narrative JSON against the reference's writers.
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
from repro.core import lending as jlending
from repro.core import monitor as jmonitor
from repro.core import workloads as jwl
from repro_torch.core import fleet as tfleet
from repro_torch.core import lending as tlending
from repro_torch.core import monitor as tmonitor
from repro_torch.core import workloads as twl
from repro_torch.launch import serve_fleet
from test_torch_fleet import assert_same, run_pair
from test_torch_pipeline import REF_HW

ROOT = Path(__file__).resolve().parents[1]

LEND_PIPES = ("sd3", "cogvideox")
LEND_CHIPS = 256
LEND_DURATION = 300.0


def _lend_trace(W, profs):
    return W.fleet_trace(LEND_PIPES, LEND_DURATION, profs, seed=0,
                         rates=W.LENDING_RATES,
                         phases=W.bursty_ec_phases(LEND_DURATION))


# the cross-batch burst storm at its CI size (serve_fleet.CROSS_BATCH_SMOKE)
XB_SMOKE = serve_fleet.CROSS_BATCH_SMOKE
XB_RATES = dict(base_rates=XB_SMOKE["base_rates"], wave_rates=XB_SMOKE["wave_rates"])


def _xb_smoke_trace(W, profs):
    return W.cross_batch_trace(XB_SMOKE["duration"], profs, seed=0,
                               head=XB_SMOKE["head"], **XB_RATES)


def _lends(res):
    """The reference run shows lending: loans granted, E/C runs on borrowed
    units, and no Diffuse among them."""
    runs = res.borrowed_stage_runs
    return res.loans > 0 and sum(runs.values()) > 0 and runs.get("D", 0) == 0


# -- the fleet plan's lending map ----------------------------------------------

def _lending_map(F, pipes, chips, weights, kw):
    reg = F.PipelineRegistry(pipes, **kw)
    orch = F.FleetOrchestrator(reg, num_chips=chips)
    plan = orch.generate({}, orch.budgets(weights))
    return {node: [dataclasses.asdict(lu) for lu in units]
            for node, units in plan.lending_map(reg).items()}


@pytest.mark.parametrize("pipes,chips", [(("sd3", "flux"), 128),
                                         (("sd3", "cogvideox"), 256),
                                         (("flux", "hunyuanvideo"), 96),
                                         (("sd3", "flux", "cogvideox"), 128)])
def test_lending_map_matches_the_reference(pipes, chips):
    weights = {p: float(i + 1) for i, p in enumerate(pipes)}
    want = _lending_map(jfleet, pipes, chips, weights, {})
    got = _lending_map(tfleet, pipes, chips, weights, {"hw": REF_HW})
    assert got == want
    assert sum(len(units) for units in got.values()) > 0


# -- FleetMonitor's lending windows --------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_fleet_monitor_lending_windows_match_the_reference(seed):
    """Backlog pressure, idle supply and the next window boundary over a
    random stream of samples from three pipelines, one of which goes quiet."""
    rng = random.Random(seed)
    mons = [M.FleetMonitor(t_win=60.0, lend_win=rng.choice((5.0, 20.0)))
            for M in (jmonitor, tmonitor)]
    for m in mons[1:]:
        m.lend_win = mons[0].lend_win
    tau = 0.0
    for i in range(200):
        tau += rng.expovariate(2.0)
        for pid in ("sd3", "flux", "cogvideox"):
            if pid == "flux" and i > 100:
                continue
            backlog = rng.choice((0.0, rng.uniform(0.0, 6.0)))
            idle = rng.randrange(0, 16)
            for m in mons:
                m.record_util(tau, pid, backlog, idle)
        if i % 7 == 0:
            probe = tau + rng.uniform(0.0, 30.0)
            got = [(m.backlog_pressure(probe), m.idle_supply(probe),
                    m.next_window_boundary()) for m in mons]
            assert got[1] == got[0]
    assert mons[1].backlog_pressure(tau)


# -- the broker's wake source --------------------------------------------------

def test_broker_next_wake_matches_the_reference():
    """Earliest min-hold expiry, else the next lending-window re-check, and
    nothing while no loan is out."""
    brokers = [(L, L.LendingBroker(F.FleetConfig(lend_min_hold=30.0, lend_win=8.0),
                                   None))
               for L, F in ((jlending, jfleet), (tlending, tfleet))]
    for tau in (0.0, 5.0):
        assert [b.next_wake(tau) for _, b in brokers] == [None, None]
    for L, b in brokers:
        for start in (0.0, 12.5, 40.0):
            b.active.append(L.Loan(lender="sd3", lender_uid=3, borrower="cogvideox",
                                   slot=9, ptype="C", start=start, borrow_cost=1.0))
    wakes = [[b.next_wake(tau) for tau in (0.0, 29.0, 30.0, 45.0, 69.0, 80.0)]
             for _, b in brokers]
    assert wakes[1] == wakes[0] == [8.0, 30.0, 38.0, 53.0, 70.0, 88.0]


# -- the lending arms on the bursty-E/C cut --------------------------------------

LEND_ARMS = {
    "adaptive": ("adaptive", {}),
    "static": ("static", {}),
    "proportional": ("proportional", {}),
    "predictive": ("predictive", {}),
    "tick": ("adaptive", {"mode": "tick", "adaptive_idle_gap": False}),
    "short_hold": ("adaptive", {"lend_min_hold": 10.0}),
    "no_reserve": ("adaptive", {"lend_reserve": 0, "lend_util_target": 0.8}),
    "few_loans": ("adaptive", {"lend_max_loans": 4}),
}


@pytest.mark.parametrize("arm", sorted(LEND_ARMS))
def test_lending_bit_equal_on_the_bursty_ec_cut(arm):
    mode, cfg = LEND_ARMS[arm]
    ref, port, jtrace, ttrace = run_pair(
        LEND_PIPES, mode, LEND_DURATION, _lend_trace,
        dict(num_chips=LEND_CHIPS, lending=True, **cfg))
    assert _lends(ref)
    assert_same(ref, port, jtrace, ttrace)


def test_lending_off_arm_bit_equal_on_the_bursty_ec_cut():
    """The scenario's other arm: the same arrivals, no broker."""
    ref, port, jtrace, ttrace = run_pair(LEND_PIPES, "adaptive", LEND_DURATION,
                                         _lend_trace, dict(num_chips=LEND_CHIPS))
    assert ref.loans == 0 and ref.borrowed_stage_runs == {}
    assert_same(ref, port, jtrace, ttrace)


# -- the cross-batch burst storm with lending ------------------------------------

XB_LEND_ARMS = {"lending": {"lending": True},
                "lending_and_batching": dict(lending=True, cross_lane_batching=True,
                                             cross_lane_max_batch=8)}


@pytest.mark.parametrize("arm", sorted(XB_LEND_ARMS))
def test_cross_batch_trace_with_lending_bit_equal(arm):
    ref, port, jtrace, ttrace = run_pair(twl.CROSS_BATCH_PIPELINES, "predictive",
                                         XB_SMOKE["duration"], _xb_smoke_trace,
                                         {**XB_SMOKE["cfg"], **XB_LEND_ARMS[arm]})
    assert _lends(ref)
    assert (ref.cross_lane_merges >= 1) == ("batching" in arm)
    assert_same(ref, port, jtrace, ttrace)


# -- force-return past a fused launch ----------------------------------------------

def _run_sim(F, W, kw, stop_at_loans=0):
    """A lending fleet on the bursty-E/C cut, run to its end, or stopped at
    the first wake-up with ``stop_at_loans`` loans out."""
    reg = F.PipelineRegistry(LEND_PIPES, **kw)
    trace = _lend_trace(W, {p: reg.profiler(p) for p in LEND_PIPES})
    cfg = F.FleetConfig(num_chips=LEND_CHIPS, lending=True)
    orch = F.FleetOrchestrator(reg, num_chips=LEND_CHIPS)
    sim = F.FleetSimulator(reg, F.FLEET_SCHEDULERS["adaptive"](orch, cfg), trace, cfg)
    if stop_at_loans:
        done = sim.done
        sim.done = lambda: len(sim.broker.active) >= stop_at_loans or done()
    sim.run()
    return sim


def test_force_return_defers_past_a_fused_launch_like_the_reference():
    """A force-return of a lent-out unit whose borrowed slot hosts an
    un-drained fused launch is deferred; the broker's next step closes it
    once the launch drains, charging the lender's reload like the
    reference's."""
    states = []
    for F, W, kw in ((jfleet, jwl, {}), (tfleet, twl, {"hw": REF_HW})):
        sim = _run_sim(F, W, kw, stop_at_loans=4)
        loan = sim.broker.active[0]
        tau = sim._tau_last
        busy = {"pinned": True}
        sim._xl = SimpleNamespace(
            fused_busy=lambda pid, g, t: busy["pinned"] and (pid, g) == (loan.borrower,
                                                                         loan.slot))
        n_loans = len(sim.broker.active)
        closed = sim.broker.force_return_unit(sim, loan.lender, loan.lender_uid, tau)
        deferred = (closed, loan.force_return_pending, len(sim.broker.active))
        busy["pinned"] = False
        sim.broker.step(sim, tau)
        lender = sim.lanes[loan.lender].engine
        states.append((n_loans, deferred, sim.broker.forced_returns,
                       sim.broker.swap_cost_s, sim.broker.borrowed_unit_seconds,
                       lender.units[loan.lender_uid].free_at,
                       lender.plan.is_active(loan.lender_uid),
                       sim.broker.unit_on_loan(loan.lender, loan.lender_uid)))
    assert states[1] == states[0]
    n_loans, deferred, forced, *_, active, on_loan = states[1]
    assert n_loans >= 4 and deferred == (False, True, n_loans)
    assert forced == 1 and active and not on_loan


def test_loan_slots_stay_out_of_the_layout_and_lent_units_inactive():
    """After a lending run with lane re-placements, every lane's layout
    histogram counts only its own units, and no lent-out unit is active in
    its lender's plan."""
    sim = _run_sim(tfleet, twl, {"hw": REF_HW})
    assert sim.broker.loans_granted > 0
    for lane in sim.lanes.values():
        plan = lane.engine.plan
        assert sum(plan.type_histogram().values()) == lane.base_units
        assert all(plan.is_extended(g) for g in range(lane.base_units, plan.num_units))
    for loan in sim.broker.active:
        assert not sim.lanes[loan.lender].engine.plan.is_active(loan.lender_uid)
        assert sim.lanes[loan.borrower].engine.plan.is_active(loan.slot)


# -- determinism -------------------------------------------------------------------

_LEND_RUN = r"""
import dataclasses, json
from repro_torch.core import workloads
from repro_torch.core.fleet import FleetConfig, run_fleet
from repro_torch.core.profiler import REFERENCE_HW
res = run_fleet(["sd3", "cogvideox"], mode="adaptive", duration=300.0,
                rates=workloads.LENDING_RATES, hw=REFERENCE_HW,
                phases=workloads.bursty_ec_phases(300.0),
                cfg=FleetConfig(num_chips=256, lending=True))
print(json.dumps(dataclasses.asdict(res), sort_keys=True))
"""


def test_lending_run_is_hash_seed_deterministic():
    outs = []
    for seed in ("1", "31337"):
        env = dict(os.environ, PYTHONHASHSEED=seed, PYTHONPATH=str(ROOT / "src"))
        out = subprocess.run([sys.executable, "-c", _LEND_RUN], capture_output=True,
                             text=True, cwd=str(ROOT), env=env, timeout=300, check=True)
        outs.append(out.stdout)
    assert outs[0] == outs[1]
    assert json.loads(outs[0])["loans"] > 0


# -- the serving CLI's JSON against the reference's writers ------------------------

def test_lending_json_is_the_references(tmp_path, capsys):
    from benchmarks import e2e
    e2e.run_lending(bench_path=str(tmp_path / "ref.json"), duration=LEND_DURATION)
    runs = serve_fleet.main(["--scenario", "lending", "--duration", repr(LEND_DURATION),
                             "--hw", "reference", "--json", str(tmp_path / "port.json")])
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    assert [r.mode for r in runs] == ["adaptive", "adaptive+lending"]
    assert runs[1].result.loans > 0
    assert "loans=" in capsys.readouterr().out.splitlines()[1]


def test_cross_batch_narrative_json_is_the_references(tmp_path):
    """The cross-batch JSON with both narrative arms, re-partitioning alone
    and unit lending, on the burst storm at its CI size."""
    from benchmarks import e2e
    kw = dict(duration=XB_SMOKE["duration"], head=XB_SMOKE["head"],
              fleet_cfg_kw=XB_SMOKE["cfg"], seeds=(0,), **XB_RATES)
    e2e.run_cross_batch(bench_path=str(tmp_path / "ref.json"), narrative_arms=True, **kw)
    runs = serve_fleet.run_cross_batch(hw=REF_HW, narrative_arms=("adaptive", "lending"),
                                       bench_path=str(tmp_path / "port.json"), **kw)
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    narrative = json.loads((tmp_path / "port.json").read_text())["narrative"]
    assert narrative["lending_loans"] > 0 and narrative["adaptive_repartitions"] >= 0
    assert [r.mode for r in runs][-2:] == ["narrative-adaptive", "narrative-lending"]
