"""The port's cluster path against the JAX package's, on the CPU.

Under the reference's own constant set (``REF_HW``) the port's ``run_sim``
must give every deterministic ``SimResult`` field bit-equal to the
reference's: trident and B1-B6 over the four pipelines and the five
workloads, the event-clock scenarios of ``BENCH_event_sim.json``, each
ported ``SimConfig`` option and each trident ablation turned on. Both sides
are pure host Python over the same cost model. Requests are compared by
position, never by ``rid``: ids come from a process-wide counter.

Also here: the profiler's methods this slice adds, the serving CLI, byte
equality under two hash seeds, the determinism lint over the port's core,
and ``H100_SXM`` held to the card readings it was fitted to.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

import repro.configs as JC
from repro.core import profiler as jprof
from repro.core import workloads as jwl
from repro.core.baselines import BASELINES as JBASELINES
from repro.core.request import Request as JRequest
from repro.core.simulator import SimConfig as JSimConfig
from repro.core.simulator import Simulator as JSimulator
from repro.core.simulator import run_sim as jrun_sim
from repro.core.trident import TridentScheduler as JTrident
import repro_torch.configs as TC
from repro_torch.core import profiler as tprof
from repro_torch.core import workloads as twl
from repro_torch.core.baselines import BASELINES as TBASELINES
from repro_torch.core.request import Request as TRequest
from repro_torch.core.simulator import SimConfig as TSimConfig
from repro_torch.core.simulator import Simulator as TSimulator
from repro_torch.core.simulator import run_sim as trun_sim
from repro_torch.core.trident import TridentScheduler as TTrident
from repro_torch.launch import calibrate
from test_torch_pipeline import REF_HW
from tools.detlint.engine import lint_paths

ROOT = Path(__file__).resolve().parents[1]
PIPELINES = TC.PIPELINE_IDS
WORKLOADS = ("light", "medium", "heavy", "dynamic", "proprietary")
SCHEDULERS = ("trident",) + tuple(TBASELINES)
# trace lengths: long enough for a re-placement window where one fits,
# short enough to keep the file within a minute and a half on one worker
DURATION = {"sd3": 120.0, "flux": 300.0, "cogvideox": 300.0, "hunyuanvideo": 600.0}


def _classes(name):
    if name == "trident":
        return JTrident, TTrident
    return JBASELINES[name], TBASELINES[name]


def _deterministic(res) -> dict:
    """Every SimResult field but the wall-clock ``solver_ms`` and the
    port's own ``degree_histogram`` (the reference has no such field)."""
    out = dataclasses.asdict(res)
    out.pop("solver_ms")
    out.pop("degree_histogram", None)
    return out


def assert_same(ref, port):
    """Bit-equal deterministic fields. The reference's engine counts what
    the fleet, lending and incremental-ILP paths do (pre-warm loads, solve
    reuses); the port has no such paths, so those counters must read 0."""
    want, got = _deterministic(ref), _deterministic(port)
    want_stats, got_stats = want.pop("engine_stats"), got.pop("engine_stats")
    assert got == want
    assert got_stats == {k: want_stats[k] for k in got_stats}
    assert all(want_stats[k] == 0 for k in set(want_stats) - set(got_stats))


@pytest.mark.parametrize("scheduler", SCHEDULERS)
@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("pipeline", PIPELINES)
def test_run_sim_bit_equal(pipeline, workload, scheduler):
    jcls, tcls = _classes(scheduler)
    ref = jrun_sim(pipeline, jcls, workload, DURATION[pipeline])
    port = trun_sim(pipeline, tcls, workload, DURATION[pipeline], hw=REF_HW)
    assert port.n_requests > 0
    assert_same(ref, port)


@pytest.mark.parametrize("scheduler", SCHEDULERS)
@pytest.mark.parametrize("pipeline", PIPELINES)
def test_run_sim_bit_equal_on_a_loaded_cluster(pipeline, scheduler):
    """32 chips on the dynamic workload: queues build, trident re-places
    and Adjust-on-Dispatch loads replicas."""
    jcls, tcls = _classes(scheduler)
    dur = 60.0 if pipeline == "sd3" else DURATION[pipeline]
    ref = jrun_sim(pipeline, jcls, "dynamic", dur, sim_cfg=JSimConfig(num_chips=32))
    port = trun_sim(pipeline, tcls, "dynamic", dur, sim_cfg=TSimConfig(num_chips=32),
                    hw=REF_HW)
    assert_same(ref, port)


def test_loaded_cluster_exercises_replacement():
    """The loaded cells above are the ones that re-place: hold that they do,
    so the parity covers ``maybe_replace`` and Adjust-on-Dispatch."""
    res = trun_sim("flux", TTrident, "dynamic", DURATION["flux"],
                   sim_cfg=TSimConfig(num_chips=32), hw=REF_HW)
    assert len(res.placement_switches) > 1
    assert res.engine_stats["placement_switches"] == len(res.placement_switches) - 1


# BENCH_event_sim.json's scenarios: (pipeline, scheduler, workload, seconds, rate)
BENCH_SCENARIOS = [tuple(s) for s in json.loads(
    (ROOT / "BENCH_event_sim.json").read_text())["scenarios"]]


@pytest.mark.parametrize("scenario", BENCH_SCENARIOS, ids=lambda s: "-".join(map(str, s)))
def test_event_sim_bench_scenarios_bit_equal(scenario):
    pipeline, scheduler, workload, duration, rate = scenario
    jcls, tcls = _classes(scheduler)
    ref = jrun_sim(pipeline, jcls, workload, duration, rate=rate)
    port = trun_sim(pipeline, tcls, workload, duration, rate=rate, hw=REF_HW)
    assert_same(ref, port)


# each ported SimConfig option, and each trident ablation, turned on once
SIM_OPTIONS = {"tick": {"mode": "tick"}, "adaptive_idle_gap": {"adaptive_idle_gap": True},
               "idle_window_wakeups": {"idle_window_wakeups": True},
               "scheduler_wake_hooks": {"scheduler_wake_hooks": True},
               "no_proactive_push": {"proactive_push": False},
               "no_adjust_on_dispatch": {"adjust_on_dispatch": False},
               "downtime_adjust": {"downtime_adjust": True}}
ABLATIONS = ("enable_switch", "stage_aware", "use_ilp", "enable_batching")
# flux on 32 chips re-places in both: proprietary also loads a replica on
# dispatch
OPTION_CELLS = (("flux", "dynamic"), ("flux", "proprietary"))


@pytest.mark.parametrize("cell", OPTION_CELLS, ids="-".join)
@pytest.mark.parametrize("option", sorted(SIM_OPTIONS))
def test_sim_option_bit_equal(option, cell):
    pipeline, workload = cell
    kw = dict(SIM_OPTIONS[option], num_chips=32)
    ref = jrun_sim(pipeline, JTrident, workload, DURATION[pipeline], sim_cfg=JSimConfig(**kw))
    port = trun_sim(pipeline, TTrident, workload, DURATION[pipeline],
                    sim_cfg=TSimConfig(**kw), hw=REF_HW)
    assert_same(ref, port)


@pytest.mark.parametrize("cell", OPTION_CELLS, ids="-".join)
@pytest.mark.parametrize("ablation", ABLATIONS)
def test_trident_ablation_bit_equal(ablation, cell):
    pipeline, workload = cell
    kw = {ablation: False}
    ref = jrun_sim(pipeline, JTrident, workload, DURATION[pipeline],
                   sim_cfg=JSimConfig(num_chips=32), **kw)
    port = trun_sim(pipeline, TTrident, workload, DURATION[pipeline],
                    sim_cfg=TSimConfig(num_chips=32), hw=REF_HW, **kw)
    assert_same(ref, port)


def _trajectories(pipeline, workload, duration, scheduler, chips, jax_side):
    """Each request's (arrival, deadline, stage finishes) in trace order,
    from a Simulator built the way ``run_sim`` builds it."""
    jcls, tcls = _classes(scheduler)
    if jax_side:
        prof = jprof.Profiler(JC.get(pipeline), force_k_min=getattr(jcls, "FORCE_KMIN", None))
        trace = jwl.make_trace(pipeline, workload, duration, prof)
        cfg = JSimConfig(num_chips=chips)
        JSimulator(pipeline, jcls(prof, cfg, trace), trace, cfg).run()
    else:
        prof = tprof.Profiler(TC.get(pipeline), hw=REF_HW,
                              force_k_min=getattr(tcls, "FORCE_KMIN", None))
        trace = twl.make_trace(pipeline, workload, duration, prof)
        cfg = TSimConfig(num_chips=chips)
        TSimulator(pipeline, tcls(prof, cfg, trace), trace, cfg).run()
    return [(r.arrival, r.deadline, sorted(r.stage_done.items())) for r in trace]


@pytest.mark.parametrize("scheduler", ("trident", "B4", "B6"))
def test_request_trajectories_equal_by_position(scheduler):
    args = ("flux", "dynamic", DURATION["flux"], scheduler, 32)
    want = _trajectories(*args, jax_side=True)
    got = _trajectories(*args, jax_side=False)
    assert len(got) == len(want) > 0
    assert got == want


@pytest.mark.parametrize("pipeline", PIPELINES)
def test_profiler_cluster_methods_bit_equal(pipeline):
    """optimal_batch, comm_bytes, transfer_time, stage_load_time and the
    forced k_min, for every class of the pipeline's mixes."""
    classes = sorted({cls for mix in jwl.MIXES[pipeline].values() for cls, _ in mix})
    for force in (None, 1):
        jp = jprof.Profiler(JC.get(pipeline), force_k_min=force)
        tp = tprof.Profiler(TC.get(pipeline), hw=REF_HW, force_k_min=force)
        assert tp.k_min == jp.k_min
        for res, sec in classes:
            jr = JRequest(pipeline, res, float(sec))
            tr = TRequest(pipeline, res, float(sec))
            for s in "EDC":
                for k in (1, 2, 4, 8):
                    assert tp.optimal_batch(tr, s, k * tp.k_min) == \
                        jp.optimal_batch(jr, s, k * jp.k_min)
            for edge in ("ED", "DC"):
                n = jp.comm_bytes(jr, edge)
                assert tp.comm_bytes(tr, edge) == n
                for intra in (True, False):
                    assert tp.transfer_time(n, intra) == jp.transfer_time(n, intra)
        for s in "EDC":
            for via_host in (True, False):
                assert tp.stage_load_time(s, via_host) == jp.stage_load_time(s, via_host)


def _serve(*args, env=None):
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args],
                         capture_output=True, text=True, cwd=str(ROOT), timeout=300,
                         env=env or dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_serve_cli_prints_one_summary_per_scheduler():
    text = _serve("--duration", "30", "--chips", "16", "--baselines", "B1,B6")
    lines = [ln for ln in text.splitlines() if not ln.startswith("  ")]
    assert [ln.split()[0] for ln in lines] == ["trident", "B1", "B6"]
    assert all(" flux " in ln and " dynamic " in ln and "SLO=" in ln for ln in lines)
    assert "placement switches" in text


def test_serve_pipeline_prints_the_placement_timeline(capsys):
    from repro_torch.launch import serve_pipeline
    serve_pipeline.main(["--pipeline", "cogvideox", "--duration", "60", "--baselines", "B6"])
    text = capsys.readouterr().out
    assert text.splitlines()[0].startswith("trident    cogvideox")
    assert "placement timeline:" in text and "t=    0.0s" in text
    assert text.splitlines()[-1].startswith("B6         cogvideox")


def test_two_hash_seeds_give_the_same_bytes(tmp_path):
    """str-set iteration follows PYTHONHASHSEED; nothing the cluster path
    prints or writes may."""
    outs = []
    for seed in ("0", "12345"):
        path = tmp_path / f"out{seed}.jsonl"
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), PYTHONHASHSEED=seed)
        text = _serve("--workload", "heavy", "--duration", "300", "--chips", "32",
                      "--baselines", "B2,B5,B6", "--json", str(path), env=env)
        # the solver's wall-clock ms is the one number allowed to move
        outs.append((re.sub(r"solver [0-9.]+ ms", "", text), path.read_bytes()))
    assert outs[0] == outs[1]
    assert len(outs[0][1].splitlines()) == 4


def test_core_is_clean_under_the_determinism_lint(monkeypatch):
    monkeypatch.chdir(ROOT)
    core = "src/repro_torch/core"
    result = lint_paths([core], strict_prefixes=(core,))
    assert result.errors == []
    assert result.files >= 13
    assert [(f.path, f.line, f.rule) for f in result.findings] == []
    assert result.suppressed > 0   # the reasons came with the code they annotate


# -- H100_SXM held to the card -------------------------------------------------

# The chip run that fitted H100_SXM's knobs (``chip_smoke.py`` phases 5 and
# 5b, one chip, after an untimed run at each shape; stage ms)
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
READINGS = [
    # (pipeline, resolution, seconds, stage, ms)
    ("sd3", 512, 0.0, "D", 283.08), ("sd3", 512, 0.0, "C", 2.53),
    ("sd3", 1024, 0.0, "D", 429.65), ("sd3", 1024, 0.0, "C", 6.65),
    ("sd3", 1536, 0.0, "D", 1238.04), ("sd3", 1536, 0.0, "C", 14.67),
    ("flux", 512, 0.0, "D", 139.03), ("flux", 512, 0.0, "C", 1.9),
    ("flux", 1024, 0.0, "D", 509.93), ("flux", 1024, 0.0, "C", 6.92),
    ("cogvideox", 480, 2.0, "D", 696.81), ("cogvideox", 480, 2.0, "C", 17.53),
    ("hunyuanvideo", 540, 1.0, "D", 967.84), ("hunyuanvideo", 540, 1.0, "C", 10.98),
]


def _readings():
    return [{"pipeline": p, "resolution": r, "seconds": s, "stage": st, "ms": ms}
            for p, r, s, st, ms in READINGS]


def test_h100_knobs_are_the_fit_of_the_card_readings():
    hw = tprof.H100_SXM
    fitted = calibrate.fit(_readings(), hw)
    assert (fitted.mfu, fitted.seq_mfu_knee, fitted.mfu_conv) == \
        (hw.mfu, hw.seq_mfu_knee, hw.mfu_conv)


def test_fitted_diffuse_readings_within_the_band():
    rows = calibrate.table(tprof.H100_SXM, [r for r in _readings() if r["stage"] == "D"])
    fitted = [r for r in rows if r["fitted"]]
    assert len(fitted) == len(calibrate.FIT_DIFFUSE) == 6
    assert calibrate.outside_band(tprof.H100_SXM, _readings()) == []
    for r in fitted:
        assert 0.7 <= r["measured_over_predicted"] <= 1.3, r
    # the band is no formality: the knobs before the fit miss it
    old = dataclasses.replace(tprof.H100_SXM, mfu=0.5, seq_mfu_knee=384, mfu_conv=0.12)
    assert calibrate.outside_band(old, _readings())


@pytest.mark.parametrize("pipeline", PIPELINES)
def test_every_pipeline_fits_one_h100_unit(pipeline):
    prof = tprof.Profiler(TC.get(pipeline))
    assert prof.k_min == 1
    hw = prof.hw
    assert prof.unit_param_bytes("EDC") + hw.mem_reserve <= hw.hbm_bytes
