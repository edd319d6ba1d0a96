"""The paper's benchmark scripts on the ported core against the JAX
package's ``benchmarks/``, on the CPU.

Under the reference's constants (``REFERENCE_HW``) every ported script's
quick rows equal the reference script's in every field no wall clock moves
(Table 4's ms values and the wall seconds are left out); requests are
compared by position. The event-vs-tick smoke set reproduces the committed
``BENCH_event_sim.json`` and ``BENCH_unified_clock.json`` in their
deterministic fields. The slow test runs the whole ``run --smoke`` pass of
both against each other.
"""
import importlib
import json
import os

import pytest

from repro.core import profiler as jprof
from repro_torch.benchmarks import common, e2e
from repro_torch.benchmarks import run as bench
from repro_torch.core import profiler as tprof

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = tprof.REFERENCE_HW
# the fields whose values are host seconds or host milliseconds
WALL = {"wall_s"}


def _strip(rows, name):
    """Rows without their wall-clock fields: Table 4's values are the host's
    solve times."""
    out = []
    for n, v, d in rows:
        if name == "dispatcher_scalability":
            v = None
        out.append((n, v, {k: x for k, x in d.items() if k not in WALL}))
    return out


def test_reference_constants_are_the_jax_packages():
    assert (REF.peak_flops, REF.hbm_bw, REF.mfu, REF.seq_mfu_knee) == \
           (jprof.PEAK_FLOPS, jprof.HBM_BW, jprof.MFU, jprof.SEQ_MFU_KNEE)


@pytest.mark.parametrize("name", bench.MODULES)
def test_quick_rows_equal_the_reference_scripts(name):
    want = importlib.import_module(f"benchmarks.{name}").run(quick=True)
    got = bench.run_module(name, quick=True, hw=REF)
    assert [r[0] for r in got] == [r[0] for r in want]
    assert _strip(got, name) == _strip(want, name)


def test_mixed_deployment_rows_equal_the_references():
    from benchmarks import e2e as ref_e2e
    assert _strip(e2e.run_mixed(quick=True, hw=REF), "e2e") == \
           _strip(ref_e2e.run_mixed(quick=True), "e2e")


def test_the_harness_runs_every_module_of_the_reference_but_the_roofline_pair():
    from benchmarks import run as ref_run
    assert bench.MODULES == [m for m in ref_run.MODULES if m not in ("kernels_bench", "roofline")]


def test_event_smoke_reproduces_the_committed_bench_files(tmp_path):
    paths = {"BENCH_event_sim.json": tmp_path / "event.json",
             "BENCH_unified_clock.json": tmp_path / "unified.json"}
    rows = e2e.run_smoke(bench_path=str(paths["BENCH_event_sim.json"]),
                         unified_bench_path=str(paths["BENCH_unified_clock.json"]),
                         hw=REF, repeats=1)
    for base, path in paths.items():
        got = json.loads(path.read_text())
        want = json.loads((open(os.path.join(ROOT, base)).read()))
        assert got["bench"] == want["bench"]
        for key in ("scenarios", "sched_wakeups_event", "sched_wakeups_tick", "metrics_match"):
            assert got[key] == want[key], key
    assert (got["sched_wakeups_event"], got["sched_wakeups_tick"]) == (13947, 91647)
    assert [v for n, v, _ in rows if n.endswith("metrics_match_event_vs_tick")] == [1.0]


def test_smoke_rows_of_one_mode_equal_the_references():
    from benchmarks import e2e as ref_e2e
    got, _, wk = e2e.run_smoke_mode("event", hw=REF)
    want, _, ref_wk = ref_e2e.run_smoke_mode("event")
    assert got == want and wk == ref_wk


def test_profile_buckets_name_the_ports_entry_points_and_add_up(monkeypatch):
    """Every ported subsystem entry point the profile wraps exists (the
    reference's list names two that do not, so its batching and lending
    buckets stay empty), and the shares add up to the run."""
    for _, mod, cls, methods in e2e._PROFILE_TARGETS:
        klass = getattr(importlib.import_module(mod), cls)
        assert all(m in klass.__dict__ for m in methods), (cls, methods)
    from repro_torch.launch import scale
    monkeypatch.setattr(scale, "SMOKE_CHIPS", 128)
    monkeypatch.setattr(scale, "SMOKE_REQUESTS", 4000)
    rows = e2e.run_profile(hw=REF)
    buckets = {n.split("/")[2]: d for n, _, d in rows}
    assert {"dispatch_ilp", "monitor", "engine_execute", "total"} <= set(buckets)
    shares = sum(d["share_pct"] for b, d in buckets.items() if b != "total")
    assert 99.0 <= shares <= 101.0 and buckets["total"]["requests"] > 300


def test_emit_writes_the_references_csv_layout(capsys, tmp_path):
    rows = [("a/b", 1.5, {"x": 1, "y": "z"}), ("c", 2, {})]
    common.emit(rows)
    path = tmp_path / "rows.csv"
    with open(path, "w") as f:
        common.emit(rows, file=f)
    assert capsys.readouterr().out == path.read_text() == "a/b,1.5,x=1;y=z\nc,2,\n"


def test_harness_runs_one_module_under_each_constant_set(capsys):
    assert bench.main(["--only", "batch_effects", "--hw", "reference"]) == 0
    ref_rows = capsys.readouterr().out
    assert bench.main(["--only", "batch_effects"]) == 0
    h100_rows = capsys.readouterr().out
    assert ref_rows.count("batch_effects/sd3/") == h100_rows.count("batch_effects/sd3/") == 4
    assert ref_rows != h100_rows


@pytest.mark.slow
def test_smoke_pass_equals_the_references_and_passes_the_gate(tmp_path):
    """``run --smoke --hw reference`` (the port, into tmp_path) against the
    reference's own smoke functions (into tmp_path): every JSON equal in the
    fields no wall clock moves, and the port's regression gate passes
    against the committed baselines."""
    from benchmarks import e2e as ref_e2e
    out = tmp_path / "port"
    assert bench.main(["--smoke", "--hw", "reference", "--out", str(out)]) == 0
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    ref_e2e.run_smoke(bench_path=str(ref_dir / "BENCH_event_sim.json"),
                      unified_bench_path=str(ref_dir / "BENCH_unified_clock.json"))
    ref_e2e.run_shared_smoke(bench_path=str(ref_dir / "BENCH_shared.json"))
    ref_e2e.run_predictive_smoke(bench_path=str(ref_dir / "BENCH_predictive.json"))
    ref_e2e.run_cross_batch_smoke(bench_path=str(ref_dir / "BENCH_cross_batch.json"))
    ref_e2e.run_scale(full=False, bench_path=str(ref_dir / "BENCH_scale.json"))
    ref_e2e.run_elastic_smoke(bench_path=str(ref_dir / "BENCH_elastic.json"))
    wall = {"wall_event_s", "wall_tick_s", "speedup_event_vs_tick", "wall_s", "throughput_rps"}
    for _, stem, _ in bench.SMOKES:
        got = json.loads((out / f"{stem}.torch_reference_smoke.json").read_text())
        want = json.loads((ref_dir / f"{stem}.json").read_text())
        assert set(got) == set(want), stem
        assert {k: v for k, v in got.items() if k not in wall} == \
               {k: v for k, v in want.items() if k not in wall}, stem
