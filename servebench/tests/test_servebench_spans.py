"""The readers of the port's spans (``servebench/spans.py`` and the six
metrics that use it) on synthetic spans, their silence where the spans do
not match the run, and one traced window at the SMOKE sizes on the CPU."""
import json
import time
from types import SimpleNamespace

import pytest
from torch.profiler import ProfilerActivity, profile

from conftest import ROOT
from servebench import harness, program, spans, window

MS = 1_000_000
RECORDED = spans.recorded
NEW = {"serve_self_ms.paced": 16.0, "encode_host_lead_ms.paced": 1.0,
       "dit_host_lead_ms.paced": 7.5, "dit_host_lead_ms.tput": 7.5,
       "decode_ms.paced": 10.0, "decode_ms.tput": 10.0}


def _sp(sid, name, parent, hs, he, ds=None, de=None, **attrs):
    return SimpleNamespace(id=sid, name=name, parent=parent, host_start_ns=hs, host_end_ns=he,
                           device_start_ns=ds, device_end_ns=de, attrs=attrs)


def _call(k, seed, base):
    """Call k's spans from base + 10 ms to base + 90 ms: one launch, its
    stages, two DDIM steps, the sync (ids from k * 100)."""
    i, t = k * 100, lambda ms: base + ms * MS
    return [
        _sp(i, "serve", None, t(10), t(90), requests=1, seed=seed, anchor_err_ns=3_000),
        _sp(i + 1, "plan", i, t(10), t(14), units=1),
        _sp(i + 2, "dispatch", i, t(14), t(15), pending=1, decisions=1, corequests=0),
        _sp(i + 3, "launch", i, t(15), t(89), rids=[k], batch=1, resolution=512, seconds=0.0,
            steps=2),
        _sp(i + 4, "encode", i + 3, t(16), t(30), t(16), t(31)),
        _sp(i + 5, "diffuse", i + 3, t(30), t(60), t(31), t(70)),
        _sp(i + 6, "step", i + 5, t(30), t(45), t(31), t(50), step=0, t=999),
        _sp(i + 7, "step", i + 5, t(45), t(60), t(50), t(70), step=1, t=0),
        _sp(i + 8, "decode", i + 3, t(60), t(62), t(70), t(80)),
        _sp(i + 9, "sync", i + 3, t(62), t(80)),
    ]


def _run():
    run = window.Run(cfg={}, mix={}, seconds=1.0)
    run.t0_ns = 5 * MS
    for k, seed in enumerate((41, 42)):
        run.requests.append(window.Served(k, 0.0, 512, 0.0, 1.0, call=k, pos=0, launch=k,
                                          completion=0.1))
        run.launches.append(window.Launch([k], 512, 0.0, 2, {"E": 15.0, "D": 39.0, "C": 10.0},
                                          1024, 77))
        run.calls.append(window.Call(seed, 0.0, 0.1, [k]))
    return run


def _spans():
    return _call(0, 41, 0) + _call(1, 42, 100 * MS)


@pytest.fixture
def recorded(monkeypatch):
    """Patch what the port recorded; the fixture's value sets it."""
    box = {"spans": _spans()}
    monkeypatch.setattr(spans, "recorded", lambda: box["spans"])
    return box


@pytest.mark.parametrize("name", sorted(NEW))
def test_each_reader_on_synthetic_spans(recorded, name):
    assert harness.reader(name)(_run()) == pytest.approx(NEW[name])


def test_the_readers_in_benchmark_json():
    bench = harness.load_benchmark()
    got = {m["name"]: m for m in bench["per_layer"] if m["name"] in NEW}
    assert set(got) == set(NEW)
    for name, m in got.items():
        assert m["source"] == "program_span" and m["unit"] == "ms"
        cell = "flux.hires" if name.endswith(".tput") else "sd3.saturated"
        assert m["workloads"] == [cell]
        moves = [e["name"] for e in bench["end_to_end"] if cell in e.get("workloads", ())]
        assert m["moves"] in moves
    assert [m["name"] for m in bench["per_layer"][-len(NEW):]] == list(got)


def _drop(pred):
    return [s for s in _spans() if not pred(s)]


@pytest.mark.parametrize("case", [
    "a launch span fewer", "another batch", "no sync", "a step fewer", "another seed",
    "no spans", "no port spans"])
def test_nothing_where_the_spans_do_not_match(recorded, monkeypatch, case):
    if case == "a launch span fewer":
        recorded["spans"] = _drop(lambda s: s.id == 103)
    elif case == "another batch":
        recorded["spans"][3].attrs["batch"] = 2
    elif case == "no sync":
        recorded["spans"] = _drop(lambda s: s.name == "sync" and s.id > 100)
    elif case == "a step fewer":
        recorded["spans"] = _drop(lambda s: s.id == 7)
    elif case == "another seed":
        recorded["spans"][0].attrs["seed"] = 7
    elif case == "no spans":
        recorded["spans"] = []
    else:     # a port without repro_torch.trace, as before the port recorded spans
        monkeypatch.setattr(spans, "recorded", RECORDED)
        monkeypatch.setattr(program, "quickstart", SimpleNamespace(serve=None))
    for name in NEW:
        assert harness.reader(name)(_run()) is None, name


def test_spans_before_the_window_are_left_out(recorded):
    early = _call(5, 99, -200 * MS)             # a serve call before the window opened
    recorded["spans"] = early + _spans()
    assert harness.reader("serve_self_ms.paced")(_run()) == pytest.approx(16.0)


def test_without_device_times_only_the_host_metric_reads(recorded):
    for s in recorded["spans"]:
        s.device_start_ns = s.device_end_ns = None
    run = _run()
    got = {n: harness.reader(n)(run) for n in NEW}
    assert got.pop("serve_self_ms.paced") == pytest.approx(16.0)
    assert set(got.values()) == {None}


class CpuTracer:
    """The harness's tracer on the CPU: a CPU profiler session, and a
    summary with no device work."""

    def __init__(self):
        self.prof = profile(activities=[ProfilerActivity.CPU])

    def __enter__(self):
        self.prof.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.time_ns()
        self.prof.__exit__(*exc)
        return False

    def summary(self, calls_ns):
        return {"window_s": (self.t1 - self.t0) / 1e9, "busy_s": 0.0, "k1_s": 0.0,
                "k1_calls": 0, "device_ops": [], "idle_gaps": []}


def test_a_traced_window_on_the_cpu(smoke_cell, cpu, monkeypatch):
    """The port's own spans of a SMOKE window: ``serve_self_ms`` reads and
    agrees with ``host_gap_ms`` (within 25% or 0.5 ms), the device metrics
    stay silent on the CPU, and an untraced run reads none of them."""
    from repro_torch import trace
    from servebench import trace as tracing
    monkeypatch.setattr(tracing, "Tracer", CpuTracer)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = smoke_cell("sd3", "sd3_saturated")
    cell["per_layer"] = [m for m in bench["per_layer"]
                         if m["name"] in NEW or m["name"] == "host_gap_ms.paced"]
    with profile(activities=[ProfilerActivity.CPU]):    # the first session starts slowly
        pass
    trace.clear()
    out, run = harness.run(cell, 2 ** 31 + 7, 2.0, True, cpu, time.perf_counter())
    trace.clear()
    got = out["metrics"]
    assert out["correct"] and run.launches, (out["compared"], [(round(c.start, 2), round(c.end, 2), len(c.launches)) for c in run.calls])
    assert set(got) == {"serve_self_ms.paced", "host_gap_ms.paced"}
    s, h = got["serve_self_ms.paced"]["value"], got["host_gap_ms.paced"]["value"]
    assert 0 < s and abs(s - h) <= max(0.25 * h, 0.5), (s, h)
    out, _ = harness.run(cell, 2 ** 31 + 7, 0.5, False, cpu, time.perf_counter())
    assert not set(out["metrics"]) & set(NEW)
    assert trace.spans() == []
