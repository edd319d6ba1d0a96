"""``encode_graph_share``, the share of the window's launches whose Encode
replayed a CUDA graph, on the synthetic spans of ``test_servebench_spans``
with an ``encoder`` span inside each ``encode``: its value, and its silence
where the spans do not pair with the run or carry no ``graphed``
attribute."""
import time

import pytest
from torch.profiler import ProfilerActivity, profile

import test_servebench_spans as synthetic
from servebench import harness, spans

NAMES = ("encode_graph_share.paced", "encode_graph_share.tput", "encode_graph_share.video")
CELLS = {"encode_graph_share.paced": ("sd3.saturated", "throughput_mpx_s.paced"),
         "encode_graph_share.tput": ("flux.hires", "throughput_mpx_s"),
         "encode_graph_share.video": ("hunyuanvideo-t2v.video", "throughput_mpx_s")}


def _with_encoders(found):
    """Each ``encode`` span given an ``encoder`` child over its host interval."""
    out = list(found)
    for s in found:
        if s.name == "encode":
            out.append(synthetic._sp(s.id + 50, "encoder", s.id, s.host_start_ns + 1,
                                     s.host_end_ns - 1, graphed=1))
    return out


@pytest.fixture
def recorded(monkeypatch):
    box = {"spans": _with_encoders(synthetic._spans())}
    monkeypatch.setattr(spans, "recorded", lambda: box["spans"])
    return box


def _encoders(box):
    return [s for s in box["spans"] if s.name == "encoder"]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("flags,share", [((1, 1), 1.0), ((1, 0), 0.5), ((0, 0), 0.0)])
def test_the_share_of_graphed_encodes(recorded, name, flags, share):
    for s, f in zip(_encoders(recorded), flags):
        s.attrs["graphed"] = f
    assert harness.reader(name)(synthetic._run()) == pytest.approx(share)


@pytest.mark.parametrize("case", ["no encoder spans", "no attribute", "one without it",
                                  "two in one encode", "another value", "a step fewer",
                                  "another seed", "no spans"])
def test_nothing_where_the_spans_do_not_pair_or_say_nothing(recorded, case):
    if case == "no encoder spans":                 # the parent's port: Encode opens no span
        recorded["spans"] = synthetic._spans()
    elif case == "no attribute":
        for s in _encoders(recorded):
            del s.attrs["graphed"]
    elif case == "one without it":
        del _encoders(recorded)[1].attrs["graphed"]
    elif case == "two in one encode":
        e = _encoders(recorded)[0]
        recorded["spans"].append(synthetic._sp(e.id + 1, "encoder", e.parent, e.host_start_ns,
                                               e.host_end_ns, graphed=1))
    elif case == "another value":
        _encoders(recorded)[0].attrs["graphed"] = 2
    elif case == "a step fewer":
        recorded["spans"] = [s for s in recorded["spans"] if s.id != 7]
    elif case == "another seed":
        recorded["spans"][0].attrs["seed"] = 7
    else:
        recorded["spans"] = []
    for name in NAMES:
        assert harness.reader(name)(synthetic._run()) is None, name


def test_the_entries_in_benchmark_json():
    bench = harness.load_benchmark()
    got = {m["name"]: m for m in bench["per_layer"] if m["name"] in NAMES}
    assert set(got) == set(NAMES)
    for name, m in got.items():
        cell, moves = CELLS[name]
        assert m == {"name": name, "unit": "share", "better": "higher",
                     "source": "program_span", "layer": "Encode", "moves": moves,
                     "workloads": [cell]}


def test_a_traced_window_on_the_cpu_reads_every_encode_eager(smoke_cell, cpu, monkeypatch):
    """The port's own ``encoder`` spans of a SMOKE window: on the CPU every
    Encode runs eagerly, so the share reads 0; an untraced run reads none."""
    from repro_torch import trace
    from servebench import trace as tracing
    monkeypatch.setattr(tracing, "Tracer", synthetic.CpuTracer)
    cell = smoke_cell("sd3", "sd3_saturated")
    cell["per_layer"] = [m for m in harness.load_benchmark()["per_layer"]
                         if m["name"] == "encode_graph_share.paced"]
    with profile(activities=[ProfilerActivity.CPU]):    # the first session starts slowly
        pass
    trace.clear()
    out, run = harness.run(cell, 2 ** 31 + 11, 2.0, True, cpu, time.perf_counter())
    trace.clear()
    assert out["correct"] and run.launches, out["compared"]
    assert out["metrics"] == {"encode_graph_share.paced": {"value": 0.0, "unit": "share"}}
    out, _ = harness.run(cell, 2 ** 31 + 11, 0.5, False, cpu, time.perf_counter())
    assert "encode_graph_share.paced" not in out["metrics"]
    assert trace.spans() == []
