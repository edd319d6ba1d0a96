"""``dit_graph_share``, the share of the window's DDIM ``step`` spans that
replayed a CUDA graph, on the synthetic spans of ``test_servebench_spans``:
its value, and its silence where the spans do not pair with the run or
carry no ``graphed`` attribute."""
import pytest

import test_servebench_spans as synthetic
from servebench import harness, spans

NAMES = ("dit_graph_share.paced", "dit_graph_share.tput")


@pytest.fixture
def recorded(monkeypatch):
    """The synthetic spans (two calls of one launch, two steps each), each
    step's ``graphed`` set from the fixture's value."""
    box = {"spans": synthetic._spans()}
    monkeypatch.setattr(spans, "recorded", lambda: box["spans"])
    return box


def _steps(box):
    return [s for s in box["spans"] if s.name == "step"]


def _mark(box, flags):
    for s, f in zip(_steps(box), flags):
        s.attrs["graphed"] = f


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("flags,share", [((1, 1, 1, 1), 1.0), ((1, 0, 1, 0), 0.5),
                                         ((0, 0, 0, 0), 0.0), ((1, 1, 1, 0), 0.75)])
def test_the_share_of_graphed_steps(recorded, name, flags, share):
    _mark(recorded, flags)
    assert harness.reader(name)(synthetic._run()) == pytest.approx(share)


@pytest.mark.parametrize("case", ["no attribute", "one step without it", "a step fewer",
                                  "another seed", "no spans"])
def test_nothing_where_the_spans_do_not_pair_or_say_nothing(recorded, case):
    _mark(recorded, (1, 1, 1, 1))
    if case == "no attribute":
        for s in _steps(recorded):
            del s.attrs["graphed"]
    elif case == "one step without it":
        del _steps(recorded)[2].attrs["graphed"]
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
    assert [m["name"] for m in bench["per_layer"][-len(NAMES):]] == list(NAMES)
    for name, m in got.items():
        cell = "flux.hires" if name.endswith(".tput") else "sd3.saturated"
        assert m == {"name": name, "unit": "share", "better": "higher",
                     "source": "program_span", "layer": "Diffuse",
                     "moves": "throughput_mpx_s" if cell == "flux.hires"
                     else "throughput_mpx_s.paced", "workloads": [cell]}
