"""``tools/idle_by_span.py``'s attribution on synthetic device events and
spans: idle gaps go to the innermost span open at their middle, busy time
to the stage span whose device interval holds it, and the totals are the
harness's."""
from types import SimpleNamespace

import pytest

from tools import idle_by_span as ibs

MS = 1_000_000


def _span(sid, name, parent, hs, he, ds=None, de=None, **attrs):
    return SimpleNamespace(id=sid, name=name, parent=parent, host_start_ns=hs, host_end_ns=he,
                           device_start_ns=ds, device_end_ns=de, attrs=attrs)


def _call():
    """One serve call from 10 to 90 ms: plan, a dispatch round, one launch
    with its three stages (the DiT in two steps) and the sync."""
    return [
        _span(0, "serve", None, 10 * MS, 90 * MS, requests=1, seed=5, anchor_err_ns=4_000),
        _span(1, "plan", 0, 10 * MS, 14 * MS, units=1),
        _span(2, "dispatch", 0, 14 * MS, 15 * MS, pending=1, decisions=1, corequests=0),
        _span(3, "launch", 0, 15 * MS, 89 * MS, rids=[7], batch=1, resolution=512, seconds=0.0,
              steps=2),
        _span(4, "encode", 3, 16 * MS, 30 * MS, 16 * MS, 31 * MS),
        _span(5, "diffuse", 3, 30 * MS, 60 * MS, 31 * MS, 70 * MS),
        _span(6, "step", 5, 30 * MS, 45 * MS, 31 * MS, 50 * MS, step=0, t=999),
        _span(7, "step", 5, 45 * MS, 60 * MS, 50 * MS, 70 * MS, step=1, t=0),
        _span(8, "decode", 3, 60 * MS, 62 * MS, 70 * MS, 80 * MS),
        _span(9, "sync", 3, 62 * MS, 80 * MS),
    ]


def test_idle_goes_to_the_innermost_span_and_busy_to_the_stage():
    ops = [
        (17 * MS, 29 * MS),                   # encode's work, a gap at 29-33 in the encode span
        (33 * MS, 40 * MS), (41 * MS, 52 * MS),   # steps; 40-41 idle inside step 0
        (52 * MS, 65 * MS), (64 * MS, 69 * MS),   # overlapping operations count once
        (71 * MS, 79 * MS),                   # decode; 69-71 idle during the sync
        (95 * MS, 120 * MS),                  # after the call, clipped at the window's end
    ]
    out = ibs.attribute(ops, _call(), 0, 100 * MS)
    idle = {k: round(v * 1e3, 6) for k, v in out["idle_by_span"].items()}
    # 0-17: midpoint 8.5 ms, before the call; 29-33: midpoint 31, in step 0;
    # 40-41 in step 0; 69-71 at 70 in sync; 79-95 at 87 in the launch
    assert idle == {ibs.NO_SPAN: 17.0, "step": 5.0, "sync": 2.0, "launch": 16.0}
    busy = {k: round(v * 1e3, 6) for k, v in out["busy_by_stage"].items()}
    # device intervals: encode 16-31, diffuse 31-70, decode 70-80
    assert busy == {"encode": 12.0, "diffuse": 35.0, "decode": 8.0, ibs.NO_STAGE: 5.0}
    assert out["busy_s"] == pytest.approx(0.060)
    assert out["idle_s"] + out["busy_s"] == pytest.approx(out["window_s"])
    assert sum(out["busy_by_stage"].values()) == pytest.approx(out["busy_s"])


def test_the_totals_are_the_harness_reducers(monkeypatch):
    """The same events through the harness's ``summarize``: the same busy
    and idle seconds."""
    torch = pytest.importorskip("torch")
    monkeypatch.syspath_prepend(str(ibs.ROOT))
    from servebench import trace as tracing

    class Ev:
        def __init__(self, s, e):
            self.s, self.e = s, e

        def name(self):
            return "k"

        def start_ns(self):
            return self.s

        def end_ns(self):
            return self.e

        def device_type(self):
            return torch.autograd.DeviceType.CUDA

        def is_user_annotation(self):
            return False

    ops = [(5 * MS, 9 * MS), (8 * MS, 20 * MS), (20 * MS + 40_000, 30 * MS), (70 * MS, 130 * MS)]
    want = tracing.summarize([Ev(s, e) for s, e in ops], 2 * MS, 100 * MS, [(3 * MS, 95 * MS)])
    got = ibs.attribute(ops, [], 2 * MS, 100 * MS)
    assert got["busy_s"] == pytest.approx(want["busy_s"], abs=1e-12)
    assert got["idle_s"] == pytest.approx(want["window_s"] - want["busy_s"], abs=1e-12)
    assert got["idle_by_span"] == {ibs.NO_SPAN: pytest.approx(got["idle_s"])}


def test_a_window_with_no_device_work_is_all_idle():
    out = ibs.attribute([], _call(), 0, 100 * MS)      # the middle, 50 ms, is in step 1
    assert out["busy_s"] == 0 and out["idle_by_span"] == {"step": pytest.approx(0.1)}


def test_counts_read_every_attribute():
    spans = _call() + [_span(10, "serve", None, 95 * MS, 99 * MS, requests=0, seed=6,
                             anchor_err_ns=9_000)]
    c = ibs.counts(spans)
    assert c["serve_calls"] == 2 and c["requests"] == 1 and c["anchor_err_us_max"] == 9.0
    assert c["plans"] == 1 and c["plan_units"] == [1]
    assert (c["dispatch_rounds"], c["pending_mean"], c["decisions"], c["corequests"]) == \
        (1, 1.0, 1, 0)
    assert c["launches"] == 1 and c["batch_mean"] == 1.0
    assert c["classes"] == [((512, 0.0, 2), 1)] and c["each_request_once"]
    assert c["lead_ms_by_step"] == [[0, 999, 5.0], [1, 0, 10.0]]
    dup = spans + [_span(11, "launch", 0, 88 * MS, 89 * MS, rids=[7], batch=1, resolution=512,
                         seconds=0.0, steps=2)]
    assert not ibs.counts(dup)["each_request_once"]


def test_the_module_imports_neither_cuda_nor_the_benchmark():
    import ast
    tree = ast.parse((ibs.ROOT / "tools" / "idle_by_span.py").read_text())
    top = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            top |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            top.add((node.module or "").split(".")[0])
    assert not top & {"torch", "servebench", "repro_torch", "repro", "jax"}
