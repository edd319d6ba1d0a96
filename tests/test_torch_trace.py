"""The port's span recorder (``repro_torch.trace``) and the spans of
``quickstart.serve`` at the SMOKE sizes on the CPU: nothing recorded and
nothing created with the profiler off, the same outputs with it on, one
span tree a call that matches the records, the device clock's anchor on a
fake event, the buffer's bound. The ``gpu`` test proves on the card that a
device span and the profiler's event of the same kernel share one clock:

  PYTHONPATH=src python -m pytest -m gpu -s tests/test_torch_trace.py
"""
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.configs as TC
from repro_torch import trace
from repro_torch.core.request import Request
from repro_torch.launch import quickstart
from repro_torch.models import diffusion
from repro_torch.models import pipeline as tpl

PIPELINES = ("sd3", "flux")
LATENCY_NS = 10_000


@pytest.fixture(scope="module")
def pipes():
    out = {}
    for name in PIPELINES:
        cfg = TC.get_smoke(name)
        pipe = tpl.build(cfg, "cpu", seed=0)
        out[name] = (name, cfg, pipe)
        quickstart.warm(pipe, _requests(out[name]))
    return out


def _requests(p):
    name, cfg, _ = p
    return [Request(cfg.name, res, sec) for res, sec in quickstart.smoke_requests(name)]


def _serve(p, seed):
    return quickstart.serve(p[1], _requests(p), device="cpu", seed=seed, pipe=p[2])


@pytest.mark.parametrize("pipeline", PIPELINES)
def test_off_records_nothing_and_on_serves_the_same(pipes, pipeline):
    p = pipes[pipeline]
    trace.clear()
    off = _serve(p, 7)
    assert trace.spans() == [] and trace.dropped() == 0
    with profile(activities=[ProfilerActivity.CPU]):
        on = _serve(p, 7)
    assert trace.spans()
    trace.clear()
    assert len(on) == len(off)
    for a, b in zip(off, on):
        assert torch.equal(a["output"], b["output"])
        assert set(a["stage_ms"]) == set(b["stage_ms"]) == {"E", "D", "C"}
        assert {k: v for k, v in a.items() if k not in ("output", "stage_ms", "rid")} == \
            {k: v for k, v in b.items() if k not in ("output", "stage_ms", "rid")}


def test_off_creates_no_span_and_no_event(pipes, monkeypatch):
    p = pipes["sd3"]
    made = []

    def refuse(*a, **k):
        made.append(a)
        raise AssertionError("a span or event was made with the profiler off")

    monkeypatch.setattr(trace.Recorder, "open", refuse)
    monkeypatch.setattr(trace.Span, "__init__", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert trace.span("x", device=torch.device("cuda"), step=1) is trace.OFF
    recs = _serve(p, 3)
    assert len(recs) == len(_requests(p)) and made == []


@pytest.mark.parametrize("pipeline", PIPELINES)
def test_on_records_one_tree_a_call(pipes, pipeline):
    p = pipes[pipeline]
    cfg = p[1]
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        calls = [_serve(p, seed) for seed in (11, 12)]
    spans = trace.spans()
    trace.clear()
    by_id = {s.id: s for s in spans}
    kids = {s.id: [c for c in spans if c.parent == s.id] for s in spans}
    for s in spans:                         # every child inside its parent's host interval
        assert s.host_start_ns <= s.host_end_ns
        assert s.device_start_ns is None and s.device_end_ns is None
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.host_start_ns <= s.host_start_ns and s.host_end_ns <= p.host_end_ns
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["serve", "serve"]
    assert [s.attrs["seed"] for s in roots] == [11, 12]
    steps = diffusion.ddim_timesteps(cfg.num_steps)
    for root, records in zip(roots, calls):
        assert root.attrs["requests"] == len(records) and "anchor_err_ns" not in root.attrs
        names = [c.name for c in kids[root.id]]
        assert names[0] == "plan" and kids[root.id][0].attrs["units"] == 1
        launches = [c for c in kids[root.id] if c.name == "launch"]
        rounds = [c for c in kids[root.id] if c.name == "dispatch"]
        assert set(names) == {"plan", "dispatch", "launch"}
        assert sum(r.attrs["decisions"] for r in rounds) == len(launches)
        assert all(r.attrs["corequests"] == 0 for r in rounds)
        assert [r.attrs["pending"] for r in rounds] == list(range(len(records), 0, -1))
        # one launch per launch of the records (records of one launch share stage_ms)
        assert len(launches) == len({id(r["stage_ms"]) for r in records})
        rids = [rid for la in launches for rid in la.attrs["rids"]]
        assert sorted(rids) == sorted(r["rid"] for r in records)
        by_rid = {r["rid"]: r for r in records}
        for la in launches:
            rec = by_rid[la.attrs["rids"][0]]
            assert (la.attrs["batch"], la.attrs["resolution"], la.attrs["seconds"],
                    la.attrs["steps"]) == (rec["batch"], rec["resolution"], rec["seconds"],
                                           rec["num_steps"])
            stages = kids[la.id]
            assert [c.name for c in stages] == ["encode", "diffuse", "decode", "sync"]
            diffuse = stages[1]
            assert [(c.name, c.attrs["step"], c.attrs["t"]) for c in kids[diffuse.id]] == \
                [("step", i, t) for i, t in enumerate(steps)]


class FakeDevice:
    """A device clock running OFFSET ns from the host's, a host clock that
    advances STEP ns a reading, and a spin that keeps the device busy for
    SPIN ns."""
    OFFSET, STEP, SPIN = -5_000_000_000, 1_000, 7_500

    def __init__(self):
        self.now, self.busy_until = 10 ** 15, 0

    def clock(self):
        self.now += self.STEP
        return self.now

    def spin(self):
        self.busy_until = max(self.now, self.busy_until) + self.SPIN

    def event(self):
        dev = self

        class Event:
            t = None                                    # on the device's clock

            def record(self):
                # the device reaches it 300 ns from now, or when it is free
                self.t = max(dev.now + 300, dev.busy_until) + dev.OFFSET

            def query(self):
                return dev.now + dev.OFFSET >= self.t

            def synchronize(self):
                pass

            def elapsed_time(self, other):
                return (other.t - self.t) / 1e6

        return Event()


def _host(dev, ev):
    """The true host time at which the device reached ``ev``."""
    return ev.t - dev.OFFSET


def test_anchor_arithmetic_on_a_fake_event():
    dev = FakeDevice()
    rec = trace.Recorder(event=dev.event, clock=dev.clock, spin=dev.spin)
    cuda = torch.device("cuda")
    with rec.open("serve", anchor=cuda, attrs={"seed": 1}) as serve:
        a = rec.anchor
        # polled one reading apart: the last pending and the first done poll
        # bracket the event within two readings
        assert a.err_ns == dev.STEP and abs(a.host_ns - _host(dev, a.event)) <= a.err_ns
        assert serve.attrs["anchor_err_ns"] == a.err_ns
        with rec.open("step", device=cuda) as step:
            dev.now += 2_000_000
        start, end = step.events
        with rec.open("stage", events=(dev.event(), dev.event())) as stage:
            stage.events[0].record()
            dev.now += 7_000
            stage.events[1].record()
    got = rec.resolve()
    assert [s.name for s in got] == ["serve", "step", "stage"]
    assert [s.parent for s in got] == [None, serve.id, serve.id]
    assert serve.device_start_ns is None
    # device time = anchor's host time + the device's elapsed time since the anchor
    assert step.device_start_ns == a.host_ns + (start.t - a.event.t)
    assert step.device_end_ns - step.device_start_ns == end.t - start.t == 2_000_000
    # so its error against the true host time is the anchor's
    assert abs(step.device_start_ns - _host(dev, start)) <= a.err_ns
    assert step.host_start_ns <= _host(dev, start) <= step.host_end_ns
    assert stage.device_end_ns - stage.device_start_ns == 7_000
    assert step.events is None and step.anchor is None


def test_the_anchor_keeps_its_narrowest_reading():
    dev = FakeDevice()
    steps, events = iter([3_000, 1_000, 2_000]), []

    def spin():                                 # each reading polls at its own pace
        dev.STEP = next(steps)
        dev.spin()

    def event():
        events.append(dev.event())
        return events[-1]

    rec = trace.Recorder(event=event, clock=dev.clock, spin=spin)
    a = rec.take_anchor()
    assert len(events) == trace.ANCHOR_TRIES == 3
    assert a.err_ns == 1_000 and a.event is events[1] and rec.anchor is a
    assert abs(a.host_ns - _host(dev, a.event)) <= a.err_ns


def test_a_device_span_without_an_anchor_takes_one():
    dev = FakeDevice()
    rec = trace.Recorder(event=dev.event, clock=dev.clock, spin=dev.spin)
    with rec.open("step", device=torch.device("cuda")) as sp:
        pass
    assert rec.anchor is not None and sp.anchor is rec.anchor
    rec.resolve()
    assert sp.device_start_ns is not None and "anchor_err_ns" not in sp.attrs


def test_the_buffer_is_bounded_and_counts_what_it_drops():
    rec = trace.Recorder(limit=3)
    for i in range(5):
        with rec.open("s", attrs={"i": i}) as sp:
            sp.set(done=True)
    assert [s.attrs for s in rec.resolve()] == [{"i": i, "done": True} for i in range(3)]
    assert rec.dropped == 2
    rec.clear()
    assert rec.resolve() == [] and rec.dropped == 0 and rec.anchor is None


def test_spans_nest_on_their_own_thread():
    rec = trace.Recorder()
    barrier = threading.Barrier(2)

    def work(name):
        with rec.open(name) as outer:
            barrier.wait(timeout=10)
            with rec.open(name + ".inner") as inner:
                barrier.wait(timeout=10)
        assert inner.parent == outer.id and outer.parent is None

    threads = [threading.Thread(target=work, args=(n,)) for n in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    got = {s.name: s for s in rec.resolve()}
    assert got["a.inner"].parent == got["a"].id and got["b.inner"].parent == got["b"].id


def test_span_is_off_outside_a_profiler_session():
    assert not torch.autograd._profiler_enabled()
    assert trace.span("serve", requests=1) is trace.OFF
    with trace.span("serve") as sp:
        sp.set(units=1)
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("serve", requests=1) as sp:
            assert isinstance(sp, trace.Span)
    assert trace.spans()[-1] is sp
    trace.clear()


@pytest.mark.gpu
def test_device_span_shares_the_profilers_clock():
    """Spans around spin kernels in one CUDA-only profiler session of about
    a second, as long as a traced run's. Each round's first span has its
    two events queued right around a kernel (the device kept busy before
    it): its device interval is within 50 us of the kernel's own profiler
    event. Its second synchronizes before it closes: its device interval
    lies inside its host interval, within the anchor's error. (Sessions of
    a few ms put the profiler's kernels 5-150 us off.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    trace.clear()
    rounds = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        with trace.span("outer", anchor=dev) as outer:
            for _ in range(12):
                torch.cuda._sleep(2_000_000)            # busy while the spans open
                with trace.span("kernel", device=dev) as kern_sp:
                    torch.cuda._sleep(1_000_000)
                with trace.span("waited", device=dev) as wait_sp:
                    torch.cuda._sleep(200_000)
                    torch.cuda.synchronize()
                rounds.append((kern_sp, wait_sp))
                time.sleep(0.05)
        torch.cuda.synchronize()
    trace.spans()
    trace.clear()
    spins = sorted((ev for ev in prof.profiler.kineto_results.events()
                    if ev.device_type() == torch.autograd.DeviceType.CUDA
                    and not ev.is_user_annotation()
                    and ("spin" in ev.name() or "sleep" in ev.name())),
                   key=lambda ev: ev.start_ns())
    assert len(spins) == trace.ANCHOR_TRIES + 3 * len(rounds), [ev.name() for ev in spins]
    kernels = spins[trace.ANCHOR_TRIES + 1::3]
    err = outer.attrs["anchor_err_ns"]
    offsets = []
    for k, (kern_sp, wait_sp) in zip(kernels, rounds):
        # the end event is recorded after the synchronize: the device reaches
        # it one launch latency (LATENCY_NS at most) after the host
        assert wait_sp.host_start_ns - err <= wait_sp.device_start_ns < wait_sp.device_end_ns \
            <= wait_sp.host_end_ns + err + LATENCY_NS
        offsets.append((k.start_ns() - kern_sp.device_start_ns, kern_sp.device_end_ns - k.end_ns()))
    print(f"anchor error {err} ns; kernel start - span device start, span device end - kernel "
          f"end (ns): {offsets}")
    assert all(abs(a) < 50_000 and abs(b) < 50_000 for a, b in offsets)
