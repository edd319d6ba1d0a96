"""The port's cross-node SP against the JAX package's, on the CPU.

``Profiler(cross_node_sp=True)`` widens the SP degrees to 32 units across
nodes, and the dispatcher then pools the idle units of several nodes when
no single node holds the degree.  Under the reference's constant set
(``REF_HW``, whose links span every chip) the port must give every
``SimResult`` field (but the wall-clock ``solver_ms``) bit-equal to
``repro.core.simulator.run_sim(cross_node_sp=True)``, every ``FleetResult``
field and request stage time bit-equal to a reference fleet on
``PipelineRegistry(cross_node_sp=True)``, and the serving CLI's JSON equal
to the reference CLI's.  On ``H100_SXM`` a group wider than one 8-GPU node
exchanges at the inter-node rate.
"""
import dataclasses
import random
import sys

import pytest

import repro.configs as JC
from repro.core import fleet as jfleet
from repro.core import workloads as jwl
from repro.core.dispatcher import Dispatcher as JDispatcher
from repro.core.placement import PlacementPlan as JPlan
from repro.core.profiler import Profiler as JProfiler
from repro.core.request import Request as JRequest
from repro.core.simulator import run_sim as jrun_sim
from repro.core.trident import TridentScheduler as JTrident
import repro_torch.configs as TC
from repro_torch.core import fleet as tfleet
from repro_torch.core import workloads as twl
from repro_torch.core.dispatcher import Dispatcher as TDispatcher
from repro_torch.core.placement import PlacementPlan as TPlan
from repro_torch.core.profiler import H100_SXM, REFERENCE_HW, Profiler as TProfiler
from repro_torch.core.request import Request as TRequest
from repro_torch.core.simulator import run_sim as trun_sim
from repro_torch.core.trident import TridentScheduler as TTrident
from repro_torch.launch import serve
from test_torch_cluster import assert_same as assert_same_sim
from test_torch_fleet import FLIP_CFG, FLIP_DURATION, FLIP_PIPES, _flip_trace, assert_same
from test_torch_pipeline import REF_HW

PIPES = ("sd3", "flux", "cogvideox", "hunyuanvideo")


@pytest.mark.parametrize("pipeline", PIPES)
def test_degrees_widen_like_the_reference(pipeline):
    """The widened ``max_degree_units`` and every Table 5 class's optimal
    degree per stage, with and without cross-node SP."""
    for cross in (False, True):
        want = JProfiler(JC.get(pipeline), cross_node_sp=cross)
        got = TProfiler(TC.get(pipeline), hw=REF_HW, cross_node_sp=cross)
        assert (got.cross_node_sp, got.k_min, got.max_degree_units) == \
            (want.cross_node_sp, want.k_min, want.max_degree_units)
        for mix in jwl.MIXES[pipeline].values():
            for (res, sec), _ in mix:
                for s in "EDC":
                    assert got.optimal_degree(TRequest(pipeline, res, float(sec)), s) == \
                        want.optimal_degree(JRequest(pipeline, res, float(sec)), s)
    wide = TProfiler(TC.get(pipeline), hw=H100_SXM, cross_node_sp=True)
    assert wide.max_degree_units == 32 // wide.k_min
    assert TProfiler(TC.get(pipeline), hw=H100_SXM).max_degree_units == max(1, 8 // wide.k_min)


def test_h100_prices_a_group_beyond_one_node_at_the_inter_node_rate():
    prof = TProfiler(TC.get("hunyuanvideo"), hw=H100_SXM, cross_node_sp=True)
    assert H100_SXM.link_domain_chips == 8
    assert prof._link_bw(8) == H100_SXM.link_bw
    assert prof._link_bw(16) == prof._link_bw(32) == H100_SXM.inter_node_bw
    ref = TProfiler(TC.get("hunyuanvideo"), hw=REFERENCE_HW, cross_node_sp=True)
    assert ref._link_bw(32) == REFERENCE_HW.link_bw
    # the Diffuse stage's all-to-alls at 16 chips: priced at the NIC's rate
    req = TRequest("hunyuanvideo", 720, 5.0)
    i = prof.info["D"]
    l = prof.latent_tokens(req) + req.cond_len
    comm = (prof.cfg.num_steps * i.num_layers * 2 * l * i.d_model * 2 * 15 / 256
            / H100_SXM.inter_node_bw)
    flat = dataclasses.replace(H100_SXM, link_domain_chips=0)
    fast = TProfiler(TC.get("hunyuanvideo"), hw=flat, cross_node_sp=True)
    nvlink = comm * H100_SXM.inter_node_bw / H100_SXM.link_bw
    assert prof.stage_time(req, "D", 16) - fast.stage_time(req, "D", 16) == \
        pytest.approx(comm - nvlink, rel=1e-9)


def test_select_units_spans_nodes_like_the_reference():
    """One node cannot host 16 units; with ``cross_node`` the idle units of
    ascending nodes pool (tests/test_core_planning.py), and random idle sets
    pick the same units as the reference's."""
    plans = [P(["EDC"] * 32, unit_size=1, units_per_node=8) for P in (JPlan, TPlan)]
    idle = set(range(32))
    assert TDispatcher.select_units(plans[1], "EDC", 16, idle) is None
    units = TDispatcher.select_units(plans[1], "EDC", 16, idle, cross_node=True)
    assert units == tuple(range(16))
    rng = random.Random(0)
    for _ in range(200):
        idle = {g for g in range(32) if rng.random() < 0.6}
        k = rng.choice((1, 2, 4, 8, 12, 16, 24))
        for cross in (False, True):
            assert TDispatcher.select_units(plans[1], "EDC", k, idle, cross) == \
                JDispatcher.select_units(plans[0], "EDC", k, idle, cross)


CELLS = {"flux": 60.0, "cogvideox": 240.0, "hunyuanvideo": 120.0}


@pytest.mark.parametrize("pipeline", sorted(CELLS))
def test_run_sim_cross_node_bit_equal(pipeline):
    """The heavy workload, where the widest degrees pay off: trident
    dispatches groups wider than one node, through the dispatcher's pooled
    cross-node unit selection."""
    ref = jrun_sim(pipeline, JTrident, "heavy", CELLS[pipeline], cross_node_sp=True)
    port = trun_sim(pipeline, TTrident, "heavy", CELLS[pipeline], cross_node_sp=True,
                    hw=REF_HW)
    assert port.n_requests > 0
    assert_same_sim(ref, port)
    node_units = 8 // TProfiler(TC.get(pipeline), hw=REF_HW).k_min
    assert max(port.degree_histogram) > node_units
    assert sum(port.degree_histogram.values()) == sum(port.vr_histogram.values())


def test_fleet_cross_node_bit_equal():
    """The mix-flip trace at 64 chips on a registry with cross-node SP."""
    out = []
    for F, W, kw in ((jfleet, jwl, {}), (tfleet, twl, {"hw": REF_HW})):
        reg = F.PipelineRegistry(FLIP_PIPES, cross_node_sp=True, **kw)
        trace = _flip_trace(W, {p: reg.profiler(p) for p in FLIP_PIPES})
        res = F.run_fleet(FLIP_PIPES, mode="adaptive", duration=FLIP_DURATION,
                          cfg=F.FleetConfig(**FLIP_CFG), registry=reg, trace=trace)
        out.append((res, trace))
    (ref, jtrace), (port, ttrace) = out
    assert_same(ref, port, jtrace, ttrace)
    narrow = tfleet.run_fleet(FLIP_PIPES, mode="adaptive", duration=FLIP_DURATION,
                              cfg=tfleet.FleetConfig(**FLIP_CFG),
                              trace=_flip_trace(twl, {p: TProfiler(TC.get(p), hw=REF_HW)
                                                      for p in FLIP_PIPES}),
                              hw=REF_HW)
    assert dataclasses.asdict(narrow) != dataclasses.asdict(port)


def test_serve_cross_node_json_is_the_references(tmp_path, monkeypatch, capsys):
    from repro.launch import serve as jserve
    argv = ["--pipeline", "cogvideox", "--workload", "heavy", "--duration", "120",
            "--chips", "64", "--baselines", "B5", "--cross-node-sp"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv + ["--json", str(tmp_path / "ref.jsonl")])
    jserve.main()
    ref_out = capsys.readouterr().out
    results = serve.main(argv + ["--hw", "reference", "--json", str(tmp_path / "port.jsonl")])
    port_out = capsys.readouterr().out
    assert (tmp_path / "port.jsonl").read_bytes() == (tmp_path / "ref.jsonl").read_bytes()
    assert [r.scheduler for r in results] == ["trident", "B5"]
    # the summary lines too, but for the port's solver time
    assert [ln.split("; solver")[0] for ln in port_out.splitlines()] == ref_out.splitlines()
