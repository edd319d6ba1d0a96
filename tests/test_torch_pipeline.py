"""The port's whole slice against the JAX package, on the CPU, for each of
the four pipelines (sd3, flux, cogvideox, hunyuanvideo).

Encode -> Diffuse -> Decode on each SMOKE config (a video request for the
two video pipelines), held against the reference's ``generate`` with its
noise passed in; parameter counts of each full pipeline built on the
``meta`` device; and, under the reference's own hardware constants, the
profiler's stage times, the planners' placements, ILP solves and dispatch
decisions, and the workload traces, which must be bit-equal: both sides are
pure Python over the same cost model.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.core import ilp as jilp
from repro.core import profiler as jprof
from repro.core import workloads as jwl
from repro.core.dispatcher import Dispatcher as JDispatcher
from repro.core.orchestrator import Orchestrator as JOrchestrator
from repro.core.placement import PlacementPlan as JPlan
from repro.core.request import Request as JRequest
from repro.models import diffusion as jdiff
from repro.models import pipeline as jpl
from repro_torch import convert
from repro_torch.core import ilp as tilp
from repro_torch.core import profiler as tprof
from repro_torch.core import workloads as twl
from repro_torch.core.dispatcher import Dispatcher as TDispatcher
from repro_torch.core.orchestrator import Orchestrator as TOrchestrator
from repro_torch.core.placement import PlacementPlan as TPlan
from repro_torch.core.request import Request as TRequest
from repro_torch.launch import quickstart
from repro_torch.models import pipeline as tpl

# the reference's TPU constant set, read from the JAX package
REF_HW = tprof.Hardware(
    name="reference", peak_flops=jprof.PEAK_FLOPS, hbm_bw=jprof.HBM_BW, link_bw=jprof.ICI_BW,
    hbm_bytes=jprof.HBM_BYTES, mem_reserve=jprof.MEM_RESERVE, mfu=jprof.MFU,
    mfu_conv=jprof.MFU_CONV, seq_mfu_knee=jprof.SEQ_MFU_KNEE,
    dispatch_overhead=jprof.DISPATCH_OVERHEAD, inter_node_bw=jprof.DCN_BW,
    host_bw=jprof.HOST_BW, comm_group_init=jprof.COMM_GROUP_INIT)

PIPELINES = TC.PIPELINE_IDS

# (encoder, DiT, decoder) parameter counts of each full pipeline
PARAMS = {"sd3": (4_893_904_896, 1_033_176_576, 3_172_032),
          "flux": (4_893_904_896, 9_554_758_656, 3_172_032),
          "cogvideox": (267_150_336, 4_279_372_800, 4_720_320),
          "hunyuanvideo": (8_030_261_248, 10_913_713_152, 4_720_320)}


def _classes(pipeline):
    """Every (resolution, seconds) class of the pipeline's traffic mixes,
    and for sd3 the sizes the tests held before the other pipelines came."""
    out = {cls for mix in jwl.MIXES[pipeline].values() for cls, _ in mix}
    if pipeline == "sd3":
        out |= {(res, 0) for res in (256, 512, 1024, 1536, 2048)}
    return sorted(out)


def _slice_request(cfg):
    """A 64 px request; one second of video for the video pipelines."""
    return 64, (1.0 if cfg.is_video else 0.0)


@pytest.mark.parametrize("pipeline", PIPELINES)
def test_slice_matches_jax_end_to_end(pipeline):
    jcfg, tcfg = JC.get_smoke(pipeline), TC.get_smoke(pipeline)
    params = jpl.init(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    layers = dict(params["diffuse"]["layers"])
    layers["mod"] = jnp.asarray(rng.standard_normal(layers["mod"].shape).astype(np.float32)
                                * 0.05)
    params = dict(params, diffuse=dict(params["diffuse"], layers=layers))
    pipe = convert.from_jax(tcfg, jax.tree_util.tree_map(np.asarray, params), "cpu")

    res, sec = _slice_request(tcfg)
    toks = rng.integers(0, jcfg.encoder.vocab_size, (1, 12))
    grid = jcfg.latent_grid(res, sec)
    assert grid == tcfg.latent_grid(res, sec)
    shape = (1, jcfg.latent_tokens(res, sec), jcfg.dit.latent_dim)
    key = jax.random.PRNGKey(5)
    j_img = jpl.generate(jcfg, params, jnp.asarray(toks, jnp.int32), res, sec, key)
    # the reference's generate draws its noise from the key; the port is given it
    noise = np.array(jax.random.normal(key, shape, jnp.float32))
    j_cond = jpl.encode(jcfg, params, jnp.asarray(toks, jnp.int32))
    j_lat = jdiff.ddim_denoise(jcfg.dit, params["diffuse"], jnp.asarray(noise), j_cond,
                               jcfg.num_steps)

    t_cond = tpl.encode(pipe, torch.from_numpy(toks))
    t_lat = tpl.diffuse(pipe, t_cond, shape, noise=torch.from_numpy(noise))
    t_img = tpl.decode(pipe, t_lat, grid)
    # float32 both sides; the DDIM steps amplify f32 rounding (each divides
    # by sqrt(alpha_bar) ~ 0.006 at t=999), so latents get 1e-3
    np.testing.assert_allclose(t_cond.numpy(), np.asarray(j_cond), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(t_lat.numpy(), np.asarray(j_lat), atol=1e-3, rtol=1e-3)
    f, h, w = grid
    assert t_img.shape == j_img.shape == (f, 16 * h, 16 * w, 3)
    assert (f > 1) == tcfg.is_video          # the videos fold frames into the batch
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("pipeline", PIPELINES)
def test_stage_proc_len_matches_jax(pipeline):
    jcfg, tcfg = JC.get(pipeline), TC.get(pipeline)
    for res, sec in _classes(pipeline):
        for stage in "EDC":
            assert (tpl.stage_proc_len(tcfg, stage, res, sec)
                    == jpl.stage_proc_len(jcfg, stage, res, sec))


@pytest.mark.parametrize("pipeline", PIPELINES)
def test_param_counts_on_meta_match_jax(pipeline):
    jp = jprof.Profiler(JC.get(pipeline))
    tp = tprof.Profiler(TC.get(pipeline))
    assert {s: (i.params, i.bytes) for s, i in tp.info.items()} == \
           {s: (i.params, i.bytes) for s, i in jp.info.items()}
    assert tuple(tp.info[s].params for s in "EDC") == PARAMS[pipeline]


def _requests(request_cls, prof, pipeline):
    """The classes the quickstart serves on one chip, with their deadlines."""
    reqs = []
    for res, sec in quickstart.REQUESTS[pipeline]:
        r = request_cls(pipeline, res, sec)
        r.deadline = 2.5 * prof.pipeline_time(r)
        reqs.append(r)
    return reqs


@pytest.mark.parametrize("pipeline", PIPELINES)
def test_stage_time_bit_equal_under_reference_hardware(pipeline):
    jp = jprof.Profiler(JC.get(pipeline))
    tp = tprof.Profiler(TC.get(pipeline), hw=REF_HW)
    assert tp.k_min == jp.k_min
    for res, sec in _classes(pipeline):
        for cond_len in (77, 128):
            jr = JRequest(pipeline, res, sec, cond_len=cond_len)
            tr = TRequest(pipeline, res, sec, cond_len=cond_len)
            for stage in "EDC":
                assert tp.optimal_degree(tr, stage) == jp.optimal_degree(jr, stage)
                for k in (1, 2, 4, 8):
                    assert tp.stage_time(tr, stage, k) == jp.stage_time(jr, stage, k)
                    assert (tp.batched_stage_time(tr, stage, k, 4)
                            == jp.batched_stage_time(jr, stage, k, 4))
            for ptype in ("EDC", "DC", "D", "E", "C"):
                assert tp.peak_mem(tr, ptype, 1) == jp.peak_mem(jr, ptype, 1)
                assert tp.fits(tr, ptype, 1) == jp.fits(jr, ptype, 1)
            assert tp.pipeline_time(tr) == jp.pipeline_time(jr)


@pytest.mark.parametrize("pipeline", PIPELINES)
@pytest.mark.parametrize("chips", [1, 32])
def test_plans_and_dispatch_bit_equal_under_reference_hardware(chips, pipeline):
    jp = jprof.Profiler(JC.get(pipeline))
    tp = tprof.Profiler(TC.get(pipeline), hw=REF_HW)
    jreqs, treqs = _requests(JRequest, jp, pipeline), _requests(TRequest, tp, pipeline)
    assert [r.deadline for r in treqs] == [r.deadline for r in jreqs]
    jplan = JOrchestrator(jp, num_chips=chips).generate(jreqs)
    tplan = TOrchestrator(tp, num_chips=chips).generate(treqs)
    if jplan is None:
        # under the reference's constants the pipeline's unit needs more chips
        assert tplan is None and chips < jp.k_min
        return
    assert tplan.type_histogram() == jplan.type_histogram()
    assert tplan.placements == jplan.placements
    idle = set(range(jplan.num_units))
    jdec = JDispatcher(jp).dispatch(jreqs, jplan, set(idle), {g: 0.0 for g in idle}, 0.0)
    tdec = TDispatcher(tp).dispatch(treqs, tplan, set(idle), {g: 0.0 for g in idle}, 0.0)

    def key(d):
        return (d.request.key(), d.vr_type, d.degree, d.d_units, d.e_units, d.c_units,
                tuple(r.key() for r in d.corequests))

    assert [key(d) for d in tdec] == [key(d) for d in jdec]
    assert tdec                              # the planners placed something


def _instance(seed):
    """Random dispatch instance: options drawn on 4 budget dims, many of them
    repeated (same-class requests), plus a warm start from a random subset."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    budgets = [int(b) for b in rng.integers(0, 9, size=4)]
    classes = []
    for _ in range(int(rng.integers(1, 6))):
        opts = []
        for _ in range(int(rng.integers(0, 7))):
            opts.append((int(rng.integers(0, 4)), int(rng.choice([1, 2, 4, 8])),
                         float(np.round(rng.uniform(-50, 1000), 3))))
        classes.append(opts)
    rows = [classes[int(rng.integers(0, len(classes)))] for _ in range(n)]
    warm = {}
    for r in range(n):
        if rows[r] and rng.random() < 0.3:
            d, u, _ = rows[r][int(rng.integers(0, len(rows[r])))]
            warm[r] = (d, u)
    return rows, budgets, warm


@pytest.mark.parametrize("seed", range(40))
@pytest.mark.parametrize("node_cap", [25, 200_000])
def test_ilp_solve_bit_equal(seed, node_cap):
    rows, budgets, warm = _instance(seed)
    j = jilp.solve([[jilp.Option(*o) for o in opts] for opts in rows], budgets,
                   node_cap=node_cap, warm=warm or None)
    t = tilp.solve([[tilp.Option(*o) for o in opts] for opts in rows], budgets,
                   node_cap=node_cap, warm=warm or None)
    assert (t.reward, t.nodes, t.optimal) == (j.reward, j.nodes, j.optimal)
    assert ({r: (o.dim, o.usage, o.reward) for r, o in t.choices.items()}
            == {r: (o.dim, o.usage, o.reward) for r, o in j.choices.items()})
    assert list(t.choices) == list(j.choices)


# every placement type, two 8-unit nodes
MIXED = ["EDC"] * 2 + ["DC"] * 2 + ["ED"] * 2 + ["D"] * 2 + ["D"] * 2 + ["E"] * 3 + ["C"] * 3


def _mixed_requests(request_cls, prof, seed, pipeline):
    rng = np.random.default_rng(seed)
    classes = ([(res, 0.0) for res in (256, 512, 1024, 1536, 2048)] if pipeline == "sd3"
               else _classes(pipeline))
    reqs = []
    for i in range(24):
        res, sec = classes[int(rng.integers(0, len(classes)))]
        r = request_cls(pipeline, res, sec, cond_len=int(rng.choice([77, 128])),
                        arrival=0.01 * i)
        # loose, tight and hopeless deadlines: the on-time and the late
        # reward paths
        r.deadline = r.arrival + float(rng.choice([0.3, 1.0, 2.5, 6.0])) * prof.pipeline_time(r)
        reqs.append(r)
    return reqs


@pytest.mark.parametrize("pipeline", PIPELINES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dispatch_rounds_bit_equal_on_a_mixed_plan(seed, pipeline):
    """Several dispatch rounds over one pending set: grants free and take
    units, so later rounds use the warm start and the auxiliary units."""
    jp = jprof.Profiler(JC.get(pipeline))
    tp = tprof.Profiler(TC.get(pipeline), hw=REF_HW)
    jplan = JPlan(list(MIXED), unit_size=jp.k_min, units_per_node=8)
    tplan = TPlan(list(MIXED), units_per_node=8)
    jpend = _mixed_requests(JRequest, jp, seed, pipeline)
    tpend = _mixed_requests(TRequest, tp, seed, pipeline)
    jd, td = JDispatcher(jp), TDispatcher(tp)
    idle = set(range(len(MIXED)))
    free_at = {g: 0.0 for g in idle}
    tau, rounds = 0.0, 0
    while tpend and rounds < 12:
        jdec = jd.dispatch(jpend, jplan, set(idle), dict(free_at), tau)
        tdec = td.dispatch(tpend, tplan, set(idle), dict(free_at), tau)

        def key(d):
            return (d.request.key(), d.request.cond_len, d.vr_type, d.degree,
                    d.d_units, d.e_units, d.c_units)

        assert [key(d) for d in tdec] == [key(d) for d in jdec]
        assert td.last_solve_stats == jd.last_solve_stats
        done = {d.request.rid for d in jdec}
        jpend = [r for r in jpend if r.rid not in done]
        done = {d.request.rid for d in tdec}
        tpend = [r for r in tpend if r.rid not in done]
        for d in tdec:
            run = tp.stage_time(d.request, "D", d.degree * tp.k_min)
            for g in set(d.d_units) | set(d.e_units) | set(d.c_units):
                idle.discard(g)
                free_at[g] = max(free_at[g], tau) + run
        # the next round starts when the earliest busy unit frees up
        busy = [free_at[g] for g in free_at if g not in idle]
        tau = min(busy) if busy else tau + 0.1
        idle |= {g for g in free_at if free_at[g] <= tau}
        rounds += 1
    assert rounds > 1


@pytest.mark.parametrize("pipeline", PIPELINES)
def test_one_chip_places_one_edc_unit(pipeline):
    tp = tprof.Profiler(TC.get(pipeline))    # the H100 set
    assert tp.k_min == 1                     # each pipeline fits one 80 GB card whole
    assert set(quickstart.REQUESTS[pipeline]) <= {cls for cls, _ in twl.MIXES[pipeline]["light"]}
    plan = TOrchestrator(tp, num_chips=1).generate(_requests(TRequest, tp, pipeline))
    assert plan.placements == ["EDC"]


def test_h100_profiler_has_no_tpu_constants():
    hw = tprof.H100_SXM
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw, hw.hbm_bytes) == (989e12, 3.35e12, 900e9,
                                                                    80 * 10 ** 9)
    tpu = {jprof.PEAK_FLOPS, jprof.HBM_BW, jprof.ICI_BW, jprof.HBM_BYTES}
    assert not tpu & {hw.peak_flops, hw.hbm_bw, hw.link_bw, hw.hbm_bytes}
    # inter-node link: ConnectX-7, 400 Gb/s per GPU; the host link and the
    # communicator build are measured on the card's machine
    assert hw.inter_node_bw == 400e9 / 8
    tpu_host = {jprof.DCN_BW, jprof.HOST_BW, jprof.COMM_GROUP_INIT, jprof.DISPATCH_OVERHEAD,
                jprof.MFU, jprof.MFU_CONV, jprof.SEQ_MFU_KNEE}
    assert not tpu_host & {hw.inter_node_bw, hw.host_bw, hw.comm_group_init,
                           hw.dispatch_overhead, hw.mfu, hw.mfu_conv, hw.seq_mfu_knee}
    assert dataclasses.replace(hw, name="x") != hw


@pytest.mark.parametrize("pipeline", PIPELINES)
def test_serve_on_cpu_answers_three_smoke_requests(pipeline):
    """The quickstart's smoke requests (three for sd3, as before; a video
    for the video pipelines) served on the CPU after the untimed warm-up."""
    cfg = TC.get_smoke(pipeline)
    classes = (((64, 0.0), (128, 0.0), (256, 0.0)) if pipeline == "sd3"
               else quickstart.smoke_requests(pipeline))
    reqs = [TRequest(cfg.name, res, sec) for res, sec in classes]
    pipe = tpl.build(cfg, "cpu", seed=0)
    quickstart.warm(pipe, reqs)
    recs = quickstart.serve(cfg, reqs, device="cpu", seed=0, pipe=pipe)
    assert [(r["resolution"], r["seconds"]) for r in recs] == list(classes)
    assert any(sec > 0 for _, sec in classes) == cfg.is_video
    for rec, req in zip(recs, reqs):
        out = rec["output"]
        f, h, w = cfg.latent_grid(req.resolution, req.seconds)
        assert out.shape == (f, 16 * h, 16 * w, 3)
        assert torch.isfinite(out).all()
        assert set(rec["stage_ms"]) == set(rec["predicted_ms"]) == {"E", "D", "C"}
        assert rec["decision"]["vr_type"] == 0 and rec["decision"]["d_units"] == (0,)
        assert req.finished


@pytest.mark.parametrize("pipeline", PIPELINES)
@pytest.mark.parametrize("workload", ["light", "medium", "heavy", "dynamic", "proprietary"])
def test_traces_bit_equal_under_reference_hardware(workload, pipeline):
    """``make_trace`` gives the reference's requests: the same classes,
    arrivals and deadlines, bit for bit (the request ids are a process-wide
    counter on each side, so they are not compared)."""
    assert twl.MIXES == jwl.MIXES and twl.RATES == jwl.RATES
    assert (twl.T_WIN, twl.SLO_SCALE, twl.DYNAMIC_PATTERN) == \
           (jwl.T_WIN, jwl.SLO_SCALE, jwl.DYNAMIC_PATTERN)
    jp = jprof.Profiler(JC.get(pipeline))
    tp = tprof.Profiler(TC.get(pipeline), hw=REF_HW)
    duration = twl.T_WIN[pipeline]
    for seed in (0, 3):
        want = jwl.make_trace(pipeline, workload, duration, jp, seed=seed)
        got = twl.make_trace(pipeline, workload, duration, tp, seed=seed)
        assert len(want) > 10

        def key(r):
            return (r.pipeline, r.resolution, r.seconds, r.arrival, r.deadline, r.cond_len)

        assert [key(r) for r in got] == [key(r) for r in want]
    with pytest.raises(KeyError):
        twl.make_trace(pipeline, "bursty", duration, tp)
