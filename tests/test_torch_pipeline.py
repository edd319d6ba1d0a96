"""The port's whole slice against the JAX package, on the CPU.

Encode -> Diffuse -> Decode on the sd3 SMOKE config with the noise passed
in; parameter counts of the full sd3 built on the ``meta`` device; and,
under the reference's own hardware constants, the profiler's stage times and
the planners' placements, ILP solves and dispatch decisions, which must be
bit-equal: both planners are pure Python over the same cost model.
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
from repro.core.dispatcher import Dispatcher as JDispatcher
from repro.core.orchestrator import Orchestrator as JOrchestrator
from repro.core.placement import PlacementPlan as JPlan
from repro.core.request import Request as JRequest
from repro.models import diffusion as jdiff
from repro.models import pipeline as jpl
from repro_torch import convert
from repro_torch.core import ilp as tilp
from repro_torch.core import profiler as tprof
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
    dispatch_overhead=jprof.DISPATCH_OVERHEAD)

RESOLUTIONS = (512, 1024, 1536)      # the quickstart's three requests


def test_slice_matches_jax_end_to_end():
    jcfg, tcfg = JC.get_smoke("sd3"), TC.get_smoke("sd3")
    params = jpl.init(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    layers = dict(params["diffuse"]["layers"])
    layers["mod"] = jnp.asarray(rng.standard_normal(layers["mod"].shape).astype(np.float32)
                                * 0.05)
    params = dict(params, diffuse=dict(params["diffuse"], layers=layers))
    pipe = convert.from_jax(tcfg, jax.tree_util.tree_map(np.asarray, params), "cpu")

    res = 64
    toks = rng.integers(0, jcfg.encoder.vocab_size, (1, 12))
    grid = jcfg.latent_grid(res)
    assert grid == tcfg.latent_grid(res)
    noise = rng.standard_normal((1, jcfg.latent_tokens(res), jcfg.dit.latent_dim)
                                ).astype(np.float32)
    j_cond = jpl.encode(jcfg, params, jnp.asarray(toks, jnp.int32))
    j_lat = jdiff.ddim_denoise(jcfg.dit, params["diffuse"], jnp.asarray(noise), j_cond,
                               jcfg.num_steps)
    j_img = jpl.decode(jcfg, params, j_lat, grid)

    t_cond = tpl.encode(pipe, torch.from_numpy(toks))
    t_lat = tpl.diffuse(pipe, t_cond, noise.shape, noise=torch.from_numpy(noise))
    t_img = tpl.decode(pipe, t_lat, grid)
    # float32 both sides; the three DDIM steps amplify f32 rounding (each
    # divides by sqrt(alpha_bar) ~ 0.006 at t=999), so latents get 1e-3
    np.testing.assert_allclose(t_cond.numpy(), np.asarray(j_cond), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(t_lat.numpy(), np.asarray(j_lat), atol=1e-3, rtol=1e-3)
    assert t_img.shape == j_img.shape == (1, res, res, 3)
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), atol=1e-3, rtol=1e-3)


def test_stage_proc_len_matches_jax():
    jcfg, tcfg = JC.get("sd3"), TC.get("sd3")
    for res in (256, 512, 1024, 1536):
        for stage in "EDC":
            assert (tpl.stage_proc_len(tcfg, stage, res, 0.0)
                    == jpl.stage_proc_len(jcfg, stage, res, 0.0))


def test_param_counts_on_meta_match_jax():
    jp = jprof.Profiler(JC.get("sd3"))
    tp = tprof.Profiler(TC.get("sd3"))
    assert {s: (i.params, i.bytes) for s, i in tp.info.items()} == \
           {s: (i.params, i.bytes) for s, i in jp.info.items()}
    assert tp.info["E"].params == 4_893_904_896
    assert tp.info["D"].params == 1_033_176_576
    assert tp.info["C"].params == 3_172_032


def _requests(request_cls, prof):
    reqs = []
    for res in RESOLUTIONS:
        r = request_cls("sd3", res)
        r.deadline = 2.5 * prof.pipeline_time(r)
        reqs.append(r)
    return reqs


def test_stage_time_bit_equal_under_reference_hardware():
    jp = jprof.Profiler(JC.get("sd3"))
    tp = tprof.Profiler(TC.get("sd3"), hw=REF_HW)
    assert tp.k_min == jp.k_min
    for res in (256, 512, 1024, 1536, 2048):
        for cond_len in (77, 128):
            jr = JRequest("sd3", res, cond_len=cond_len)
            tr = TRequest("sd3", res, cond_len=cond_len)
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


@pytest.mark.parametrize("chips", [1, 32])
def test_plans_and_dispatch_bit_equal_under_reference_hardware(chips):
    jp = jprof.Profiler(JC.get("sd3"))
    tp = tprof.Profiler(TC.get("sd3"), hw=REF_HW)
    jreqs, treqs = _requests(JRequest, jp), _requests(TRequest, tp)
    assert [r.deadline for r in treqs] == [r.deadline for r in jreqs]
    jplan = JOrchestrator(jp, num_chips=chips).generate(jreqs)
    tplan = TOrchestrator(tp, num_chips=chips).generate(treqs)
    assert tplan.type_histogram() == jplan.type_histogram()
    assert tplan.placements == jplan.placements
    idle = set(range(jplan.num_units))
    jdec = JDispatcher(jp).dispatch(jreqs, jplan, set(idle), {g: 0.0 for g in idle}, 0.0)
    tdec = TDispatcher(tp).dispatch(treqs, tplan, set(idle), {g: 0.0 for g in idle}, 0.0)

    def key(d):
        return (d.request.resolution, d.vr_type, d.degree, d.d_units, d.e_units, d.c_units,
                tuple(r.resolution for r in d.corequests))

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


def _mixed_requests(request_cls, prof, seed):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(24):
        res = int(rng.choice([256, 512, 1024, 1536, 2048]))
        r = request_cls("sd3", res, cond_len=int(rng.choice([77, 128])),
                        arrival=0.01 * i)
        # loose, tight and hopeless deadlines: the on-time and the late
        # reward paths
        r.deadline = r.arrival + float(rng.choice([0.3, 1.0, 2.5, 6.0])) * prof.pipeline_time(r)
        reqs.append(r)
    return reqs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dispatch_rounds_bit_equal_on_a_mixed_plan(seed):
    """Several dispatch rounds over one pending set: grants free and take
    units, so later rounds use the warm start and the auxiliary units."""
    jp = jprof.Profiler(JC.get("sd3"))
    tp = tprof.Profiler(TC.get("sd3"), hw=REF_HW)
    jplan = JPlan(list(MIXED), unit_size=jp.k_min, units_per_node=8)
    tplan = TPlan(list(MIXED), units_per_node=8)
    jpend, tpend = _mixed_requests(JRequest, jp, seed), _mixed_requests(TRequest, tp, seed)
    jd, td = JDispatcher(jp), TDispatcher(tp)
    idle = set(range(len(MIXED)))
    free_at = {g: 0.0 for g in idle}
    tau, rounds = 0.0, 0
    while tpend and rounds < 12:
        jdec = jd.dispatch(jpend, jplan, set(idle), dict(free_at), tau)
        tdec = td.dispatch(tpend, tplan, set(idle), dict(free_at), tau)

        def key(d):
            return (d.request.resolution, d.request.cond_len, d.vr_type, d.degree,
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


def test_one_chip_places_one_edc_unit():
    tp = tprof.Profiler(TC.get("sd3"))       # the H100 set
    plan = TOrchestrator(tp, num_chips=1).generate(_requests(TRequest, tp))
    assert plan.placements == ["EDC"]


def test_h100_profiler_has_no_tpu_constants():
    hw = tprof.H100_SXM
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw, hw.hbm_bytes) == (989e12, 3.35e12, 900e9,
                                                                    80 * 10 ** 9)
    tpu = {jprof.PEAK_FLOPS, jprof.HBM_BW, jprof.ICI_BW, jprof.HBM_BYTES}
    assert not tpu & {hw.peak_flops, hw.hbm_bw, hw.link_bw, hw.hbm_bytes}
    assert dataclasses.replace(hw, name="x") != hw


def test_serve_on_cpu_answers_three_smoke_requests():
    cfg = TC.get_smoke("sd3")
    reqs = [TRequest(cfg.name, r) for r in (64, 128, 256)]
    recs = quickstart.serve(cfg, reqs, device="cpu", seed=0)
    assert [r["resolution"] for r in recs] == [64, 128, 256]
    for rec, req in zip(recs, reqs):
        out = rec["output"]
        assert out.shape == (1, req.resolution, req.resolution, 3)
        assert torch.isfinite(out).all()
        assert set(rec["stage_ms"]) == set(rec["predicted_ms"]) == {"E", "D", "C"}
        assert rec["decision"]["vr_type"] == 0 and rec["decision"]["d_units"] == (0,)
        assert req.finished
