"""Every Table 5 class, on the CPU: the quickstart's two tables cover the
traffic mixes exactly, the heaviest class of each pipeline and the 128 px
class match the JAX package end to end at the SMOKE configs' geometry, and
a serve with its DDIM loop cut matches the reference's loop of the same
steps, with the Diffuse prediction scaled to them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.core import workloads as jwl
from repro.models import diffusion as jdiff
from repro.models import pipeline as jpl
from repro_torch import convert
from repro_torch import device as tdevice
from repro_torch.core import profiler as tprof
from repro_torch.core.request import Request
from repro_torch.launch import calibrate, quickstart
from repro_torch.models import pipeline as tpl

PIPELINES = TC.PIPELINE_IDS


@pytest.mark.parametrize("pipeline", PIPELINES)
def test_requests_and_heavy_are_the_classes_of_the_mixes(pipeline):
    mixes = {(res, float(sec)) for mix in jwl.MIXES[pipeline].values() for (res, sec), _ in mix}
    whole, heavy = set(quickstart.REQUESTS[pipeline]), set(quickstart.HEAVY[pipeline])
    assert whole | heavy == mixes and not whole & heavy
    assert len(quickstart.REQUESTS[pipeline]) == len(whole)
    assert len(quickstart.HEAVY[pipeline]) == len(heavy)


def test_the_tables_hold_all_28_classes_and_their_lengths():
    # Table 5's pipelines; the port-only hunyuanvideo-t2v class is outside the table
    n_whole = sum(len(quickstart.REQUESTS[p]) for p in PIPELINES)
    n_heavy = sum(len(quickstart.HEAVY[p]) for p in PIPELINES)
    assert (n_whole, n_heavy) == (11, 17)
    longest = max(TC.get(p).latent_tokens(res, sec) + 77
                  for p in PIPELINES for res, sec in quickstart.HEAVY[p])
    shortest = min(TC.get(p).latent_tokens(res, sec) + 77
                   for p in PIPELINES for res, sec in quickstart.REQUESTS[p])
    assert (shortest, longest) == (141, 81077)


def _converted(pipeline):
    """The JAX SMOKE pipeline's weights (with a nonzero AdaLN modulation, so
    the attention shows in the output) and the port's pipeline on them."""
    jcfg, tcfg = JC.get_smoke(pipeline), TC.get_smoke(pipeline)
    params = jpl.init(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    layers = dict(params["diffuse"]["layers"])
    layers["mod"] = jnp.asarray(rng.standard_normal(layers["mod"].shape).astype(np.float32)
                                * 0.05)
    params = dict(params, diffuse=dict(params["diffuse"], layers=layers))
    return jcfg, tcfg, params, convert.from_jax(tcfg, jax.tree_util.tree_map(np.asarray, params),
                                                "cpu")


def _ends():
    """(pipeline, class at SMOKE geometry): the largest heavy class of each
    pipeline that has one, and the 128 px class of each that has one."""
    out = []
    for p in PIPELINES:
        tcfg = TC.get(p)
        heavy = quickstart.HEAVY[p]
        if heavy:
            big = max(heavy, key=lambda c: tcfg.latent_tokens(*c))
            out.append((p, quickstart.smoke_classes([big])[0]))
        if (128, 0.0) in quickstart.REQUESTS[p]:
            out.append((p, quickstart.smoke_classes([(128, 0.0)])[0]))
    return out


@pytest.mark.parametrize("pipeline,cls", _ends())
def test_table5_ends_match_jax_end_to_end(pipeline, cls):
    jcfg, tcfg, params, pipe = _converted(pipeline)
    res, sec = cls
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.encoder.vocab_size, (1, 12))
    grid = jcfg.latent_grid(res, sec)
    assert grid == tcfg.latent_grid(res, sec)
    shape = (1, jcfg.latent_tokens(res, sec), jcfg.dit.latent_dim)
    noise = rng.standard_normal(shape).astype(np.float32)
    j_cond = jpl.encode(jcfg, params, jnp.asarray(toks, jnp.int32))
    j_lat = jdiff.ddim_denoise(jcfg.dit, params["diffuse"], jnp.asarray(noise), j_cond,
                               jcfg.num_steps)
    j_img = jpl.decode(jcfg, params, j_lat, grid)

    t_cond = tpl.encode(pipe, torch.from_numpy(toks))
    t_lat = tpl.diffuse(pipe, t_cond, shape, noise=torch.from_numpy(noise))
    # Decode on the reference's latents: the SMOKE decoder's random weights
    # put every pixel deep in tanh's saturation, a sign of a large value, so
    # the latents' 1e-4 of f32 rounding flips the rare pixel whose value sits
    # near zero (one of 786432 at flux's 512 px); on the same latents the
    # two decoders agree
    t_img = tpl.decode(pipe, torch.from_numpy(np.array(j_lat)), grid)
    # the tolerances of test_slice_matches_jax_end_to_end: float32 both sides,
    # the DDIM steps amplify f32 rounding
    np.testing.assert_allclose(t_cond.numpy(), np.asarray(j_cond), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(t_lat.numpy(), np.asarray(j_lat), atol=1e-3, rtol=1e-3)
    f, h, w = grid
    assert t_img.shape == j_img.shape == (f, 16 * h, 16 * w, 3)
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("pipeline", ["flux", "cogvideox"])
def test_serve_with_one_step_matches_the_references_one_step_loop(pipeline, monkeypatch):
    """``serve(num_steps=1)`` on a heavy class at SMOKE geometry: its Diffuse
    gives the reference's ``ddim_denoise(..., 1)`` on the same tokens and
    noise, its output is those latents decoded, the record carries its
    steps, and the Diffuse prediction is the profiler's with the steps'
    part scaled to one."""
    jcfg, tcfg, params, pipe = _converted(pipeline)
    res, sec = quickstart.smoke_requests(pipeline, quickstart.HEAVY)[-1]
    seed = 3
    latents = []
    diffuse = tpl.diffuse

    def recorded(*a, **kw):
        latents.append(diffuse(*a, **kw))
        return latents[-1]
    monkeypatch.setattr(tpl, "diffuse", recorded)
    (rec,) = quickstart.serve(tcfg, [Request(tcfg.name, res, sec)], device="cpu", seed=seed,
                              pipe=pipe, num_steps=1)
    # the tokens and noise serve draws for its first request
    toks = np.random.default_rng(seed).integers(0, tcfg.encoder.vocab_size, size=77)
    shape = (1, tcfg.latent_tokens(res, sec), tcfg.dit.latent_dim)
    noise = torch.randn(shape, dtype=torch.float32,
                        generator=tdevice.generator(torch.device("cpu"), seed + 1)).numpy()
    grid = jcfg.latent_grid(res, sec)
    j_cond = jpl.encode(jcfg, params, jnp.asarray(toks[None], jnp.int32))
    j_lat = jdiff.ddim_denoise(jcfg.dit, params["diffuse"], jnp.asarray(noise), j_cond, 1)
    assert tcfg.num_steps > 1 and rec["num_steps"] == 1
    np.testing.assert_allclose(latents[0].numpy(), np.asarray(j_lat), atol=1e-3, rtol=1e-3)
    assert torch.equal(rec["output"], tpl.decode(pipe, latents[0], grid))
    # the decoders agree on the same latents (see test_table5_ends_match_jax_end_to_end)
    np.testing.assert_allclose(tpl.decode(pipe, torch.from_numpy(np.array(j_lat)), grid).numpy(),
                               np.asarray(jpl.decode(jcfg, params, j_lat, grid)),
                               atol=1e-3, rtol=1e-3)

    prof = tprof.Profiler(tcfg, hw=tprof.H100_SXM)
    req = Request(tcfg.name, res, sec)
    fixed = tprof.H100_SXM.dispatch_overhead
    whole = prof.stage_time(req, "D", 1)
    assert rec["predicted_ms"]["D"] == pytest.approx(
        (fixed + (whole - fixed) / tcfg.num_steps) * 1e3, rel=1e-12)
    for stage in "EC":
        assert rec["predicted_ms"][stage] == prof.stage_time(req, stage, 1) * 1e3
    full = quickstart.predicted_ms(prof, req, "D", 1, tcfg.num_steps)
    assert full == pytest.approx(whole * 1e3, rel=1e-12)


def test_calibration_scales_cut_readings_and_fits_only_whole_ones():
    """A reading of a Diffuse cut to one step is priced at one step and is
    not fitted, even at a fitted class."""
    one = {"pipeline": "flux", "resolution": 512, "seconds": 0.0, "num_steps": 1,
           "stage": "D", "ms": 40.0}
    whole = dict(one, num_steps=4, ms=140.5)
    rows = calibrate.table(tprof.H100_SXM, [one, whole])
    prof = tprof.Profiler(TC.get("flux"), hw=tprof.H100_SXM)
    req = Request("flux", 512, 0.0)
    assert rows[0]["predicted_ms"] == quickstart.predicted_ms(prof, req, "D", 1, 1)
    assert rows[1]["predicted_ms"] == prof.stage_time(req, "D", 1) * 1e3
    assert [r["fitted"] for r in rows] == [False, True]
    assert calibrate.outside_band(tprof.H100_SXM, [one]) == []


def test_heavy_classes_parse_the_command_line():
    assert quickstart.heavy_classes("cogvideox", "720x10,480x4") == ((720, 10.0), (480, 4.0))
    assert quickstart.heavy_classes("flux", "4096") == ((4096, 0.0),)
    assert quickstart.heavy_classes("hunyuanvideo", "all") == quickstart.HEAVY["hunyuanvideo"]
    with pytest.raises(ValueError, match="no heavy class"):
        quickstart.heavy_classes("flux", "1024")


def test_quickstart_cli_serves_a_heavy_class_cut_to_one_step(capsys):
    quickstart.main(["--pipeline", "cogvideox", "--device", "cpu", "--smoke", "--heavy",
                     "720x10", "--num-steps", "1"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and "res=90 s=5.0 steps=1 out=(20, 80, 80, 3)" in out[0]


def test_one_chip_places_every_class_as_one_edc_unit():
    """The one-chip plan the quickstart serves each class on, heavy ones
    too, on H100_SXM: one EDC unit that fits every request."""
    from repro_torch.core.orchestrator import Orchestrator
    for p in PIPELINES:
        prof = tprof.Profiler(TC.get(p), hw=tprof.H100_SXM)
        reqs = [Request(p, res, sec) for res, sec in quickstart.REQUESTS[p] + quickstart.HEAVY[p]]
        for r in reqs:
            r.deadline = 2.5 * prof.pipeline_time(r)
        plan = Orchestrator(prof, num_chips=1).generate(reqs)
        assert plan.placements == ["EDC"]
        assert all(prof.fits(r, "EDC", 1) for r in reqs)


def test_smoke_geometry_keeps_the_heavy_classes_small_and_the_videos_long():
    for p in PIPELINES:
        cfg = TC.get_smoke(p)
        for res, sec in quickstart.smoke_requests(p, quickstart.HEAVY):
            assert cfg.latent_tokens(res, sec) <= 1024
            assert cfg.latent_grid(res, sec)[0] >= (2 if cfg.is_video else 1)
