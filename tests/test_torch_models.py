"""The port's models against the JAX package on each pipeline's SMOKE config,
on the CPU: sd3, flux, cogvideox and hunyuanvideo (whose encoder is causal,
4 query heads over 2 KV heads).

Weights come from the JAX package's seeded init through
``repro_torch.convert.from_jax``; inputs and noise are made with numpy. Both
sides run in float32; each tolerance is stated where it is used.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.models import diffusion as jdiff
from repro.models import pipeline as jpl
from repro_torch import convert
from repro_torch.models import diffusion as tdiff
from repro_torch.models import pipeline as tpl

# float32 on both sides; the sums run in another order (and XLA fuses), so
# agreement is to a few f32 ulps of the values' scale, compounded by depth
TOL = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=TC.PIPELINE_IDS)
def smoke(request):
    """SMOKE params of one pipeline with non-zero AdaLN modulation, as JAX
    and as the port's pipeline."""
    jcfg, tcfg = JC.get_smoke(request.param), TC.get_smoke(request.param)
    params = jpl.init(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    dit = dict(params["diffuse"])
    layers = dict(dit["layers"])
    # AdaLN-Zero makes every block the identity; give the modulation values so
    # that attention and the MLP show in the output
    layers["mod"] = jnp.asarray(rng.standard_normal(layers["mod"].shape).astype(np.float32)
                                * 0.05)
    dit["layers"] = layers
    dit["final_mod"] = jnp.asarray(
        rng.standard_normal(dit["final_mod"].shape).astype(np.float32) * 0.05)
    params = dict(params, diffuse=dit)
    pipe = convert.from_jax(tcfg, _np_tree(params), "cpu")
    return jcfg, tcfg, params, pipe


@pytest.mark.parametrize("pipeline", TC.PIPELINE_IDS)
def test_configs_carry_the_same_values(pipeline):
    for getter in ("get", "get_smoke"):
        j, t = getattr(JC, getter)(pipeline), getattr(TC, getter)(pipeline)
        for part in ("encoder", "dit", "decoder"):
            jd = dataclasses.asdict(getattr(j, part))
            td = dataclasses.asdict(getattr(t, part))
            default = {f.name: f.default for f in dataclasses.fields(getattr(t, part))}
            for k, v in td.items():
                if k == "dtype":
                    assert str(v).split(".")[-1] == jnp.dtype(jd[k]).name
                elif k not in jd:
                    # a port-only field (HunyuanVideo's released DiT): the
                    # reference's pipelines keep its default
                    assert v == default[k], (getter, part, k)
                else:
                    assert v == jd[k], (getter, part, k)
        assert (j.num_steps, j.max_cond_len, j.is_video, j.name, j.source) == \
               (t.num_steps, t.max_cond_len, t.is_video, t.name, t.source)


def test_encoder_matches_jax(smoke):
    jcfg, _, params, pipe = smoke
    toks = np.random.default_rng(1).integers(0, jcfg.encoder.vocab_size, (2, 77))
    want = jpl.encode(jcfg, params, jnp.asarray(toks, jnp.int32))
    got = tpl.encode(pipe, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_dit_forward_matches_jax(smoke):
    jcfg, tcfg, params, pipe = smoke
    rng = np.random.default_rng(2)
    lat = rng.standard_normal((2, 16, tcfg.dit.latent_dim)).astype(np.float32)
    cond = rng.standard_normal((2, 9, tcfg.dit.cond_dim)).astype(np.float32)
    t = np.array([999.0, 321.0], np.float32)
    want = jdiff.forward(jcfg.dit, params["diffuse"], jnp.asarray(lat), jnp.asarray(t),
                         jnp.asarray(cond))
    got = pipe.dit(torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(cond))
    assert got.dtype == torch.float32 and got.shape == (2, 16, tcfg.dit.latent_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    # the modulation is live: the blocks are not the identity
    assert float(np.abs(np.asarray(want)).max()) > 0


def test_timestep_embedding_matches_jax():
    t = np.array([0.0, 1.0, 665.0, 999.0], np.float32)
    want = jdiff.timestep_embedding(jnp.asarray(t), 256)
    got = tdiff.timestep_embedding(torch.from_numpy(t), 256)
    # sin/cos of arguments up to ~1e3 rad, where one f32 ulp of the argument
    # is 6e-5: the two libraries' range reductions differ by about that
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("n", range(1, 51))
def test_ddim_timesteps_truncate_as_jax(n):
    # exact: JAX's float32 linspace gives 665.99994 -> 665 at n=4, where
    # torch.linspace and numpy give 666
    want = np.asarray(jnp.linspace(999, 0, n).astype(jnp.int32)).tolist()
    assert tdiff.ddim_timesteps(n) == want


def test_ddim_schedule_matches_jax():
    betas = jnp.linspace(1e-4, 0.02, 1000, dtype=jnp.float32)
    alpha_bar = jnp.cumprod(1.0 - betas)
    got = tdiff.jax_linspace(1e-4, 0.02, 1000)
    # the compiled reference fuses the betas' multiply-adds: one f32 ulp apart
    np.testing.assert_allclose(got.numpy(), np.asarray(betas), rtol=2.4e-7, atol=0)
    np.testing.assert_allclose(torch.cumprod(1.0 - got, 0).numpy(), np.asarray(alpha_bar),
                               rtol=1e-5, atol=0)


def test_ddim_denoise_matches_jax(smoke):
    jcfg, tcfg, params, pipe = smoke
    rng = np.random.default_rng(3)
    noise = rng.standard_normal((1, 16, tcfg.dit.latent_dim)).astype(np.float32)
    cond = rng.standard_normal((1, 9, tcfg.dit.cond_dim)).astype(np.float32)
    want = jdiff.ddim_denoise(jcfg.dit, params["diffuse"], jnp.asarray(noise),
                              jnp.asarray(cond), 3)
    got = tdiff.ddim_denoise(pipe.dit, torch.from_numpy(noise), torch.from_numpy(cond), 3)
    # three network evaluations, each divided by sqrt(alpha_bar) ~ 0.006 at t=999
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=1e-3)


def test_decoder_matches_jax(smoke):
    jcfg, _, params, pipe = smoke
    z = np.random.default_rng(4).standard_normal((2, 8, 8, 4)).astype(np.float32)
    want = jdiff.decode_latent(jcfg.decoder, params["decode"], jnp.asarray(z))
    got = pipe.decoder(torch.from_numpy(z))
    assert got.shape == (2, 64, 64, 3)
    # a tanh of large pre-activations: compare the pixels at f32 tolerance
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_converter_rejects_a_wrong_shape(smoke):
    _, tcfg, params, _ = smoke
    bad = _np_tree(params)
    bad["diffuse"] = dict(bad["diffuse"], x_in=np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError, match="x_in"):
        convert.from_jax(tcfg, bad, "cpu")
