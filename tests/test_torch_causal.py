"""Causal attention layers whose mask a test can see, against the JAX package.

With random weights the attention of a layer is nearly uniform and small
beside its residual, so a parity test cannot tell a causal layer from one
that attends to every key. Here wq and wk are scaled up so that each query
attends sharply, and each case carries its negative control: the same layer
with the causal mask turned off (run through the port's plain path, as on
the CPU) must miss the tolerance that the real layer meets. The cases are
zamba2's smoke attention layer, hunyuanvideo's smoke encoder (causal, 4
query heads over 2 KV heads) and one layer with hunyuanvideo's full
grouping, 32 query heads over 8 KV heads, at a narrow width. The grouped
cases also reject KV heads grouped the wrong way round.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.models import transformer as ttf

# float32 on both sides, as in test_torch_models.py; the scores are ~QK_GAIN^2
# times larger than at init, so their rounding is too, still far below this
TOL = 1e-4
# scale of wq and of wk: query-key scores of std ~QK_GAIN^2, so each query
# puts most of its weight on a few keys
QK_GAIN = 3.0
CASES = ("zamba2-1.2b", "hunyuanvideo-encoder", "gqa-32-over-8")


def _config(getter, case):
    if case == "zamba2-1.2b":           # its attention layer alone
        return dataclasses.replace(getter("zamba2-1.2b"), layer_pattern=("attn:dense",),
                                   num_layers=1)
    enc = getter("hunyuanvideo").encoder
    if case == "hunyuanvideo-encoder":
        return enc
    return dataclasses.replace(enc, num_layers=1, num_heads=32, num_kv_heads=8, head_dim=16)


@functools.lru_cache(maxsize=None)
def _layers(case):
    """(JAX config, JAX params, port model, inputs) with wq, wk scaled."""
    jcfg = _config(JC.get_smoke, case)
    tcfg = _config(TC.get_smoke, case)
    assert jcfg.layer_pattern == tcfg.layer_pattern == ("attn:dense",)
    params = jtf.init(jcfg, jax.random.PRNGKey(4))
    blocks = [[dict(stack, wq=stack["wq"] * QK_GAIN, wk=stack["wk"] * QK_GAIN)
               for stack in block] for block in params["blocks"]]
    params = dict(params, blocks=blocks)
    model = convert.from_jax_lm(tcfg, jax.tree_util.tree_map(np.asarray, params), "cpu")
    x = np.random.default_rng(5).standard_normal((2, 40, jcfg.d_model)).astype(np.float32)
    return jcfg, params, model, x


def _reference(jcfg, params, x):
    b, l, _ = x.shape
    positions = jnp.broadcast_to(jnp.arange(l, dtype=jnp.int32)[None], (b, l))
    out, _, _ = jtf._run_segments(jcfg, params, jnp.asarray(x), positions, None, "train", 0)
    return np.asarray(out)


def _missed(got, want) -> float:
    """How far ``got`` misses the tolerance: max |err| / (TOL + TOL |want|)."""
    return float((np.abs(got - want) / (TOL + TOL * np.abs(want))).max())


@pytest.mark.parametrize("case", CASES)
def test_causal_layer_with_large_attention_matches_jax(case, monkeypatch):
    jcfg, params, model, x = _layers(case)
    want = _reference(jcfg, params, x)
    got = model.run_layers(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)

    # negative control: the mask turned off misses the same tolerance
    attend = ttf.ops.flash_attention
    monkeypatch.setattr(ttf.ops, "flash_attention",
                        lambda q, k, v, causal, **kw: attend(q, k, v, causal=False, **kw))
    unmasked = model.run_layers(torch.from_numpy(x)).numpy()
    print(f"mask off: {_missed(unmasked, want):.3g} x the tolerance")
    assert _missed(unmasked, want) > 10


@pytest.mark.parametrize("case", CASES[1:])
def test_grouped_layer_rejects_kv_heads_grouped_the_wrong_way(case, monkeypatch):
    """Query head h reads KV head h // n_rep; a layer that tiles the KV heads
    (h % n_kv) instead misses the tolerance."""
    jcfg, params, model, x = _layers(case)
    assert jcfg.num_heads > jcfg.num_kv_heads
    want = _reference(jcfg, params, x)
    monkeypatch.setattr(ttf.common, "repeat_kv", lambda t, n: t.repeat(1, 1, n, 1))
    tiled = model.run_layers(torch.from_numpy(x)).numpy()
    print(f"KV heads tiled: {_missed(tiled, want):.3g} x the tolerance")
    assert _missed(tiled, want) > 10
