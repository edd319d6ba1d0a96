"""The pieces the zoo's attention LLMs add, against the JAX package on the CPU.

K1's plain path at gemma2's head dim (256), with its window and softcap,
against the reference's Pallas kernel in interpret mode; the MoE FFN
against ``repro.models.moe.moe_ffn`` (with tokens dropped at a small
capacity, and at a decode-sized batch); the ServeEngine on the window and
MoE models with prompts past the smoke window; ``serve_llm --lengths``.
Float32 on both sides; inputs from numpy seeds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.serving import engine as jeng
from repro_torch import convert
from repro_torch.kernels import ops
from repro_torch.launch import serve_llm
from repro_torch.models import moe as tmoe
from repro_torch.serving import engine as teng

# float32 on both sides; sums in another order
TOL = 1e-5


@pytest.mark.parametrize("lq,lkv,window,softcap", [
    (100, 100, 0, 0.0), (200, 200, 0, 0.0),           # causal, one and two 128-key blocks
    (100, 100, 48, 50.0), (200, 200, 48, 50.0),       # gemma2's window (cut) with its softcap
    (100, 100, 0, 50.0), (200, 200, 0, 50.0),         # gemma2's global layers: softcap alone
    (100, 300, 0, 0.0), (100, 300, 48, 50.0),         # queries at the end of a longer kv
])
def test_flash_attention_plain_path_at_head_dim_256_matches_pallas(lq, lkv, window, softcap):
    rng = np.random.default_rng(lq + lkv + window)
    q, k, v = (rng.standard_normal((1, n, 2, 256)).astype(np.float32) for n in (lq, lkv, lkv))
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                               window=window, softcap=softcap, interpret=True)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              causal=True, window=window, softcap=softcap)
    assert got.shape == (1, lq, 2, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def _moe_pair(cfg_changes=None, seed=0):
    """The smoke deepseek-moe's MoE params from the reference's ``init_moe``,
    and the port's ``MoE`` holding the same values."""
    jcfg, tcfg = JC.get_smoke("deepseek-moe-16b"), TC.get_smoke("deepseek-moe-16b")
    if cfg_changes:
        jcfg, tcfg = (dataclasses.replace(c, **cfg_changes) for c in (jcfg, tcfg))
    params = jmoe.init_moe(jcfg, jax.random.PRNGKey(seed))
    layer = tmoe.MoE(tcfg, "cpu")
    with torch.no_grad():
        for name, p in layer.named_parameters():
            p.copy_(torch.from_numpy(np.array(params[name], np.float32)))
    return jcfg, tcfg, params, layer


@pytest.mark.parametrize("case,b,l,changes", [
    ("smoke size", 2, 21, None),
    ("two routing groups", 2, 1100, None),            # 2200 tokens: groups of 1100
    ("capacity drops tokens", 2, 21, {"capacity_factor": 0.25}),
    ("decode-sized", 4, 1, None),                     # t = 4 tokens, capacity 4
])
def test_moe_ffn_matches_jax(case, b, l, changes):
    jcfg, tcfg, params, layer = _moe_pair(changes)
    x = np.random.default_rng(b * l).standard_normal((b, l, tcfg.d_model)).astype(np.float32)
    want, want_aux = jmoe.moe_ffn(jcfg, params, jnp.asarray(x))
    got, got_aux = tmoe.moe_ffn(tcfg, layer, torch.from_numpy(x))
    # the reference's fan-in init over the expert axis (fan 4) makes outputs
    # of ~20 rms, where float32 sums in another order differ by ~1e-6 of that:
    # held at 1e-5 of the output's rms (a dropped or misrouted token moves
    # its row by ~its rms)
    want = np.asarray(want)
    rms = float(np.sqrt(np.mean(want ** 2)))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL * rms, rtol=TOL)
    np.testing.assert_allclose(got_aux.item(), float(want_aux), atol=TOL, rtol=TOL)
    t = b * l
    s = tmoe._group_size(t)
    _, _, _, _, keep = tmoe.route(tcfg, layer.router, torch.from_numpy(x).reshape(t // s, s, -1))
    assert keep.shape == (t // s, s, tcfg.experts_per_token)
    if changes:
        # capacity max(4, int(0.25 * 2 * 42 / 4) + 1) = 6 slots for 84 choices over 4 experts
        assert tmoe.capacity(tcfg, s) == 6 and not keep.all()
    elif case == "decode-sized":
        assert tmoe.capacity(tcfg, s) == 4 and keep.all()


@pytest.mark.parametrize("arch", ["starcoder2-15b", "gemma2-9b", "deepseek-moe-16b"])
def test_serve_engine_tokens_equal_jax_past_the_window(arch):
    """Prompts of 17..29 tokens, past the smoke window of 16, and 6 new
    tokens: the local mask binds in prefill and the rings wrap in decode."""
    jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    params = jtf.init(jcfg, jax.random.PRNGKey(3))
    np_params = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), params)
    model = convert.from_jax_lm(tcfg, np_params, "cpu")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, jcfg.vocab_size, size=int(n)) for n in rng.integers(17, 30, 5)]
    jax_eng = jeng.ServeEngine(jcfg, params, max_batch=4, max_len=40)
    port_eng = teng.ServeEngine(model, max_batch=4, max_len=40)
    for i, p in enumerate(prompts):
        jax_eng.submit(jeng.GenRequest(rid=i, prompt=p.astype(np.int32), max_new=6))
        port_eng.submit(teng.GenRequest(rid=i, prompt=p, max_new=6))
    want, got = [], []
    while jax_eng.queue:
        want += jax_eng.step()
    while port_eng.queue:
        got += port_eng.step()
    assert [r.rid for r in got] == [r.rid for r in want] == list(range(5))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.output, w.output)


def test_gemma2_carries_its_tied_embedding_and_softcaps():
    jcfg, tcfg = JC.get_smoke("gemma2-9b"), TC.get_smoke("gemma2-9b")
    assert tcfg.tie_embeddings and tcfg.embed_scale
    assert (tcfg.attn_softcap, tcfg.logit_softcap) == (50.0, 30.0)
    params = jax.tree_util.tree_map(np.asarray, jtf.init(jcfg, jax.random.PRNGKey(4)))
    assert "lm_head" not in params
    model = convert.from_jax_lm(tcfg, params, "cpu")
    assert not hasattr(model, "lm_head")
    np.testing.assert_array_equal(model.embed.numpy(), params["embed"])
    logits, _, _ = model.prefill(torch.zeros((1, 3), dtype=torch.long), 8)
    assert logits.abs().max().item() <= 30.0


def test_from_jax_lm_carries_the_moe_layers_stacked_experts():
    jcfg, tcfg = JC.get_smoke("deepseek-moe-16b"), TC.get_smoke("deepseek-moe-16b")
    params = jax.tree_util.tree_map(np.asarray, jtf.init(jcfg, jax.random.PRNGKey(5)))
    model = convert.from_jax_lm(tcfg, params, "cpu")
    dense, moe_layer = model.layers
    assert dense.ffn == "dense" and moe_layer.ffn == "moe"
    stack = params["blocks"][1][0]["moe"]         # the run of MoE layers, repeat 0
    assert moe_layer.moe.router.dtype == torch.float32
    for name in ("router", "w_gate", "w_up", "w_down", "shared_gate", "shared_up",
                 "shared_down"):
        np.testing.assert_array_equal(getattr(moe_layer.moe, name).numpy(), stack[name][0])
    assert moe_layer.moe.w_gate.shape == (tcfg.num_experts, tcfg.d_model, tcfg.moe_d_ff)


@pytest.mark.parametrize("arch", ["yi-9b", "yi-34b", "starcoder2-15b", "gemma2-9b",
                                  "deepseek-moe-16b"])
def test_serve_llm_cli_serves_each_new_arch_past_the_window(arch, capsys):
    serve_llm.main(["--device", "cpu", "--smoke", "--arch", arch, "--requests", "2",
                    "--max-new", "3", "--lengths", "17,24"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"arch={arch}-smoke: served 2 requests, 6 tokens")
    lens = [int(line.split("prompt_len=")[1].split()[0]) for line in out[1:]]
    assert len(lens) == 2 and all(17 <= n <= 24 for n in lens)
