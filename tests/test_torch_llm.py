"""The port's LLM decoder and ServeEngine against the JAX package, on the CPU.

The smoke ``rwkv6-3b``, ``zamba2-1.2b`` (and a zamba2 cut whose scan plan
has a remainder run after its cycles), ``yi-9b``, ``yi-34b``,
``starcoder2-15b``, ``gemma2-9b`` and ``deepseek-moe-16b`` are built from the
reference's ``transformer.init`` through ``convert.from_jax_lm``. Both sides
run in float32; prompts come from numpy seeds. The smoke window is 16: the
21-token prompts pass it, so the local mask binds in prefill and the local
rings wrap in decode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.models import transformer as jtf
from repro.serving import engine as jeng
from repro_torch import convert
from repro_torch.launch import serve_llm
from repro_torch.models import transformer as ttf
from repro_torch.serving import engine as teng

# float32 on both sides; the reference's CPU path runs the chunked scan
# (chunk 32) where the port runs the sequential one, and sums run in another
# order: agreement to ~1e-5 of the values' scale, compounded over the layers
TOL = 1e-4

REMAINDER = "zamba2-remainder"


def _configs(name):
    """(JAX config, port config) of a smoke model; REMAINDER is the smoke
    zamba2 with a cycle of (mamba2, mamba2, attn) over 8 layers, whose scan
    plan is that cycle twice, then a run of 2 Mamba2 layers."""
    if name != REMAINDER:
        return JC.get_smoke(name), TC.get_smoke(name)
    pattern = ("mamba2:none", "mamba2:none", "attn:dense")
    return tuple(dataclasses.replace(getter("zamba2-1.2b"), layer_pattern=pattern, num_layers=8)
                 for getter in (JC.get_smoke, TC.get_smoke))


@pytest.fixture(scope="module", params=["rwkv6-3b", "zamba2-1.2b", REMAINDER, "yi-9b", "yi-34b",
                                        "starcoder2-15b", "gemma2-9b", "deepseek-moe-16b"])
def model(request):
    jcfg, tcfg = _configs(request.param)
    params = jtf.init(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), params)
    return jcfg, tcfg, params, convert.from_jax_lm(tcfg, np_params, "cpu")


def _flat_caches(jcfg, caches):
    """The reference's caches[bi][pi] stacks as one dict per layer, in
    execution order."""
    out = []
    for blk, (cycle, repeat) in zip(caches, jcfg.scan_plan()):
        for r in range(repeat):
            out += [{k: np.asarray(a[r]) for k, a in blk[pi].items()} for pi in range(len(cycle))]
    return out


def _assert_caches_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            if k == "pos":
                np.testing.assert_array_equal(g[k].numpy(), w[k])
            else:
                np.testing.assert_allclose(g[k].numpy(), w[k], atol=TOL, rtol=TOL)


def test_lm_configs_carry_the_same_values():
    assert set(TC.ARCH_IDS) == set(JC.ARCH_IDS)
    for arch in TC.ARCH_IDS:
        for getter in ("get", "get_smoke"):
            j, t = getattr(JC, getter)(arch), getattr(TC, getter)(arch)
            jd = dataclasses.asdict(j)
            default = {f.name: f.default for f in dataclasses.fields(t)}
            for k, v in dataclasses.asdict(t).items():
                if k == "dtype":
                    assert str(v).split(".")[-1] == jnp.dtype(jd[k]).name
                elif k not in jd:
                    # a port-only field (an encoder with no final norm): the
                    # reference's architectures keep its default
                    assert v == default[k], (arch, getter, k)
                else:
                    assert v == jd[k], (arch, getter, k)
            assert t.scan_plan() == j.scan_plan()


def test_from_jax_lm_puts_layers_in_scan_plan_order():
    jcfg, tcfg = _configs(REMAINDER)
    params = jax.tree_util.tree_map(np.asarray, jtf.init(jcfg, jax.random.PRNGKey(1)))
    m = convert.from_jax_lm(tcfg, params, "cpu")
    kinds = ["mamba2", "mamba2", "attn"] * 2 + ["mamba2"] * 2
    assert [type(layer).__name__ for layer in m.layers] == \
        ["Mamba2Layer" if k == "mamba2" else "AttentionLayer" for k in kinds]
    # (block, repeat, cycle position) of each layer, in execution order
    where = [(0, r, p) for r in range(2) for p in range(3)] + [(1, 0, 0), (1, 1, 0)]
    for layer, (bi, r, pi) in zip(m.layers, where):
        name = "mamba.in_proj" if isinstance(layer, ttf.Mamba2Layer) else "wq"
        stack = params["blocks"][bi][pi]
        want = stack["mamba"]["in_proj"][r] if name == "mamba.in_proj" else stack["wq"][r]
        np.testing.assert_array_equal(dict(layer.named_parameters())[name].numpy(), want)


def test_prefill_and_decode_match_jax(model):
    jcfg, tcfg, params, m = model
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jcfg.vocab_size, (2, 21))
    max_len = 32
    want_logits, want_c, want_off = jtf.prefill(jcfg, params, jnp.asarray(toks, jnp.int32),
                                                max_len)
    got_logits, got_c, got_off = m.prefill(torch.from_numpy(toks), max_len)
    assert got_off == int(want_off) == 21
    assert got_logits.dtype == torch.float32 and got_logits.shape == (2, 1, jcfg.vocab_size)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), atol=TOL, rtol=TOL)
    _assert_caches_close(got_c, _flat_caches(jcfg, want_c))
    for step in range(4):
        nxt = rng.integers(0, jcfg.vocab_size, (2, 1))
        want_logits, want_c = jtf.decode_step(jcfg, params, jnp.asarray(nxt, jnp.int32), want_c,
                                              jnp.int32(21 + step))
        got_logits, got_c = m.decode_step(torch.from_numpy(nxt), got_c, 21 + step)
        np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), atol=TOL,
                                   rtol=TOL)
    _assert_caches_close(got_c, _flat_caches(jcfg, want_c))


def test_prefill_fills_a_ring_cache_shorter_than_the_prompt(model):
    jcfg, tcfg, params, m = model
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (1, 12))
    _, want_c, _ = jtf.prefill(jcfg, params, jnp.asarray(toks, jnp.int32), 8)
    _, got_c, _ = m.prefill(torch.from_numpy(toks), 8)
    _assert_caches_close(got_c, _flat_caches(jcfg, want_c))


def test_serve_engine_tokens_equal_jax(model):
    jcfg, tcfg, params, m = model
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, jcfg.vocab_size, size=int(n)) for n in rng.integers(4, 16, 6)]
    jax_eng = jeng.ServeEngine(jcfg, params, max_batch=4, max_len=64)
    port_eng = teng.ServeEngine(m, max_batch=4, max_len=64)
    for i, p in enumerate(prompts):
        jax_eng.submit(jeng.GenRequest(rid=i, prompt=p.astype(np.int32), max_new=5))
        port_eng.submit(teng.GenRequest(rid=i, prompt=p, max_new=5))
    want, got = [], []
    while jax_eng.queue:
        want += jax_eng.step()
    while port_eng.queue:
        got += port_eng.step()
    assert [r.rid for r in got] == [r.rid for r in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.output, w.output)
        assert g.group_size == (4 if g.rid < 4 else 2) and g.prefill_ms > 0


def test_serve_llm_records_one_row_per_request():
    cfg = TC.get_smoke("rwkv6-3b")
    reqs = serve_llm.requests_from_seed(cfg.vocab_size, 5, (4, 9), 3, seed=5)
    recs = serve_llm.serve(cfg, reqs, device="cpu")
    assert serve_llm.MAX_BATCH == 4
    assert [r["rid"] for r in recs] == [0, 1, 2, 3, 4]
    assert [r["group_size"] for r in recs] == [4, 4, 4, 4, 1]
    for r, req in zip(recs, reqs):
        assert r["prompt_len"] == req.prompt.shape[0] and len(r["tokens"]) == 3
        assert ((0 <= r["tokens"]) & (r["tokens"] < cfg.vocab_size)).all()
        assert r["prefill_ms"] > 0 and r["decode_ms_per_token"] > 0


def test_transformer_refuses_what_is_not_ported():
    """Every kind of the zoo is ported; an unknown mixer raises, as the
    reference's init does, and so does an unknown modality."""
    bad = dataclasses.replace(TC.get_smoke("rwkv6-3b"), layer_pattern=("attn_sparse:dense",))
    with pytest.raises(ValueError, match="attn_sparse"):
        jtf.init(dataclasses.replace(JC.get_smoke("rwkv6-3b"), layer_pattern=bad.layer_pattern),
                 jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="attn_sparse"):
        ttf.Transformer(bad, "cpu")
    with pytest.raises(ValueError, match="video"):
        ttf.Transformer(dataclasses.replace(TC.get_smoke("rwkv6-3b"), modality="video"), "cpu")
    for arch in TC.ARCH_IDS:
        ttf.Transformer(TC.get_smoke(arch), "meta")
