"""The last three LLMs of the zoo, against the JAX package on the CPU.

llama4-maverick (chunked-local attention, qk-norm, a top-1 MoE with a shared
expert), internvl2-2b (a projected vision prefix) and musicgen-medium
(codebook embeddings summed per frame, one head per codebook, the delay
pattern), each as its smoke config built from the reference's
``transformer.init`` through ``convert.from_jax_lm``; the blocked attention
the CPU prefill takes at long L; the per-chunk K1 split; the engine and the
musicgen launcher; the sliced weight draw; llama4 built whole on ``meta``.
Float32 on both sides; inputs from numpy seeds. The smoke chunk is 16: the
17- and 40-token prompts pass it, so the chunk binds in prefill and the
chunked rings wrap in decode.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.models import audio as jaudio
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.models import vlm as jvlm
from repro.serving import engine as jeng
from repro_torch import convert
from repro_torch.kernels import ops
from repro_torch.launch import serve_llm, serve_musicgen, serve_vlm
from repro_torch.models import audio as taudio
from repro_torch.models import common as tcommon
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.models import vlm as tvlm
from repro_torch.serving import engine as teng

# float32 on both sides; sums in another order (as tests/test_torch_llm_zoo.py)
TOL = 1e-5
LLAMA4, VLM, AUDIO = "llama4-maverick-400b-a17b", "internvl2-2b", "musicgen-medium"


@functools.lru_cache(maxsize=None)
def _model(arch, seed=0):
    """(JAX config, JAX params, port model) of a smoke config."""
    jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    params = jtf.init(jcfg, jax.random.PRNGKey(seed))
    np_params = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), params)
    return jcfg, params, convert.from_jax_lm(tcfg, np_params, "cpu")


def _inputs(cfg, b, l, seed):
    """Tokens (B, L) [(B, K, L) for musicgen] and, for internvl2, a prefix."""
    rng = np.random.default_rng(seed)
    shape = (b, cfg.num_codebooks, l) if cfg.modality == "audio_codec" else (b, l)
    toks = rng.integers(0, cfg.vocab_size, shape)
    prefix = None
    if cfg.modality == "vision":
        prefix = rng.standard_normal((b, cfg.vision_tokens, cfg.vision_embed_dim))
        prefix = prefix.astype(np.float32)
    return toks, prefix


def _j(a, dtype=jnp.int32):
    return None if a is None else jnp.asarray(a, dtype)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _close(got, want, tol=TOL):
    """Held at tol of the values' rms and tol relative: the reference's
    fan-in init over the expert and codebook axes (fan 4) makes some
    outputs large, where float32 sums in another order differ by ~1e-6 of
    them."""
    want = np.asarray(want)
    rms = float(np.sqrt(np.mean(want ** 2)))
    np.testing.assert_allclose(np.asarray(got), want, atol=tol * max(1.0, rms), rtol=tol)


def _flat_caches(jcfg, caches):
    out = []
    for blk, (cycle, repeat) in zip(caches, jcfg.scan_plan()):
        for r in range(repeat):
            out += [{k: np.asarray(a[r]) for k, a in blk[pi].items()} for pi in range(len(cycle))]
    return out


def _caches_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            if k == "pos":
                np.testing.assert_array_equal(g[k].numpy(), w[k])
            else:
                _close(g[k].numpy(), w[k])


CASES = [(LLAMA4, 17), (LLAMA4, 40), (VLM, 12), (AUDIO, 21)]


@pytest.mark.parametrize("arch,length", CASES)
def test_forward_logits_match_jax(arch, length):
    jcfg, params, m = _model(arch)
    toks, prefix = _inputs(jcfg, 2, length, seed=length)
    want, want_aux = jtf.forward(jcfg, params, _j(toks), _j(prefix, jnp.float32))
    got, got_aux = m.forward(_t(toks), _t(prefix))
    tv = jcfg.vision_tokens if prefix is not None else 0
    shape = (2, tv + length) + ((jcfg.num_codebooks,) if arch == AUDIO else ()) + (
        jcfg.vocab_size,)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    _close(got.numpy(), want)
    np.testing.assert_allclose(got_aux.item(), float(want_aux), atol=TOL, rtol=TOL)
    assert (got_aux.item() > 0) == (arch == LLAMA4)


@pytest.mark.parametrize("arch,length", CASES)
def test_prefill_caches_and_decode_match_jax(arch, length):
    jcfg, params, m = _model(arch)
    toks, prefix = _inputs(jcfg, 2, length, seed=100 + length)
    tv = jcfg.vision_tokens if prefix is not None else 0
    max_len = tv + length + 8
    want, want_c, want_off = jtf.prefill(jcfg, params, _j(toks), max_len,
                                         _j(prefix, jnp.float32))
    got, got_c, got_off = m.prefill(_t(toks), max_len, _t(prefix))
    assert got_off == int(want_off) == tv + length
    _close(got.numpy(), want)
    _caches_close(got_c, _flat_caches(jcfg, want_c))
    rng = np.random.default_rng(length)
    for step in range(4):
        nxt, _ = _inputs(jcfg, 2, 1, seed=int(rng.integers(1 << 30)))
        want, want_c = jtf.decode_step(jcfg, params, _j(nxt), want_c, jnp.int32(got_off + step))
        got, got_c = m.decode_step(_t(nxt), got_c, got_off + step)
        _close(got.numpy(), want)
    _caches_close(got_c, _flat_caches(jcfg, want_c))


def test_llama4_smoke_carries_its_kinds_and_qk_norm():
    jcfg, params, m = _model(LLAMA4)
    assert m.cfg.chunk_size == 16 and m.cfg.qk_norm and m.cfg.experts_per_token == 1
    assert [(layer.mixer, layer.ffn) for layer in m.layers] == [
        ("attn_chunked", "moe"), ("attn_chunked", "dense"), ("attn_chunked", "moe"),
        ("attn", "dense")]
    for layer, (bi, pi) in zip(m.layers, [(0, 0), (1, 0), (2, 0), (3, 0)]):
        for name in ("q_norm", "k_norm"):
            np.testing.assert_array_equal(getattr(layer, name).numpy(),
                                          params["blocks"][bi][pi][name][0])


def _qk_gain_layer(gain=3.0):
    """llama4's smoke chunked layer alone, wq and wk scaled so that each
    query attends sharply (tests/test_torch_causal.py), q/k norms nonzero."""
    pattern = {"layer_pattern": ("attn_chunked:dense",), "num_layers": 1}
    jcfg = dataclasses.replace(JC.get_smoke(LLAMA4), **pattern)
    tcfg = dataclasses.replace(TC.get_smoke(LLAMA4), **pattern)
    params = jtf.init(jcfg, jax.random.PRNGKey(8))
    rng = np.random.default_rng(8)
    blocks = [[dict(stack, wq=stack["wq"] * gain, wk=stack["wk"] * gain,
                    q_norm=jnp.asarray(rng.normal(0, 0.3, stack["q_norm"].shape), jnp.float32),
                    k_norm=jnp.asarray(rng.normal(0, 0.3, stack["k_norm"].shape), jnp.float32))
               for stack in block] for block in params["blocks"]]
    params = dict(params, blocks=blocks)
    return jcfg, params, convert.from_jax_lm(tcfg, jax.tree_util.tree_map(np.asarray, params),
                                             "cpu")


def _missed(got, want):
    return float((np.abs(got - want) / (TOL + TOL * np.abs(want))).max())


def test_chunked_layer_with_sharp_attention_matches_jax_and_a_causal_one_does_not():
    """The chunk must bind where it can be seen: in prefill (40 tokens over
    chunks of 16) and in decode (positions 40..43, whose chunk starts at 32:
    the ring of 16 holds 24..39 after the prompt). The same weights with
    the chunk mask off (a plain causal layer) miss the tolerance in both."""
    jcfg, params, m = _qk_gain_layer()
    toks = np.random.default_rng(9).integers(0, jcfg.vocab_size, (2, 40))
    steps = np.random.default_rng(10).integers(0, jcfg.vocab_size, (4, 2, 1))

    def run(model):
        logits, caches, off = model.prefill(torch.from_numpy(toks), 48)
        out = [logits.numpy()]
        for i, tok in enumerate(steps):
            logits, caches = model.decode_step(torch.from_numpy(tok), caches, off + i)
            out.append(logits.numpy())
        return out

    want_l, want_c, off = jtf.prefill(jcfg, params, _j(toks), 48)
    want = [np.asarray(want_l)]
    for i, tok in enumerate(steps):
        want_l, want_c = jtf.decode_step(jcfg, params, _j(tok), want_c, jnp.int32(40 + i))
        want.append(np.asarray(want_l))
    got = run(m)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL)
    m.layers[0].mixer = "attn"           # the negative control: causal, no chunk
    try:
        wrong = run(m)
    finally:
        m.layers[0].mixer = "attn_chunked"
    assert _missed(wrong[0], want[0]) > 10 and _missed(wrong[-1], want[-1]) > 10


@pytest.mark.parametrize("length", [15, 16, 17, 31, 32, 33, 40, 48])
def test_per_chunk_k1_split_equals_the_chunked_mask(length, monkeypatch):
    """The chunked layer's prefill attention: one causal ``ops.flash_attention``
    call per chunk (one for a prompt no longer than the chunk) equals the
    reference's attention under ``make_attention_mask(..., ATTN_CHUNKED)``."""
    cfg = TC.get_smoke(LLAMA4)
    layer = ttf.AttentionLayer(cfg, "attn_chunked", "cpu")
    rng = np.random.default_rng(length)
    q, k, v = (rng.standard_normal((2, length, 4, 32)).astype(np.float32) for _ in range(3))
    pos = np.arange(length, dtype=np.int32)
    mask = jcommon.make_attention_mask(jnp.asarray(pos), jnp.asarray(pos), "attn_chunked",
                                       chunk=cfg.chunk_size)
    want = jcommon.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask)
    calls = []
    real = ops.flash_attention

    def counted(*args, **kw):
        calls.append((args[0].shape[1], kw))
        return real(*args, **kw)
    monkeypatch.setattr(ops, "flash_attention", counted)
    got = layer._attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    c = cfg.chunk_size
    assert [n for n, _ in calls] == [min(c, length - j) for j in range(0, length, c)]
    assert all(kw["causal"] and not kw.get("window") and kw["softcap"] == 0.0
               for _, kw in calls)


@pytest.mark.parametrize("kind,window,chunk,cap", [
    ("attn", 0, 0, 0.0), ("attn", 0, 0, 30.0), ("attn_local", 20, 0, 0.0),
    ("attn_local", 20, 0, 50.0), ("attn_chunked", 0, 32, 0.0), ("attn_chunked", 0, 24, 0.0),
    ("attn_bidir", 0, 0, 0.0), ("attn_bidir", 0, 0, 30.0),
])
def test_attention_blocked_matches_jax(kind, window, chunk, cap):
    rng = np.random.default_rng(window + chunk + int(cap))
    q, k, v = (rng.standard_normal((2, 64, 3, 16)).astype(np.float32) for _ in range(3))
    pos = np.arange(64, dtype=np.int32)
    want = jcommon.attention_blocked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(pos), jnp.asarray(pos), kind, window, chunk,
                                     cap, block=16)
    got = tcommon.attention_blocked(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), torch.from_numpy(pos),
                                    torch.from_numpy(pos), kind, window, chunk, cap, block=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    # and the masked attention it stands for
    mask = (None if kind == "attn_bidir" else
            jcommon.make_attention_mask(jnp.asarray(pos), jnp.asarray(pos), kind, window, chunk))
    plain = jcommon.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask, cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(plain), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch", [LLAMA4, "gemma2-9b"])
def test_cpu_prefill_takes_blocked_attention_where_the_reference_does(arch, monkeypatch):
    """With the blocked-attention threshold cut to 32 (blocks of 16), a
    48-token prefill runs ``attention_blocked`` in both packages, and a
    40-token one (no multiple of the block) does not; the logits and caches
    agree either way."""
    small = {"attn_block_threshold": 32, "attn_block_size": 16}
    jcfg = dataclasses.replace(JC.get_smoke(arch), **small)
    tcfg = dataclasses.replace(TC.get_smoke(arch), **small)
    params = jtf.init(jcfg, jax.random.PRNGKey(2))
    m = convert.from_jax_lm(tcfg, jax.tree_util.tree_map(np.asarray, params), "cpu")
    blocked = []
    real = tcommon.attention_blocked
    monkeypatch.setattr(tcommon, "attention_blocked",
                        lambda *a, **kw: blocked.append(a[0].shape[1]) or real(*a, **kw))
    for length in (48, 40):
        toks = np.random.default_rng(length).integers(0, jcfg.vocab_size, (1, length))
        want, want_c, _ = jtf.prefill(jcfg, params, _j(toks), 56)
        got, got_c, _ = m.prefill(torch.from_numpy(toks), 56)
        _close(got.numpy(), want)
        _caches_close(got_c, _flat_caches(jcfg, want_c))
    assert blocked == [48] * tcfg.num_layers


def test_delay_pattern_matches_jax():
    toks = np.random.default_rng(3).integers(1, 2048, (2, 4, 9))
    want = jaudio.apply_delay_pattern(jnp.asarray(toks, jnp.int32))
    got = taudio.apply_delay_pattern(torch.from_numpy(toks))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(taudio.undo_delay_pattern(got).numpy(),
                                  np.asarray(jaudio.undo_delay_pattern(want)))
    # codebook k waits k frames; undoing it gives the frames back, zeros at the end
    assert (got[:, 3, :3] == 0).all() and (got[:, 0] == torch.from_numpy(toks)[:, 0]).all()
    undone = taudio.undo_delay_pattern(got).numpy()
    for i in range(4):
        np.testing.assert_array_equal(undone[:, i, :9 - i], toks[:, i, :9 - i])
        assert (undone[:, i, 9 - i:] == 0).all()


def test_stub_front_ends_have_the_reference_shapes():
    cfg = TC.get_smoke(VLM)
    jcfg = JC.get_smoke(VLM)
    zeros = tvlm.vision_stub_embeds(cfg, 2, device="cpu")
    assert zeros.shape == jvlm.vision_stub_embeds(jcfg, 2).shape == (2, 8, 64)
    assert not zeros.any()
    drawn = tvlm.vision_stub_embeds(cfg, 2, torch.Generator().manual_seed(0))
    assert drawn.dtype == torch.float32 and 0.01 < drawn.std().item() < 0.03
    acfg = TC.get_smoke(AUDIO)
    toks = taudio.codec_stub_tokens(acfg, 3, 5, torch.Generator().manual_seed(0))
    assert toks.shape == jaudio.codec_stub_tokens(JC.get_smoke(AUDIO), 3, 5).shape == (3, 4, 5)
    assert 0 <= toks.min() and toks.max() < acfg.vocab_size
    assert not taudio.codec_stub_tokens(acfg, 1, 2, device="cpu").any()


def _serve_both(arch, prompts, max_new, max_len, seed=3):
    jcfg, params, m = _model(arch, seed)
    jax_eng = jeng.ServeEngine(jcfg, params, max_batch=4, max_len=max_len)
    port_eng = teng.ServeEngine(m, max_batch=4, max_len=max_len)
    for i, p in enumerate(prompts):
        jax_eng.submit(jeng.GenRequest(rid=i, prompt=p.astype(np.int32), max_new=max_new))
        port_eng.submit(teng.GenRequest(rid=i, prompt=p, max_new=max_new))
    want, got = [], []
    while jax_eng.queue:
        want += jax_eng.step()
    while port_eng.queue:
        got += port_eng.step()
    assert [r.rid for r in got] == [r.rid for r in want] == list(range(len(prompts)))
    return got, want


def test_serve_engine_tokens_equal_jax_for_llama4_past_the_chunk():
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 512, size=int(n)) for n in rng.integers(17, 30, 5)]
    got, want = _serve_both(LLAMA4, prompts, 6, 40)
    for g, w in zip(got, want):
        assert g.output.shape == (6,)
        np.testing.assert_array_equal(g.output, w.output)


def test_serve_engine_tokens_equal_jax_for_musicgen_prompts_of_unequal_lengths():
    """(K, L) prompts of 5..12 frames in one group: only the last axis is
    left-padded (padding every axis would give a group of (K + pad) rows)."""
    rng = np.random.default_rng(7)
    vocab = TC.get_smoke(AUDIO).vocab_size
    prompts = [rng.integers(0, vocab, size=(4, int(n))) for n in (5, 12, 9, 7, 11)]
    got, want = _serve_both(AUDIO, prompts, 5, 24)
    for g, w in zip(got, want):
        assert g.output.shape == (5, 4)
        np.testing.assert_array_equal(g.output, w.output)
    assert [g.group_size for g in got] == [4, 4, 4, 4, 1]


def test_serve_llm_serves_codebook_prompts_and_the_cli_refuses_them():
    cfg = TC.get_smoke(AUDIO)
    rng = np.random.default_rng(8)
    reqs = [teng.GenRequest(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=(4, n)),
                            max_new=3)
            for i, n in enumerate((6, 9))]
    model = ttf.build(cfg, "cpu", seed=1)
    serve_llm.warm(model, reqs)
    recs = serve_llm.serve(cfg, reqs, device="cpu", model=model)
    assert [r["prompt_len"] for r in recs] == [6, 9]
    assert all(r["tokens"].shape == (3, 4) for r in recs)
    for arch, launcher in ((AUDIO, "serve_musicgen"), (VLM, "serve_vlm")):
        with pytest.raises(SystemExit, match=launcher):
            serve_llm.main(["--device", "cpu", "--smoke", "--arch", arch])


def test_vision_requests_equal_a_reference_prefill_and_decode_loop():
    """The engine with a vision prefix (which the reference's engine does
    not take) gives, per group, the tokens of the reference's
    ``vlm_prefill`` and greedy ``decode_step`` on the same left-padded batch."""
    jcfg, params, m = _model(VLM)
    reqs = serve_vlm.requests_from_seed(m.cfg, 3, (5, 9), 4, seed=2)
    recs = serve_llm.serve(m.cfg, reqs, device="cpu", model=m)
    lmax = max(r.prompt.shape[0] for r in reqs)
    toks = np.stack([np.pad(r.prompt, (lmax - r.prompt.shape[0], 0)) for r in reqs])
    prefix = np.stack([r.prefix for r in reqs])
    max_len = jcfg.vision_tokens + lmax + 4
    logits, cache, off = jvlm.vlm_prefill(jcfg, params, _j(toks), jnp.asarray(prefix), max_len)
    out = []
    tok = jnp.argmax(logits[:, -1], axis=-1)
    for _ in range(4):
        out.append(np.asarray(tok))
        logits, cache = jtf.decode_step(jcfg, params, tok[:, None], cache, off)
        off = off + 1
        tok = jnp.argmax(logits[:, -1], axis=-1)
    want = np.stack(out, axis=1)
    for i, r in enumerate(recs):
        np.testing.assert_array_equal(r["tokens"], want[i])
    got_l, _ = tvlm.vlm_forward(m, torch.from_numpy(toks), torch.from_numpy(prefix))
    want_l, _ = jvlm.vlm_forward(jcfg, params, _j(toks), jnp.asarray(prefix))
    _close(got_l.numpy(), want_l)


def test_serve_vlm_cli_serves_behind_the_prefix(capsys):
    serve_vlm.main(["--device", "cpu", "--smoke", "--requests", "2", "--max-new", "3"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=internvl2-2b-smoke: served 2 requests behind 8 patch "
                             "embeddings, 6 tokens")
    assert len(out) == 3


def test_serve_musicgen_frames_equal_the_reference_examples_loop():
    """``generate`` against ``examples/serve_musicgen.py``'s loop (prefill of
    the delayed prefix, then greedy frames), on the same weights and prefix."""
    jcfg, params, m = _model(AUDIO, seed=0)
    prefix = jaudio.codec_stub_tokens(jcfg, 1, 4, jax.random.PRNGKey(1))
    delayed = jaudio.apply_delay_pattern(prefix)
    logits, cache, offset = jtf.prefill(jcfg, params, delayed, max_len=64)
    frames = []
    tok = jnp.argmax(logits[:, -1], axis=-1)
    for _ in range(6):
        frames.append(np.asarray(tok))
        logits, cache = jtf.decode_step(jcfg, params, tok[:, :, None], cache, offset)
        offset = offset + 1
        tok = jnp.argmax(logits[:, -1], axis=-1)
    want = np.stack(frames, axis=-1)
    gen, undone = serve_musicgen.generate(m, torch.tensor(np.asarray(prefix)).long(), 6)
    np.testing.assert_array_equal(gen, want)
    np.testing.assert_array_equal(undone, np.asarray(jaudio.undo_delay_pattern(
        jnp.asarray(want))))


def test_serve_musicgen_cli_prints_the_shape_and_undoes_the_delay(capsys):
    serve_musicgen.main(["--device", "cpu", "--smoke", "--frames", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "generated 4 frames across 4 codebooks: shape (1, 4, 4)"
    cfg = TC.get_smoke(AUDIO)
    model = ttf.build(cfg, "cpu", 0)
    prefix = taudio.codec_stub_tokens(cfg, 1, 4, torch.Generator().manual_seed(1))
    gen, undone = serve_musicgen.generate(model, prefix, 4)
    assert gen.shape == undone.shape == (1, 4, 4)
    for i in range(4):     # codebook i's frames move i places to the front
        np.testing.assert_array_equal(undone[0, i, :4 - i], gen[0, i, i:])
        assert (undone[0, i, 4 - i:] == 0).all()
    rows = [list(map(int, line.strip(" []").split())) for line in out[1:]]
    assert len(rows) == 4 and all(len(r) == 4 for r in rows)


@pytest.mark.parametrize("case,b,l,changes", [
    ("smoke size", 2, 21, None),
    ("capacity drops tokens", 2, 21, {"capacity_factor": 0.25}),
    ("decode-sized", 4, 1, None),
])
def test_top1_moe_with_a_shared_expert_matches_jax(case, b, l, changes):
    jcfg, tcfg = JC.get_smoke(LLAMA4), TC.get_smoke(LLAMA4)
    if changes:
        jcfg, tcfg = (dataclasses.replace(c, **changes) for c in (jcfg, tcfg))
    assert (tcfg.experts_per_token, tcfg.num_shared_experts, tcfg.num_experts) == (1, 1, 4)
    params = jmoe.init_moe(jcfg, jax.random.PRNGKey(b * l))
    layer = tmoe.MoE(tcfg, "cpu")
    with torch.no_grad():
        for name, p in layer.named_parameters():
            p.copy_(torch.from_numpy(np.array(params[name], np.float32)))
    x = np.random.default_rng(b * l).standard_normal((b, l, tcfg.d_model)).astype(np.float32)
    want, want_aux = jmoe.moe_ffn(jcfg, params, jnp.asarray(x))
    got, got_aux = tmoe.moe_ffn(tcfg, layer, torch.from_numpy(x))
    _close(got.numpy(), want)
    np.testing.assert_allclose(got_aux.item(), float(want_aux), atol=TOL, rtol=TOL)
    t = b * l
    s = tmoe._group_size(t)
    _, idx, gates, _, keep = tmoe.route(tcfg, layer.router,
                                        torch.from_numpy(x).reshape(t // s, s, -1))
    # top-1 after the renormalisation: the gate of a kept token is 1.0
    assert idx.shape[-1] == 1 and torch.equal(gates, keep.float())
    if changes:
        # capacity max(4, int(0.25 * 1 * 42 / 4) + 1) = 4 slots for 42 tokens over 4 experts
        assert tmoe.capacity(tcfg, s) == 4 and not keep.all()


def test_sliced_draw_has_the_whole_draws_distribution_and_fan_in(monkeypatch):
    """A tensor past DRAW_SLICE_ELEMENTS is drawn in slices along dim 0, at
    the std of the whole tensor's fan-in (its shape[0]); one under it takes
    the whole draw, bit for bit as before (one float32 draw times the std)."""
    gen = torch.Generator().manual_seed(0)
    w = torch.empty((8, 300, 200))
    tcommon.dense_init_(w, gen, scale=0.5)
    old = torch.empty(w.shape)
    torch.nn.init.trunc_normal_(old, 0.0, 1.0, -2.0, 2.0, generator=torch.Generator().manual_seed(0))
    assert torch.equal(w, old * (0.5 / math.sqrt(8)))
    monkeypatch.setattr(tcommon, "DRAW_SLICE_ELEMENTS", 3 * 300 * 200 + 7)
    sliced = torch.empty((8, 300, 200))
    drawn = []
    real = torch.nn.init.trunc_normal_
    monkeypatch.setattr(torch.nn.init, "trunc_normal_",
                        lambda t, *a, **kw: drawn.append(tuple(t.shape)) or real(t, *a, **kw))
    tcommon.dense_init_(sliced, torch.Generator().manual_seed(1), scale=0.5)
    assert drawn == [(3, 300, 200), (3, 300, 200), (2, 300, 200)]
    std = 0.5 / math.sqrt(8)
    # trunc_normal(-2, 2) has std 0.8796 of the normal's
    for t in (w, sliced):
        assert abs(t.mean().item()) < 2e-3 * std * 10
        assert abs(t.std().item() / std - 0.8796) < 0.005
        assert t.abs().max().item() <= 2 * std * (1 + 1e-6)
    assert not torch.equal(sliced, w)
    # every slice is its own draw: no two slices repeat each other
    assert not torch.equal(sliced[:2], sliced[3:5])


def test_llama4_built_whole_on_meta_counts_the_references_parameters():
    cfg = TC.get(LLAMA4)
    model = ttf.Transformer(cfg, "meta")
    got = sum(p.numel() for p in model.parameters())
    shapes = jax.eval_shape(lambda k: jtf.init(JC.get(LLAMA4), k), jax.random.PRNGKey(0))
    want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
    assert got == want
    assert 3.9e11 < got < 4.1e11
    assert all(p.device.type == "meta" for p in model.parameters())


@pytest.mark.parametrize("arch", [a for a in JC.ARCH_IDS])
def test_every_arch_builds_and_its_forward_matches_jax(arch):
    """Every config of the zoo builds, and the cache-less pass agrees with
    the reference's ``forward`` (the SSM layers' from a zero state; the
    reference's CPU path runs the chunked scan, the port the sequential
    one: 1e-4, as tests/test_torch_llm.py)."""
    jcfg, params, m = _model(arch, seed=4)
    toks, prefix = _inputs(jcfg, 1, 20, seed=5)
    want, _ = jtf.forward(jcfg, params, _j(toks), _j(prefix, jnp.float32))
    got, _ = m.forward(_t(toks), _t(prefix))
    _close(got.numpy(), want, tol=1e-4)
