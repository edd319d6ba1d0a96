"""Training on the port against the JAX package, on the CPU.

Both sides run the smoke configs in float32 from one state: the reference's
``loop.init_state``, carried into the port by ``convert.from_jax_state``.
The port's training pass runs the chunked scan at chunk 16 where the
reference's CPU path runs it at 32: off the decay floor the two agree to
float32 rounding (``ref.chunked_linear_scan_ref``). The sequence length 20
passes the smoke window and chunk of 16, so gemma2's local mask and
llama4's chunk bind.
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.data import pipeline as jdp
from repro.kernels import ref as jref
from repro.training import loop as jloop
from repro.training import optimizer as jopt
from repro_torch import convert
from repro_torch.data import pipeline as tdp
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ssm_scan import MAX_NEG_LOGW
from repro_torch.launch import train as tlaunch
from repro_torch.launch import train_llm
from repro_torch.training import checkpoint as tck
from repro_torch.training import loop as tloop
from repro_torch.training import optimizer as topt

LOSS_TOL = 1e-5       # float32 on both sides, sums in another order
GRAD_TOL = 1e-4       # each parameter's gradient: rms(err) <= GRAD_TOL * rms(ref)
TRAJ_TOL = 1e-4
SEQ = 20
GRAD_ARCHS = ("yi-9b", "deepseek-moe-16b", "rwkv6-3b", "zamba2-1.2b", "gemma2-9b",
              "llama4-maverick-400b-a17b")
FAMILIES = ("yi-9b", "deepseek-moe-16b", "rwkv6-3b", "zamba2-1.2b")


@pytest.fixture(autouse=True)
def one_thread():
    """The smoke configs' ops are small: one intra-op thread runs them
    faster than a team, and keeps this file from crowding the other test
    workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _port_state(tcfg, jstate):
    n = _np(jstate)
    return convert.from_jax_state(tcfg, n.params, n.opt.mu, n.opt.nu, int(jstate.opt.step),
                                  "cpu")


def _batch(cfg, step=0, batch=2, seq=SEQ):
    return jdp.synthetic_batch(cfg, jdp.DataConfig(batch=batch, seq_len=seq), step)


@functools.lru_cache(maxsize=None)
def _both(arch):
    """The reference's and the port's loss metrics and, for GRAD_ARCHS,
    gradients (the port's keyed by its parameter names) on one batch, from
    one state."""
    jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    js = jloop.init_state(jcfg, jax.random.PRNGKey(0))
    nb = _batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    ts = _port_state(tcfg, js)
    loss, tm = tloop.loss_fn(ts.model, tdp.to_tensors(nb, "cpu"))
    tm = {k: v.item() for k, v in tm.items()}
    if arch not in GRAD_ARCHS:
        _, jm = jloop.loss_fn(jcfg, js.params, jb)
        return {k: float(v) for k, v in jm.items()}, tm, None, None
    (_, jm), jg = jax.value_and_grad(lambda p: jloop.loss_fn(jcfg, p, jb), has_aux=True)(js.params)
    loss.backward()
    want = convert._lm_arrays(tcfg, ts.model, jax.tree_util.tree_map(np.asarray, jg))
    got = {n: (np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy())
           for n, p in ts.model.named_parameters()}
    return {k: float(v) for k, v in jm.items()}, tm, got, want


@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_synthetic_batch_is_bit_equal_and_batch_spec_describes_it(arch):
    jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    dcfg = jdp.DataConfig(batch=3, seq_len=17, seed=2)
    for step in (0, 7):
        want = jdp.synthetic_batch(jcfg, dcfg, step)
        got = tdp.synthetic_batch(tcfg, tdp.DataConfig(batch=3, seq_len=17, seed=2), step)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    spec = tdp.batch_spec(tcfg, tdp.DataConfig(batch=3, seq_len=17))
    jspec = jdp.batch_spec(jcfg, dcfg)
    assert set(spec) == set(jspec)
    for k, s in spec.items():
        assert s.shape == jspec[k].shape == got[k].shape
        assert str(s.dtype).split(".")[-1] == jnp.dtype(jspec[k].dtype).name


def test_schedule_matches_jax():
    for cfg in (jopt.AdamWConfig(), jopt.AdamWConfig(lr=1e-3, warmup_steps=20,
                                                     total_steps=200, min_lr_ratio=0.2)):
        tcfg = topt.AdamWConfig(**dataclasses.asdict(cfg))
        for step in (0, 1, 5, 19, 20, 21, 99, 100, 101, 150, 200, 5000, 10_000, 20_000):
            want = float(jopt.schedule(cfg, jnp.int32(step)))
            got = topt.schedule(tcfg, torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.item(), want, rtol=1e-6, atol=0)


def _bf16_ulp(x):
    """The bf16 unit in the last place at each |x|."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return np.exp2(e - 7)


@pytest.mark.parametrize("grad_scale,binds", [(1e-2, False), (1e3, True)])
def test_global_norm_and_update_match_jax(grad_scale, binds):
    """Two updates of float32 and bf16 leaves, the second from non-zero
    moments, with the clip binding and not: the global norm, the moments
    and the float32 leaves at 1e-6 (relative, and of the leaf's largest
    value, where a sum cancels), the bf16 leaves within one bf16 ulp."""
    rng = np.random.default_rng(4)
    shapes = {"a": (5, 7), "b": (3, 11), "c": (4,)}
    dtypes = {"a": jnp.float32, "b": jnp.bfloat16, "c": jnp.float32}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    jp = {k: jnp.asarray(v, dtypes[k]) for k, v in init.items()}
    tp = {k: torch.from_numpy(np.array(jp[k], np.float32)).to(
        torch.bfloat16 if dtypes[k] == jnp.bfloat16 else torch.float32) for k in init}
    cfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=1)
    tcfg = topt.AdamWConfig(**dataclasses.asdict(cfg))
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(2):
        g = {k: (rng.standard_normal(s) * grad_scale).astype(np.float32)
             for k, s in shapes.items()}
        jg = {k: jnp.asarray(v, dtypes[k]) for k, v in g.items()}
        tg = {k: torch.from_numpy(np.array(jg[k], np.float32)).to(tp[k].dtype) for k in g}
        np.testing.assert_allclose(topt.global_norm(tg).item(), float(jopt.global_norm(jg)),
                                   rtol=1e-6)
        assert (topt.global_norm(tg).item() > cfg.grad_clip) == binds
        jp, js = jopt.update(cfg, jg, js, jp)
        tp, ts = topt.update(tcfg, tg, ts, tp)
    assert int(ts.step) == int(js.step) == 2
    for k in shapes:
        for got, want in ((ts.mu[k], js.mu[k]), (ts.nu[k], js.nu[k])):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max())
        got, want = tp[k].float().numpy(), np.asarray(jp[k], np.float32)
        assert tp[k].dtype == (torch.bfloat16 if k == "b" else torch.float32)
        if k == "b":
            assert (np.abs(got - want) <= _bf16_ulp(want)).all()
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_loss_fn_matches_jax(arch):
    want, got, _, _ = _both(arch)
    for k in ("loss", "nll", "aux"):
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_TOL, atol=1e-7, err_msg=k)
    assert (got["aux"] > 0) == (TC.get_smoke(arch).num_experts > 0)


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_gradients_match_jax(arch):
    """Every parameter's gradient, the router's too: it takes gradient
    through the normalised gates and through the aux loss's mean
    probabilities, as the reference's einsum form."""
    _, _, got, want = _both(arch)
    assert set(got) == set(want)
    for n, w in want.items():
        w = np.asarray(w, np.float32)
        err = np.sqrt(np.mean((got[n] - w) ** 2))
        assert err <= GRAD_TOL * np.sqrt(np.mean(w ** 2)) + 1e-12, n
        if "router" in n:
            assert np.abs(w).max() > 0


def test_train_trajectory_matches_jax_and_a_converted_state_resumes_it():
    """Five steps of deepseek-moe (MoE aux loss in the step) on both sides:
    loss, grad norm and lr at each step; after step 2 the reference's state,
    carried over again, has the port's moments and parameters and resumes
    the same trajectory. The moments agree at TRAJ_TOL of each tensor's
    largest value, the parameters within lr: AdamW turns a gradient's
    rounding near 0 into a step of up to lr."""
    arch = "deepseek-moe-16b"
    jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    cfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    js = jloop.init_state(jcfg, jax.random.PRNGKey(1))
    ts = _port_state(tcfg, js)
    jstep = jax.jit(jloop.make_train_step(jcfg, cfg))
    tstep = tloop.make_train_step(tcfg, topt.AdamWConfig(**dataclasses.asdict(cfg)))
    for i in range(5):
        nb = _batch(jcfg, step=i)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in nb.items()})
        ts, tm = tstep(ts, tdp.to_tensors(nb, "cpu"))
        for k in ("loss", "nll", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=TRAJ_TOL, err_msg=k)
        if i == 1:
            again = _port_state(tcfg, js)
            for key, t in tck.state_tree(again).items():
                want = t.numpy()
                atol = cfg.lr if key.startswith("params.") else TRAJ_TOL * np.abs(want).max()
                np.testing.assert_allclose(tck.state_tree(ts)[key].numpy(), want, rtol=TRAJ_TOL,
                                           atol=atol, err_msg=key)
            ts = again
    assert int(ts.opt.step) == 5


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_on_equals_remat_off(arch):
    """Recomputing each layer in the backward gives the same gradients, bit
    for bit, as keeping its activations."""
    grads = []
    for remat in (True, False):
        cfg = dataclasses.replace(TC.get_smoke(arch), remat=remat)
        state = tloop.init_state(cfg, 5, "cpu")
        loss, _ = tloop.loss_fn(state.model, tdp.to_tensors(_batch(cfg), "cpu"))
        loss.backward()
        grads.append({n: p.grad for n, p in state.model.named_parameters()})
    for n, g in grads[0].items():
        assert torch.equal(g, grads[1][n]), n


def _train(arch, steps, batch, seq, **over):
    cfg = dataclasses.replace(TC.get_smoke(arch), **over)
    dcfg = tdp.DataConfig(batch=batch, seq_len=seq)
    return tloop.train(cfg, tdp.iterator(cfg, dcfg), num_steps=steps, log_every=5, device="cpu")


@pytest.mark.parametrize("arch", ["yi-9b", "rwkv6-3b"])
def test_loss_decreases(arch):
    _, hist = _train(arch, 25, 4, 32)
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert [h["step"] for h in hist] == [0, 5, 10, 15, 20, 24]


def test_adamw_schedule():
    cfg = topt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    assert topt.schedule(cfg, 0).item() == 0.0
    assert abs(topt.schedule(cfg, 10).item() - 1.0) < 1e-6
    assert abs(topt.schedule(cfg, 100).item() - 0.1) < 1e-6


def test_adamw_descends_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = topt.init(params)
    cfg = topt.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=1000, weight_decay=0.0)
    for _ in range(200):
        params, state = topt.update(cfg, {"w": 2 * params["w"]}, state, params)
    assert params["w"].abs().max().item() < 0.15


def test_grad_clip_limits_update():
    params = {"w": torch.zeros(3)}
    state = topt.init(params)
    cfg = topt.AdamWConfig(lr=1e-3, warmup_steps=0, grad_clip=1.0, weight_decay=0.0)
    new, _ = topt.update(cfg, {"w": torch.full((3,), 1e9)}, state, params)
    assert torch.isfinite(new["w"]).all()
    # the clip scales the gradient to norm 1 before the moments see it
    np.testing.assert_allclose(state.mu["w"].numpy(), 0.1 / np.sqrt(3), rtol=1e-5)


def test_checkpoint_round_trip_restores_every_tensor_bit_equal(tmp_path):
    """A bf16 gemma2 state after one step (non-zero moments), saved and
    restored into a state drawn from another seed."""
    cfg = dataclasses.replace(TC.get_smoke("gemma2-9b"), dtype=torch.bfloat16)
    state = tloop.init_state(cfg, 0, "cpu")
    state, _ = tloop.make_train_step(cfg)(state, tdp.to_tensors(_batch(cfg), "cpu"))
    path = str(tmp_path / "ck" / "state.pt")
    tck.save_state(path, state)
    assert os.listdir(tmp_path / "ck") == ["state.pt"]
    fresh = tck.restore_state(path, tloop.init_state(cfg, 1, "cpu"))
    saved, back = tck.state_tree(state), tck.state_tree(fresh)
    assert set(saved) == set(back) and any(k.startswith("mu.") for k in saved)
    assert back["params.embed"].dtype == torch.bfloat16
    for k, t in saved.items():
        assert back[k].dtype == t.dtype and torch.equal(back[k], t), k
    assert int(fresh.opt.step) == 1 and back["nu.embed"].abs().sum() > 0


def test_checkpoint_restore_rejects_other_keys_shapes_and_dtypes(tmp_path):
    path = str(tmp_path / "t.pt")
    tree = {"a": torch.zeros(2, 3), "b": torch.ones(4, dtype=torch.bfloat16)}
    tck.save(path, tree)
    back = tck.restore(path, tree)
    assert all(torch.equal(back[k], tree[k]) for k in tree)
    for like, what in (({"a": tree["a"]}, "keys"),
                       ({"a": torch.zeros(3, 2), "b": tree["b"]}, "expected"),
                       ({"a": tree["a"], "b": torch.ones(4)}, "expected")):
        with pytest.raises(ValueError, match=what):
            tck.restore(path, like)


def test_data_determinism_and_batch_spec_shapes():
    cfg = TC.get_smoke("deepseek-moe-16b")
    dcfg = tdp.DataConfig(batch=8, seq_len=16, seed=3)
    a, b = tdp.synthetic_batch(cfg, dcfg, 5), tdp.synthetic_batch(cfg, dcfg, 5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], tdp.synthetic_batch(cfg, dcfg, 6)["tokens"])
    assert tdp.batch_spec(cfg, dcfg)["tokens"].shape == a["tokens"].shape
    t = tdp.to_tensors(a, "cpu")
    assert t["tokens"].dtype == torch.int64 and torch.equal(t["tokens"],
                                                            torch.from_numpy(a["tokens"]).long())


def test_vlm_train_step_scores_text_positions_only():
    cfg = TC.get_smoke("internvl2-2b")
    state = tloop.init_state(cfg, 0, "cpu")
    batch = tdp.to_tensors(tdp.synthetic_batch(cfg, tdp.DataConfig(batch=2, seq_len=16), 0),
                           "cpu")
    logits, _ = state.model.train_forward(batch["tokens"], batch["patch_embeds"])
    assert logits.shape[1] == cfg.vision_tokens + 16
    assert tloop.token_nll(cfg, logits, batch["labels"]).shape == (2, 16)
    _, metrics = tloop.make_train_step(cfg)(state, batch)
    assert np.isfinite(metrics["loss"].item())


@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_train_step_runs_the_references_training_math_not_the_kernel_ops(arch, monkeypatch):
    """With the kernel ops made to raise, the serving pass fails and a train
    step of every config still runs: training reaches no kernel."""
    def boom(*args, **kwargs):
        raise AssertionError("the training pass reached a kernel op")
    cfg = TC.get_smoke(arch)
    state = tloop.init_state(cfg, 0, "cpu")
    batch = tdp.to_tensors(_batch(cfg), "cpu")
    monkeypatch.setattr(ops, "flash_attention", boom)
    monkeypatch.setattr(ops, "linear_scan", boom)
    with pytest.raises(AssertionError, match="kernel op"):
        state.model(batch["tokens"], batch.get("patch_embeds"))
    state, metrics = tloop.make_train_step(cfg)(state, batch)
    assert all(np.isfinite(v.item()) for v in metrics.values())
    assert int(state.opt.step) == 1


def _scan_inputs(b, h, l, dk, dv, floor, seed):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((b, h, l, dk)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((b, h, l, dv)).astype(np.float32)
    if floor:
        decay = np.full((b, h, l, dk), np.exp(-MAX_NEG_LOGW), np.float32)
    else:
        decay = np.exp(-rng.uniform(0.0, 0.25, (b, h, l, dk))).astype(np.float32)
    bonus = rng.standard_normal((h, dk)).astype(np.float32)
    s0 = rng.standard_normal((b, h, dk, dv)).astype(np.float32)
    return q, k, v, decay, bonus, s0


@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("bonus", [False, True])
def test_chunked_scan_matches_jax_and_the_sequential_oracle(chunk, bonus):
    """Off the floor: the port's copy equals the reference's chunked form at
    the same chunk, and chunk 16 equals the sequential oracle, on a length
    that is no multiple of the chunk, from a non-zero state."""
    q, k, v, decay, bn, s0 = _scan_inputs(2, 3, 45, 8, 6, floor=False, seed=chunk + bonus)
    bn = bn if bonus else None
    want, want_s = jref.chunked_linear_scan_ref(*(jnp.asarray(a) for a in (q, k, v, decay)),
                                                None if bn is None else jnp.asarray(bn),
                                                jnp.asarray(s0), chunk=chunk)
    t = [torch.from_numpy(a) for a in (q, k, v, decay)]
    tb, ts0 = (None if bn is None else torch.from_numpy(bn)), torch.from_numpy(s0)
    got, got_s = tref.chunked_linear_scan_ref(*t, tb, ts0, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5, atol=1e-5)
    seq, seq_s = tref.linear_scan_ref(*t, tb, ts0)
    if chunk == tref.TRAIN_CHUNK:
        np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_s.numpy(), seq_s.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bonus", [False, True])
def test_train_scan_at_the_decay_floor_stays_finite(bonus):
    """At the floor decay exp(-MAX_NEG_LOGW) the port's chunk-16 scan and
    the gradients of a mean loss stay finite, where the reference's chunk
    32 gives NaN (F2); chunk 16 still loses precision at each chunk's end
    (F3), so it is held here to finiteness only."""
    q, k, v, decay, bn, s0 = _scan_inputs(2, 4, 64, 64, 64, floor=True, seed=9)
    bn = bn if bonus else None
    ref32, _ = jref.chunked_linear_scan_ref(*(jnp.asarray(a) for a in (q, k, v, decay)),
                                            None if bn is None else jnp.asarray(bn),
                                            jnp.asarray(s0), chunk=32)
    assert not np.isfinite(np.asarray(ref32)).all()
    t = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    w = torch.from_numpy(decay).requires_grad_(True)
    out, s = tref.chunked_linear_scan_ref(*t, w, None if bn is None else torch.from_numpy(bn),
                                          torch.from_numpy(s0))
    assert torch.isfinite(out).all() and torch.isfinite(s).all()
    (out.square().mean() + s.mean()).backward()
    for x in t + [w]:
        assert torch.isfinite(x.grad).all()


def test_launch_train_runs_on_the_cpu_and_refuses_a_mesh(capsys):
    argv = ["--arch", "deepseek-moe-16b", "--smoke", "--steps", "3", "--batch", "2", "--seq",
            "16", "--device", "cpu", "--log-every", "2"]
    state, rows = tlaunch.main(argv + ["--mesh", "1x1"])
    assert [r["step"] for r in rows] == [0, 1, 2] and int(state.opt.step) == 3
    assert all(np.isfinite(r["loss"]) and r["ms"] > 0 for r in rows)
    assert "step    2" in capsys.readouterr().out
    # a mesh the world cannot hold is refused (one process is a world of 1;
    # tests/test_torch_sharding.py runs --mesh 2x1 under torchrun), as is an
    # unknown switch
    for extra, match in ((["--mesh", "2x1"], "world size is 1"),
                         (["--opt", "zero,tp"], "switches are")):
        with pytest.raises(SystemExit, match=match):
            tlaunch.main(argv + extra)


def test_train_llm_example_loss_falls_and_its_checkpoint_restores(tmp_path):
    path = str(tmp_path / "llm.pt")
    state, hist, written = train_llm.main(["--steps", "30", "--device", "cpu", "--ckpt", path])
    assert written == path and hist[-1]["loss"] < hist[0]["loss"]
    fresh = tck.restore_state(path, tloop.init_state(state.model.cfg, 1, "cpu"))
    for key, t in tck.state_tree(state).items():
        assert torch.equal(tck.state_tree(fresh)[key], t), key
