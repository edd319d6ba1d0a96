"""The port's scan and SSM mixers against the JAX package, on the CPU.

K3's plain version (``ops.linear_scan`` on a CPU tensor) is held against the
reference's Pallas kernel in interpret mode and its sequential oracle at the
reference's kernel-test shapes; at the decay floor only against the
sequential oracle, since the reference's chunked forms lose precision or
overflow there. The Mamba2 and RWKV6 mixers are held against
``repro.models.ssm`` at smoke size, weights from the JAX init. Inputs come
from numpy seeds; both sides run in float32.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.kernels import ref as jref
from repro.kernels import ssm_scan as jss
from repro.models import ssm as jssm
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssm_scan as tss
from repro_torch.models import ssm as tssm

# float32 on both sides: the sequential oracles agree to a few ulps; the
# Pallas kernel's chunked factorisation (exp(cum) / exp(-cum) within a chunk
# of 16) loses a few more digits, hence the reference's own 3e-3 for it
SEQ_TOL = 1e-5
KERNEL_TOL = 3e-3
# the mixers go through the reference's chunked scan (chunk 32) on the JAX
# side and the sequential one here, plus a few matmuls and norms
MIXER_TOL = 1e-4


def _scan_inputs(seed, b, h, l, dk, dv, bonus, floor=False):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v = f(b, h, l, dk), f(b, h, l, dk), f(b, h, l, dv)
    if floor:
        decay = np.full((b, h, l, dk), math.exp(-jss.MAX_NEG_LOGW), np.float32)
    else:
        decay = np.maximum(np.exp(-np.exp(f(b, h, l, dk))),
                           np.exp(-jss.MAX_NEG_LOGW)).astype(np.float32)
    s0 = f(b, h, dk, dv)
    u = f(h, dk) if bonus else None
    return q, k, v, decay, u, s0


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def test_port_keeps_its_own_copy_of_the_clamp():
    assert tss.MAX_NEG_LOGW == jss.MAX_NEG_LOGW


# the reference's kernel-test shapes (tests/test_kernels.py)
@pytest.mark.parametrize("b,h,l,dk,dv,bonus", [
    (2, 2, 100, 16, 32, False), (1, 3, 64, 32, 32, True),
    (2, 1, 33, 8, 8, True), (1, 2, 16, 64, 64, False),
    (1, 1, 7, 4, 4, True),
])
def test_linear_scan_matches_jax(b, h, l, dk, dv, bonus):
    q, k, v, decay, u, s0 = _scan_inputs(b * 100 + l, b, h, l, dk, dv, bonus)
    got_o, got_s = ops.linear_scan(_t(q), _t(k), _t(v), _t(decay), bonus=_t(u),
                                   initial_state=_t(s0))
    assert got_o.shape == (b, h, l, dv) and got_s.shape == (b, h, dk, dv)
    want_o, want_s = jref.linear_scan_ref(*map(_j, (q, k, v, decay, u, s0)))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=SEQ_TOL, rtol=SEQ_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=SEQ_TOL, rtol=SEQ_TOL)
    kern_o, kern_s = jss.ssm_scan(*map(_j, (q, k, v, decay)), bonus=_j(u),
                                  initial_state=_j(s0), interpret=True)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(kern_o), atol=KERNEL_TOL,
                               rtol=KERNEL_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(kern_s), atol=KERNEL_TOL,
                               rtol=KERNEL_TOL)


@pytest.mark.parametrize("bonus", [False, True])
def test_linear_scan_at_the_decay_floor_matches_the_sequential_oracle(bonus):
    """Every step at exp(-5.4), over 4 of the reference kernel's chunks:
    the port stays finite and on the sequential oracle (the reference's
    chunked forms are not held here: they are what loses precision)."""
    q, k, v, decay, u, s0 = _scan_inputs(11, 1, 2, 64, 8, 8, bonus, floor=True)
    got_o, got_s = ops.linear_scan(_t(q), _t(k), _t(v), _t(decay), bonus=_t(u),
                                   initial_state=_t(s0))
    assert torch.isfinite(got_o).all() and torch.isfinite(got_s).all()
    want_o, want_s = jref.linear_scan_ref(*map(_j, (q, k, v, decay, u, s0)))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=SEQ_TOL, rtol=SEQ_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=SEQ_TOL, rtol=SEQ_TOL)


def test_plain_scan_clamps_the_decay_as_the_kernel_does():
    """Decays below the floor (and zero) act as exp(-5.4), as in the TPU kernel."""
    q, k, v, _, u, s0 = _scan_inputs(12, 1, 2, 40, 8, 8, True)
    low = np.zeros_like(q)
    low[..., ::2] = 1e-9
    got = ops.linear_scan(_t(q), _t(k), _t(v), _t(low), bonus=_t(u), initial_state=_t(s0))
    floor = np.full_like(q, math.exp(-tss.MAX_NEG_LOGW))
    want = ref.linear_scan_ref(_t(q), _t(k), _t(v), _t(floor), _t(u), _t(s0))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=SEQ_TOL, rtol=SEQ_TOL)


def test_scan_split_in_two_with_the_state_carried_equals_one_scan():
    q, k, v, decay, u, s0 = (_t(a) for a in _scan_inputs(13, 2, 2, 50, 8, 16, True))
    o, s = ops.linear_scan(q, k, v, decay, bonus=u, initial_state=s0)
    cut = 23
    o1, s1 = ops.linear_scan(q[:, :, :cut], k[:, :, :cut], v[:, :, :cut], decay[:, :, :cut],
                             bonus=u, initial_state=s0)
    o2, s2 = ops.linear_scan(q[:, :, cut:], k[:, :, cut:], v[:, :, cut:], decay[:, :, cut:],
                             bonus=u, initial_state=s1)
    torch.testing.assert_close(torch.cat([o1, o2], 2), o, atol=SEQ_TOL, rtol=SEQ_TOL)
    torch.testing.assert_close(s2, s, atol=SEQ_TOL, rtol=SEQ_TOL)


@pytest.mark.parametrize("bonus", [False, True])
def test_linear_scan_decode_matches_jax(bonus):
    rng = np.random.default_rng(14)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    b, h, dk, dv = 2, 4, 8, 16
    q, k, v = f(b, h, dk), f(b, h, dk), f(b, h, dv)
    w = (1 / (1 + np.exp(-f(b, h, dk)))).astype(np.float32)
    s0, u = f(b, h, dk, dv), (f(h, dk) if bonus else None)
    got = ops.linear_scan_decode(_t(q), _t(k), _t(v), _t(w), _t(s0), bonus=_t(u))
    want = jref.linear_scan_decode_ref(*map(_j, (q, k, v, w, s0)), _j(u))
    for g, wt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wt), atol=SEQ_TOL, rtol=SEQ_TOL)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _load(mod, params):
    with torch.no_grad():
        for name, p in mod.named_parameters():
            p.copy_(torch.from_numpy(np.array(params[name], np.float32)))
    return mod


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=MIXER_TOL,
                               rtol=MIXER_TOL)


def test_mamba2_mixer_matches_jax():
    jcfg, tcfg = JC.get_smoke("zamba2-1.2b"), TC.get_smoke("zamba2-1.2b")
    params = jssm.init_mamba2(jcfg, jax.random.PRNGKey(3))
    mod = _load(tssm.Mamba2(tcfg, "cpu"), _np_tree(params))
    rng = np.random.default_rng(15)
    x = rng.standard_normal((2, 37, tcfg.d_model)).astype(np.float32)
    fwd = jax.jit(functools.partial(jssm.mamba2_forward, jcfg))
    dec = jax.jit(functools.partial(jssm.mamba2_decode, jcfg))
    want_y, want_st = fwd(params, jnp.asarray(x))
    with torch.no_grad():
        got_y, got_st = mod(torch.from_numpy(x))
    _close(got_y, want_y)
    for key in ("conv", "ssm"):
        _close(got_st[key], want_st[key])
    # two decode steps from the prefill state
    state_j, state_t = want_st, got_st
    for step in range(2):
        xt = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
        want_y, state_j = dec(params, jnp.asarray(xt), state_j)
        with torch.no_grad():
            got_y, state_t = mod.decode(torch.from_numpy(xt), state_t)
        _close(got_y, want_y)
        for key in ("conv", "ssm"):
            _close(state_t[key], state_j[key])


def test_rwkv6_mixer_matches_jax():
    jcfg, tcfg = JC.get_smoke("rwkv6-3b"), TC.get_smoke("rwkv6-3b")
    params = jssm.init_rwkv6(jcfg, jax.random.PRNGKey(4))
    mod = _load(tssm.RWKV6(tcfg, "cpu"), _np_tree(params))
    rng = np.random.default_rng(16)
    x = rng.standard_normal((2, 29, tcfg.d_model)).astype(np.float32)
    state = {k: rng.standard_normal(np.shape(a)).astype(np.float32) * 0.1
             for k, a in jssm.init_rwkv6_state(jcfg, 2).items()}
    timemix = jax.jit(functools.partial(jssm.rwkv6_timemix, jcfg), static_argnums=3)
    for decode, xs in ((False, x), (True, x[:, :1])):
        want = timemix(params, jnp.asarray(xs), {k: jnp.asarray(a) for k, a in state.items()},
                       decode)
        with torch.no_grad():
            got = mod.timemix(torch.from_numpy(xs), {k: torch.from_numpy(a)
                                                      for k, a in state.items()}, decode)
        for g, w in zip(got, want):
            _close(g, w)
    want = jax.jit(functools.partial(jssm.rwkv6_channelmix, jcfg))(params, jnp.asarray(x), None)
    with torch.no_grad():
        got = mod.channelmix(torch.from_numpy(x), None)
    for g, w in zip(got, want):
        _close(g, w)
