"""The port's kernel modules against the JAX package, on the CPU.

On a CPU tensor each op of ``repro_torch.kernels.ops`` takes its plain
version; these tests hold that plain version to the JAX package's Pallas
kernels (interpret mode, as ``tests/test_kernels.py`` runs them) and to its
oracle path. The CUDA kernels themselves are held to the same plain
versions on the card (``test_torch_gpu.py`` and ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import adaln_rmsnorm as jar
from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import adaln_rmsnorm as tar
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ssm_scan as tss

# f32: both sides compute the same f32 arithmetic in another order
F32_TOL = 3e-5
# bf16: the probabilities and outputs are rounded to bf16 at the same places,
# but the f32 sums before each rounding differ in order -> one bf16 ulp
BF16_TOL = 2e-2


def _qkv(seed, b, lq, lkv, h, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, n, h, d)).astype(np.float32) for n in (lq, lkv, lkv)]


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


@pytest.mark.parametrize("b,lq,lkv,h,d", [
    (2, 64, 64, 2, 32), (1, 100, 100, 3, 64), (2, 1, 128, 2, 32),
    (1, 128, 128, 1, 128), (1, 17, 17, 2, 16),
])
def test_flash_attention_causal_matches_pallas(b, lq, lkv, h, d):
    arrs = _qkv(0, b, lq, lkv, h, d)
    want = jfa.flash_attention(*map(jnp.asarray, arrs), causal=True, block_q=32, block_k=32,
                               interpret=True)
    got = ops.flash_attention(*_torch(arrs, torch.float32), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("window,softcap,causal", [
    (48, 0.0, True), (0, 50.0, True), (16, 30.0, True), (0, 0.0, False),
])
def test_flash_attention_variants_match_pallas(window, softcap, causal):
    arrs = _qkv(1, 2, 96, 96, 2, 32)
    want = jfa.flash_attention(*map(jnp.asarray, arrs), causal=causal, window=window,
                               softcap=softcap, block_q=32, block_k=32, interpret=True)
    got = ops.flash_attention(*_torch(arrs, torch.float32), causal=causal, window=window,
                              softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)


def test_flash_attention_noncausal_matches_pallas_at_dit_shape():
    # the DiT's form: non-causal, L a multiple of the Pallas block (F1 raises otherwise)
    arrs = _qkv(2, 1, 64, 64, 4, 64)
    want = jfa.flash_attention(*map(jnp.asarray, arrs), causal=False, block_q=32, block_k=32,
                               interpret=True)
    got = ops.flash_attention(*_torch(arrs, torch.float32), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("l", [77, 200])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_ragged_matches_oracle(l, dtype):
    arrs = _qkv(3, 1, l, l, 3, 64)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    # both sides start from the same values in the working dtype
    jin = [jnp.asarray(a).astype(jdt) for a in arrs]
    tin = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt) for a in jin]
    want = jops.flash_attention(*jin, causal=False, use_kernel=False)
    got = ops.flash_attention(*tin, causal=False)
    assert got.dtype == tdt
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("b,l,d,rows", [(2, 100, 64, 32), (1, 7, 128, 256),
                                        (4, 256, 32, 64), (2, 37, 1536, 16), (3, 11, 3072, 8)])
def test_adaln_rmsnorm_matches_pallas(b, l, d, rows):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((b, l, d)).astype(np.float32)
    s = (rng.standard_normal((b, d)) * 0.1).astype(np.float32)
    t = (rng.standard_normal((b, d)) * 0.1).astype(np.float32)
    want = jar.adaln_rmsnorm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(t), block_rows=rows,
                             interpret=True)
    got = ops.adaln_rmsnorm(*(torch.from_numpy(a) for a in (x, s, t)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_cpu_ops_take_the_plain_versions_and_count_nothing():
    ops.reset_launches()
    q, k, v = _torch(_qkv(5, 1, 8, 8, 2, 64), torch.float32)
    assert torch.equal(ops.flash_attention(q, k, v, causal=False),
                       ref.attention_ref(q, k, v))
    x = torch.randn(1, 8, 16)
    s, t = torch.randn(1, 16), torch.randn(1, 16)
    assert torch.equal(ops.adaln_rmsnorm(x, s, t), ref.adaln_rmsnorm_ref(x, s, t))
    q4, w = q.permute(0, 2, 1, 3), torch.rand(1, 2, 8, 64)
    for got, want in zip(ops.linear_scan(q4, q4, q4, w), ref.ssm_scan_ref(q4, q4, q4, w)):
        assert torch.equal(got, want)
    assert ops.LAUNCHES == {"flash_attention": 0, "adaln_rmsnorm": 0, "ssm_scan": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    q, k, v = _torch(_qkv(6, 1, 8, 8, 2, 64), torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, k, v)
    x = torch.randn(1, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tar.adaln_rmsnorm(x, x[:, 0], x[:, 1])
    q4 = q.permute(0, 2, 1, 3)
    with pytest.raises(ValueError, match="CUDA"):
        tss.ssm_scan(q4, q4, q4, q4.float())


def test_build_raises_with_nvcc_stderr(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such thing' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path.parent))
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(_build.KernelBuildError, match="no such thing"):
        _build.build()
    assert not any((tmp_path / "build").iterdir())      # no half-built library is left


def test_build_key_follows_the_sources(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", src)
    h1 = _build.source_hash()
    (src / "a.cu").write_text("// two\n")
    assert _build.source_hash() != h1
    assert [p.name for p in _build.sources()] == ["a.cu"]


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"
