"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips where there is no CUDA device. This file
imports no JAX, so it runs where only PyTorch is installed:

  PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import adaln_rmsnorm as tar
from repro_torch.kernels import flash_attention as tfa

# bf16 outputs: the kernel and the plain version round at the same places,
# after f32 sums taken in another order -> one or two bf16 ulps
BF16_TOL = 2e-2


def _assert_attention_close(got, want):
    """Attention outputs of N(0, 1) inputs are small (rms ~ sqrt(e / L)), so
    the limits scale with their rms, as in chip_smoke.py: elementwise
    3e-2 * rms + 2**-6 * |want| (two bf16 ulps), and rms(err) <= 5e-3 * rms."""
    d = (got.float() - want.float()).abs()
    w = want.float()
    rms = w.pow(2).mean().sqrt()
    assert (d <= 3e-2 * rms + 2.0 ** -6 * w.abs()).all(), d.max().item()
    assert d.pow(2).mean().sqrt() <= 5e-3 * rms


def _qkv(seed, b, lq, lkv, h, d):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, n, h, d)).astype(np.float32))
            for n in (lq, lkv, lkv)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; run on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("l,d,causal,window,softcap", [
    (1101, 64, False, 0, 0.0), (333, 128, False, 0, 0.0), (96, 64, True, 16, 30.0),
    (200, 64, True, 0, 0.0),
])
def test_flash_attention_kernel_matches_plain_on_card(cuda, l, d, causal, window, softcap):
    q, k, v = (t.to(cuda, torch.bfloat16) for t in _qkv(7, 1, l, l, 4, d))
    got = tfa.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)
    mask = ops.attention_mask(l, l, window, cuda) if causal else None
    want = ref.attention_ref(q, k, v, mask, softcap)
    _assert_attention_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, BF16_TOL)])
def test_adaln_rmsnorm_kernel_matches_plain_on_card(cuda, dtype, tol):
    x = torch.randn(2, 333, 1536, device=cuda).to(dtype)
    mod = (torch.randn(2, 6, 1536, device=cuda) * 0.1).to(dtype)
    got = tar.adaln_rmsnorm(x, mod[:, 0], mod[:, 1])
    want = ref.adaln_rmsnorm_ref(x, mod[:, 0], mod[:, 1])
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
def test_ops_count_kernel_launches_on_card(cuda):
    ops.reset_launches()
    q, k, v = (t.to(cuda, torch.bfloat16) for t in _qkv(8, 1, 77, 77, 2, 64))
    ops.flash_attention(q, k, v, causal=False)
    x = q.reshape(1, 77, 128)
    ops.adaln_rmsnorm(x, x[:, 0], x[:, 1])
    assert ops.LAUNCHES == {"flash_attention": 1, "adaln_rmsnorm": 1}


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take(cuda):
    q, k, v = (t.to(cuda) for t in _qkv(9, 1, 8, 8, 2, 64))
    with pytest.raises(ValueError, match="bfloat16"):
        tfa.flash_attention(q, k, v)                     # float32
    q, k, v = (t.to(cuda, torch.bfloat16) for t in _qkv(9, 1, 8, 8, 2, 32))
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention(q, k, v)
