"""K2's plan and launch path, on the CPU.

``kernels/adaln_rmsnorm.plan`` picks the CUDA kernel's instantiation, and
the wrapper checks a shape, stride, dtype and device signature once and
remembers its launch record; each call then checks only its pointers'
alignment. These tests hold the plan valid at every shape the serve phases,
``chip_smoke.py`` and the card tests give the kernel, show that the
remembered check still refuses each bad input, and hold ``ops.adaln_rmsnorm``
on the CPU to its plain version and to the Pallas kernel in bf16.
"""
import ctypes
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.configs as C
from repro.kernels import adaln_rmsnorm as jar
from repro_torch.kernels import ops, ref
from repro_torch.kernels import adaln_rmsnorm as tar

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

SERVED = list(dict.fromkeys(shape for _, shape in
                            smoke.serving_shapes(C, {"zamba2-1.2b": []})[1]))
CARD_TESTS = [(b, l, d) for b, l in [(2, 333), (3, 1101), (4, 77), (5, 9)] for d in (1536, 3072)]
CHECKED = smoke.k2_check_shapes([("", s) for s in SERVED]) + [
    (b, l, d, dt) for b, l, d in CARD_TESTS + [(1, 77, 128), (2, 77, 128)]
    for dt in (torch.float32, torch.bfloat16)]


def test_served_shapes_are_the_seven_of_the_diffusion_paths():
    assert sorted(SERVED) == sorted([(1, 1101, 1536), (1, 4173, 1536), (1, 9293, 1536),
                                     (1, 1101, 3072), (1, 4173, 3072), (1, 7277, 3072),
                                     (1, 4433, 3072)])


@pytest.mark.parametrize("b,l,d,dtype", CHECKED,
                         ids=[f"{b}x{l}x{d}-{str(dt)[6:]}" for b, l, d, dt in CHECKED])
def test_plan_is_a_valid_instantiation(b, l, d, dtype):
    p = tar.plan(b, l, d, dtype)
    per_vec = 16 // dtype.itemsize
    nvec = d // per_vec
    lanes, nv = p["lanes"], p["vectors"]
    assert nv in tar.VECTORS and lanes in (1, 2, 4, 8, 16, 32)
    assert lanes * nv >= nvec                              # the row fits its lanes
    assert lanes == 32 or lanes // 2 < nvec <= lanes       # the fewest lanes, up to a warp
    assert all(v * lanes < nvec for v in tar.VECTORS if v < nv)   # the fewest vectors
    assert p["warps"] in (1, 2, 4) and p["rows_per_warp"] * lanes == 32
    assert p["rows_per_block"] == p["warps"] * p["rows_per_warp"]
    gx, gy = p["grid"]
    assert gy == b and (gx - 1) * p["rows_per_block"] < l <= gx * p["rows_per_block"]
    assert p["smem_bytes"] == 2 * d * dtype.itemsize <= 48 * 1024


@pytest.mark.parametrize("b,l,d", SERVED)
def test_plan_at_the_served_shapes(b, l, d):
    """bf16 at D = 1536 and 3072: every lane of a warp holds 6 or 12 full
    vectors (none masked), 4 warps a block, and the grid holds at least two
    blocks per SM."""
    p = tar.plan(b, l, d, torch.bfloat16)
    assert p["lanes"] == 32 and p["vectors"] * 32 * 8 == d and p["warps"] == 4
    assert p["grid"][0] * p["grid"][1] >= 2 * tar.SMS


def test_plan_spreads_short_calls_over_the_sms():
    assert tar.plan(1, 333, 3072, torch.bfloat16)["warps"] == 1       # 333 blocks of one row
    assert tar.plan(3, 333, 3072, torch.bfloat16)["warps"] == 2
    small = tar.plan(1, 7, 128, torch.bfloat16)
    assert (small["lanes"], small["rows_per_warp"], small["warps"], small["grid"]) == (
        16, 2, 1, (4, 1))


def test_plan_refuses_widths_it_has_no_instantiation_for():
    with pytest.raises(ValueError, match="multiple of 8"):
        tar.plan(1, 10, 1540, torch.bfloat16)
    with pytest.raises(ValueError, match="up to 3072"):
        tar.plan(1, 10, 3076, torch.float32)
    assert tar.plan(1, 10, 6144, torch.bfloat16)["vectors"] == 24


def _cuda_key(x, s, t, eps=1e-6, devices=("cuda:0",) * 3):
    """The signature of (x, s, t) as if they lay on ``devices``."""
    key = list(tar._key(x, s, t, eps))
    for i, dev in zip((3, 7, 11), devices):
        key[i] = torch.device(dev)
    return tuple(key)


def _inputs(b=2, l=5, d=64, dtype=torch.bfloat16):
    mod = torch.randn((b, 6, d)).to(dtype)
    return torch.randn((b, l, d)).to(dtype), mod[:, 0], mod[:, 1]


def test_launch_record_follows_the_plan():
    x, s, t = _inputs(3, 333, 3072)
    dev, rec, addr = tar._launch_record(_cuda_key(x, s, t, 1e-5))
    p = tar.plan(3, 333, 3072, torch.bfloat16)
    assert dev == 0 and addr == ctypes.addressof(rec)
    assert (rec.B, rec.L, rec.D, rec.vectors, 1 << rec.lanes_log2, rec.warps) == (
        3, 333, 3072, p["vectors"], p["lanes"], p["warps"])
    assert (rec.scale_stride, rec.shift_stride, rec.dtype) == (6 * 3072, 6 * 3072, 1)
    assert rec.eps == pytest.approx(1e-5)


def _bad_signatures():
    x, s, t = _inputs()
    xf = x.float()
    wide = torch.randn((2, 6, 66)).bfloat16()
    return [
        ("CUDA device", (x, s, t), ("cpu", "cpu", "cpu")),
        ("CUDA device", (x, s, t), ("cuda:0", "cuda:1", "cuda:0")),
        ("float32 or bfloat16", (xf, s, t), None),
        ("float32 or bfloat16", (x.half(), s.half(), t.half()), None),
        ("bad shapes", (x, s[:1], t[:1]), None),
        ("bad shapes", (x, s, t[:, :32]), None),
        ("bad shapes", (x[0], s, t), None),
        ("multiple of 8", (torch.randn((2, 5, 66)).bfloat16(), wide[:, 0], wide[:, 1]), None),
        ("contiguous", (x.transpose(0, 1).contiguous().transpose(0, 1), s, t), None),
        ("unit stride", (x, s, torch.randn((2, 128)).bfloat16()[:, ::2]), None),
        ("row stride", (x, torch.randn((2, 68)).bfloat16()[:, :64], t), None),
    ]


@pytest.mark.parametrize("match,args,devices", _bad_signatures(),
                         ids=[f"{i}-{m}" for i, (m, _, _) in enumerate(_bad_signatures())])
def test_signature_check_refuses_what_the_kernel_does_not_take(match, args, devices):
    key = _cuda_key(*args, devices=devices or ("cuda:0",) * 3)
    with pytest.raises(ValueError, match=match):
        tar._launch_record(key)


def test_cpu_tensors_are_refused_and_not_remembered():
    x, s, t = _inputs()
    with pytest.raises(ValueError, match="CUDA"):
        tar.adaln_rmsnorm(x, s, t)
    assert tar._key(x, s, t, 1e-6) not in tar._SIGNATURES


def test_a_remembered_signature_still_checks_each_calls_pointers(monkeypatch):
    """A second call of a remembered signature skips the signature's checks
    but not the alignment of its pointers (here the signature of CPU tensors
    is planted, so the call stops at that check without a card)."""
    buf = torch.randn(2 * 5 * 64 + 4)
    mod = torch.randn((2, 6, 64))
    x = buf[:640].view(2, 5, 64)
    shifted = buf[1:641].view(2, 5, 64)
    key = tar._key(x, mod[:, 0], mod[:, 1], 1e-6)
    assert tar._key(shifted, mod[:, 0], mod[:, 1], 1e-6) == key
    monkeypatch.setitem(tar._SIGNATURES, key, (0, None, 0))
    with pytest.raises(ValueError, match="16-byte aligned"):
        tar.adaln_rmsnorm(shifted, mod[:, 0], mod[:, 1])


@pytest.mark.parametrize("b,l,d", [(2, 37, 1536), (3, 11, 3072), (2, 100, 64)])
def test_ops_on_cpu_equal_the_plain_version_and_the_pallas_kernel_in_bf16(b, l, d):
    """bf16 inputs: the op takes the plain version on the CPU (bit-equal);
    the Pallas kernel (interpret mode) computes the same f32 values in another
    order of sums and rounds them to bf16 alike, so they agree to one ulp."""
    rng = np.random.default_rng(b * l + d)
    arrs = [rng.standard_normal((b, l, d)), rng.standard_normal((b, d)) * 0.1,
            rng.standard_normal((b, d)) * 0.1]
    jin = [jnp.asarray(a, dtype=jnp.float32).astype(jnp.bfloat16) for a in arrs]
    x, s, t = (torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16() for a in jin)
    got = ops.adaln_rmsnorm(x, s, t)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ref.adaln_rmsnorm_ref(x, s, t))
    want = jar.adaln_rmsnorm(*jin, block_rows=16, interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)
