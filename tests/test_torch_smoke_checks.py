"""The limits of ``chip_smoke.py`` hold what they claim, on the CPU.

K1's check must pass a kernel that differs from the plain version only by
K1's own rounding, and reject one that lets the zero padding of its ragged
last KV tile in. Phase 4's limit on the DiT's output must sit above what
bf16 itself gives and below what a wiring fault gives. The rounding model
below is K1's arithmetic in plain PyTorch: f32 scores per 64-key tile, an
online softmax with f32 running max and sum, and the unnormalised
probabilities rounded to bf16 before the P V product.

  PYTHONPATH=src python -m pytest -s tests/test_torch_smoke_checks.py

prints each reading.
"""
import dataclasses
import importlib.util
import math
import os

import pytest
import torch

import repro_torch.configs as C
from repro_torch.kernels import ref
from repro_torch.models import diffusion

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


def k1_rounding_model(q, k, v, pad_keys=False):
    """K1's arithmetic on the CPU; ``pad_keys`` lets the last tile's zero
    padding in at score 0, as a kernel without the ragged-edge mask would."""
    b, lq, h, d = q.shape
    if pad_keys:
        pad = -k.shape[1] % 64
        k, v = (torch.cat([t, t.new_zeros((b, pad, h, d))], 1) for t in (k, v))
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((b, h, lq, 1), -math.inf)
    lsum = torch.zeros((b, h, lq, 1))
    acc = torch.zeros((b, h, lq, d))
    for k0 in range(0, k.shape[1], 64):
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf[:, k0:k0 + 64]) / math.sqrt(d)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        lsum = alpha * lsum + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bkhd->bhqd", p.bfloat16().float(),
                                         vf[:, k0:k0 + 64])
        m = m_new
    return (acc / lsum).permute(0, 2, 1, 3).bfloat16()


@pytest.mark.parametrize("length", [1101, 4173])
def test_k1_check_passes_rounding_and_rejects_the_padded_key_fault(length):
    g = torch.Generator().manual_seed(length)
    q, k, v = (torch.randn((1, length, 4, 64), generator=g).bfloat16() for _ in range(3))
    want = ref.attention_ref(q, k, v)
    err, rel, ok = smoke.k1_agree(k1_rounding_model(q, k, v), want)
    print(f"L={length} rounding: max err {err:.5f}, rms err / rms {rel:.5f}")
    assert ok and rel < smoke.K1_RMS / 1.4
    err, rel, ok = smoke.k1_agree(k1_rounding_model(q, k, v, pad_keys=True), want)
    print(f"L={length} padded-key fault: max err {err:.5f}, rms err / rms {rel:.5f}")
    assert not ok


def _rms_rel(got, want):
    return ((got - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt()).item()


def test_dit_limit_sits_between_bf16_rounding_and_wiring_faults(monkeypatch):
    """Two full-width sd3 DiT layers, modulation filled as the smoke fills
    it: bf16 against f32 on the same weights reads well under EPS_TOL, and
    each wiring fault in the f32 model moves the output above it."""
    cfg = dataclasses.replace(C.get("sd3").dit, num_layers=2)
    torch.manual_seed(0)
    bf = diffusion.DiT(cfg, "cpu")
    bf.init_(torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for w in [layer.mod for layer in bf.layers] + [bf.final_mod]:
            w.copy_(torch.randn(w.shape, generator=g) * 0.02)
    f32 = diffusion.DiT(dataclasses.replace(cfg, dtype=torch.float32), "cpu")
    with torch.no_grad():
        for pf, pb in zip(f32.parameters(), bf.parameters()):
            pf.copy_(pb.float())
    g = torch.Generator().manual_seed(3)
    latents = torch.randn((1, 256, cfg.latent_dim), generator=g)
    cond = torch.randn((1, 77, cfg.cond_dim), generator=g)
    t = torch.tensor([500.0])
    with torch.no_grad():
        want = f32(latents, t, cond)
        rounding = _rms_rel(bf(latents, t, cond), want)
        print(f"bf16 vs f32: {rounding:.5f}")
        assert rounding < smoke.EPS_TOL / 1.5
        attention = diffusion.kops.flash_attention
        norm = diffusion.kops.adaln_rmsnorm
        faults = {
            "attention zeroed": (lambda q, k, v, **kw: torch.zeros_like(q), norm),
            "heads swapped": (lambda q, k, v, **kw: attention(q, k, v, **kw).flip(2), norm),
            "keys shifted one row": (
                lambda q, k, v, **kw: attention(q, k.roll(1, 1), v, **kw), norm),
            "scale and shift swapped": (
                attention, lambda x, s, sh, eps=1e-6: norm(x, sh, s, eps=eps)),
        }
        for name, (fa, an) in faults.items():
            monkeypatch.setattr(diffusion.kops, "flash_attention", fa)
            monkeypatch.setattr(diffusion.kops, "adaln_rmsnorm", an)
            moved = _rms_rel(f32(latents, t, cond), want)
            print(f"{name}: {moved:.5f}")
            assert moved > smoke.EPS_TOL, name
