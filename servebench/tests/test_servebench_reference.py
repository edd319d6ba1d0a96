"""The plain reference against the port's pipeline at the SMOKE sizes on the
CPU, and its parameter list against the port's at full size."""
import json

import pytest
import torch

from conftest import ROOT, smoke_config
from servebench import program, weights
from servebench.reference import dit_pipeline as ref


@pytest.mark.parametrize("name", ["sd3", "flux"])
def test_config_file_is_the_ports_config(name):
    import repro_torch.configs as C
    cfg = json.loads((ROOT / "servebench" / "configs" / f"{name}.json").read_text())
    assert program.config(cfg) == C.get(name)


@pytest.mark.parametrize("name", ["sd3", "flux"])
def test_param_specs_are_the_pipelines_parameters(name):
    from repro_torch.models import pipeline as pl
    cfg = json.loads((ROOT / "servebench" / "configs" / f"{name}.json").read_text())
    pipe = pl.Pipeline(program.config(cfg), "meta")
    want = {n: (tuple(p.shape), p.dtype) for n, p in pipe.named_parameters()}
    got = {n: (tuple(s), getattr(torch, dt)) for n, s, dt, *_ in ref.param_specs(cfg)}
    assert got == want
    params = sum(p.numel() for p in pipe.parameters()) / 1e9
    assert params == pytest.approx(cfg["params_b"], abs=0.005)


@pytest.mark.parametrize("name", ["sd3", "flux"])
def test_reference_matches_the_port_on_cpu(name, cpu):
    """float32 on both sides: the stages agree to float32 rounding."""
    from repro_torch.models import pipeline as pl
    cfg = smoke_config(name)
    w = weights.for_config(cfg, cpu, 20260)
    pipe = program.pipeline(program.config(cfg), w)
    tokens = torch.randint(0, cfg["encoder"]["vocab_size"], (2, 77))
    res = 64
    grid = (1, res // 16, res // 16)
    noise = torch.randn((2, grid[1] * grid[2], cfg["dit"]["latent_dim"]))
    cond = pl.encode(pipe, tokens)
    with ref.plain_math():
        want_cond = ref.encode(w, cfg, tokens)
    torch.testing.assert_close(cond, want_cond, rtol=1e-4, atol=1e-5)
    t = torch.tensor([999.0, 333.0])
    torch.testing.assert_close(pipe.dit(noise, t, cond), ref.dit_forward(w, cfg, noise, t, cond),
                               rtol=1e-4, atol=1e-4)
    out = pl.decode(pipe, pl.diffuse(pipe, cond, noise.shape, noise=noise), grid)
    want = ref.generate(w, cfg, tokens, noise, res)
    assert out.shape == want.shape == (2, res, res, 3)
    assert ref.pixel_gap(out, want) < 1e-4
    # the pixels carry signal: not flat, not pinned at tanh's ends
    assert 0.05 < float(want.std()) < 0.8
    assert float((want.abs() > 0.99).float().mean()) < 0.05


def test_attention_blocks_equal_one_block(cpu, monkeypatch):
    q, k, v = (torch.randn(2, 37, 4, 16) for _ in range(3))
    whole = ref.attention(q, k, v, fp8=False)
    monkeypatch.setattr(ref, "ATTN_BLOCK_ELEMENTS", 37 * 5)
    torch.testing.assert_close(ref.attention(q, k, v, fp8=False), whole)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / 4.0
    plain = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    torch.testing.assert_close(whole, plain, rtol=1e-5, atol=1e-6)


def test_fp8_rounds_every_product(cpu):
    x = torch.randn(64, 64)
    q = ref._q8(x)
    assert 0 < float((q - x).abs().max()) < 0.1 * float(x.abs().max())
    assert len(torch.unique(q / (x.abs().max() / ref.FP8_MAX))) <= 256
