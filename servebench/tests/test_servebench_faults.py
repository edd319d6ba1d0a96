"""A whole run at the SMOKE sizes on the CPU (the harness's look for a card
skipped), sound and with the timed path broken underneath: ``correct``
comes out true, then false for each fault a serving cell can have. (Half
a batch left out and a missing exchange between chips belong to training
and to cells on several chips: these cells have neither.)"""
import copy
import json
import time

import pytest
import torch

from conftest import ROOT
from servebench import harness
from servebench.reference import dit_pipeline as ref


def _run(cell, cpu, seconds=2.0):
    out, run = harness.run(cell, 2 ** 31 + 101, seconds, False, cpu, time.perf_counter())
    return out, run


@pytest.mark.parametrize("config,mix", [("sd3", "sd3_saturated"), ("flux", "flux_hires")])
def test_sound_run_is_correct(smoke_cell, cpu, config, mix):
    out, run = _run(smoke_cell(config, mix), cpu)
    assert out["correct"], out["compared"]
    assert out["attempted"] == len(run.requests) > 0 and out["failed"] == 0
    assert out["compared"]["unchecked"]["value"] == 0
    assert list(out)[-1] == "compared"


def test_diffuse_returning_its_state_unchanged_is_caught(smoke_cell, cpu, monkeypatch):
    from repro_torch.models import pipeline as pl
    monkeypatch.setattr(pl, "diffuse",
                        lambda pipe, cond, shape, generator=None, num_steps=None, noise=None: noise)
    out, _ = _run(smoke_cell("sd3", "sd3_saturated"), cpu)
    assert not out["correct"]
    assert out["compared"]["pixel_gap"]["value"] > out["compared"]["pixel_gap"]["limit"]


def test_a_denoising_step_left_out_is_caught(smoke_cell, cpu, monkeypatch):
    """sd3's loop served with one step fewer: 19 steps on their own
    schedule where 20 are due."""
    from repro_torch.models import pipeline as pl
    real = pl.diffuse

    def short(pipe, cond, shape, generator=None, num_steps=None, noise=None):
        return real(pipe, cond, shape, generator, (num_steps or pipe.cfg.num_steps) - 1, noise)
    monkeypatch.setattr(pl, "diffuse", short)
    out, _ = _run(smoke_cell("sd3", "sd3_saturated"), cpu)
    assert not out["correct"]


def _timesteps(cell):
    from repro_torch.models import diffusion
    return diffusion.ddim_timesteps(cell["cfg"]["pipeline"]["num_steps"])


def _bf16_cell(smoke_cell, config, mix):
    """The cell in bfloat16, as served, held to the configuration's limit."""
    cell = smoke_cell(config, mix)
    for part in ("encoder", "dit", "decoder"):
        cell["cfg"][part]["dtype"] = "bfloat16"
    limits = json.loads((ROOT / "servebench" / "configs" / f"{config}.json").read_text())
    cell["cfg"]["limits"] = limits["limits"]
    return cell


@pytest.mark.parametrize("config,mix", [("sd3", "sd3_saturated"), ("flux", "flux_hires")])
@pytest.mark.parametrize("step", ["first", "middle"])
def test_a_step_returning_its_state_unchanged_is_caught(smoke_cell, cpu, monkeypatch,
                                                        config, mix, step):
    """One DDIM step predicts the noise c * x for which its update gives x
    back: r (1 - c sqrt(1 - a)) + c sqrt(1 - n) = 1, with a and n the
    alpha-bars of this step and the next and r = sqrt(n / a)."""
    from repro_torch.models import diffusion
    cell = _bf16_cell(smoke_cell, config, mix)
    ts = _timesteps(cell)
    k = 0 if step == "first" else len(ts) // 2
    ab = torch.cumprod(1.0 - diffusion.jax_linspace(1e-4, 0.02, 1000), 0)
    a, n = ab[ts[k]], ab[ts[k + 1]]
    r = (n / a).sqrt()
    c = float((1 - r) / ((1 - n).sqrt() - r * (1 - a).sqrt()))
    real = diffusion.DiT.forward

    def stuck(self, latents, t, cond, cond_pooled=None):
        if float(t[0]) == float(ts[k]):
            return c * latents.float()
        return real(self, latents, t, cond, cond_pooled)
    monkeypatch.setattr(diffusion.DiT, "forward", stuck)
    out, _ = _run(cell, cpu)
    assert not out["correct"]


@pytest.mark.parametrize("config,mix", [("sd3", "sd3_saturated"), ("flux", "flux_hires")])
def test_every_second_step_reusing_the_last_prediction_is_caught(smoke_cell, cpu, monkeypatch,
                                                                 config, mix):
    """A cache: every second step hands on the step before's noise
    estimate. (One reused step of sd3's 20 moves these pixels by about
    1.7%, under the limit: such a cache is not caught.)"""
    from repro_torch.models import diffusion
    cell = _bf16_cell(smoke_cell, config, mix)
    reused = set(_timesteps(cell)[1::2])
    real = diffusion.DiT.forward
    last = {}

    def cached(self, latents, t, cond, cond_pooled=None):
        if int(t[0]) in reused and "e" in last:
            return last["e"]
        last["e"] = real(self, latents, t, cond, cond_pooled)
        return last["e"]
    monkeypatch.setattr(diffusion.DiT, "forward", cached)
    out, _ = _run(cell, cpu)
    assert not out["correct"], out["compared"]


@pytest.mark.parametrize("config,mix", [("sd3", "sd3_saturated")])
def test_steps_after_the_first_in_float8_are_caught(smoke_cell, cpu, monkeypatch, config, mix):
    """Every step but the first computed by the reference with float8 e4m3
    products, in the program's place; the sound bfloat16 program passes.
    (Not flux: its four DDIM steps weigh the first prediction's error 15.8
    times, the others 4.5, 1.45 and 0.01 times, so its sound gap is set by
    the first step and float8 in steps 2-4 reads under its limit.)"""
    from repro_torch.models import diffusion
    cell = _bf16_cell(smoke_cell, config, mix)
    out, _ = _run(copy.deepcopy(cell), cpu)
    assert out["correct"], out["compared"]
    real = diffusion.DiT.forward

    def fp8(self, latents, t, cond, cond_pooled=None):
        if float(t[0]) == 999.0:
            return real(self, latents, t, cond, cond_pooled)
        w = {f"dit.{n}": p for n, p in self.named_parameters()}
        return ref.dit_forward(w, cell["cfg"], latents.float(), t, cond.float(), fp8=True)
    monkeypatch.setattr(diffusion.DiT, "forward", fp8)
    out, _ = _run(cell, cpu)
    assert not out["correct"], out["compared"]


def test_an_answer_altered_where_it_is_produced_is_caught(smoke_cell, cpu, monkeypatch):
    from repro_torch.models import pipeline as pl
    real = pl.decode

    def altered(pipe, latents, grid):
        out = real(pipe, latents, grid)
        out[..., 0] += 0.05                      # the red channel, every pixel
        return out
    monkeypatch.setattr(pl, "decode", altered)
    out, _ = _run(smoke_cell("sd3", "sd3_saturated"), cpu)
    assert not out["correct"]


def test_a_prompt_token_altered_is_caught(smoke_cell, cpu, monkeypatch):
    from repro_torch.models import pipeline as pl
    real = pl.encode

    def altered(pipe, tokens):
        tokens = tokens.clone()
        tokens[:, 0] = (tokens[:, 0] + 1) % pipe.cfg.encoder.vocab_size
        return real(pipe, tokens)
    monkeypatch.setattr(pl, "encode", altered)
    out, _ = _run(smoke_cell("sd3", "sd3_saturated"), cpu)
    assert not out["correct"]


def test_a_call_that_raises_fails_its_requests(smoke_cell, cpu, monkeypatch):
    from servebench import program
    real = program.serve
    calls = []

    def flaky(*a, **kw):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("injected")
        return real(*a, **kw)
    monkeypatch.setattr(program, "serve", flaky)
    out, run = _run(smoke_cell("flux", "flux_hires"), cpu)
    assert out["failed"] > 0 and not out["correct"]
    assert sum(r.completion is None for r in run.requests) == out["failed"]


def test_a_stamp_before_the_device_finished_is_caught(smoke_cell, cpu, monkeypatch):
    from servebench import program
    real = program.serve

    def early(pcfg, reqs, *a, **kw):
        recs = real(pcfg, reqs, *a, **kw)
        for rec in recs:
            rec["stage_ms"]["D"] += 1e6          # the launch took longer than the call
        return recs
    monkeypatch.setattr(program, "serve", early)
    out, run = _run(smoke_cell("sd3", "sd3_saturated"), cpu)
    assert run.stamps_early > 0 and not out["correct"]


def test_latency_counts_from_the_due_time(smoke_cell, cpu):
    out, run = _run(smoke_cell("sd3", "sd3_saturated"), cpu)
    for r in run.completed:
        call = run.calls[r.call]
        assert call.start >= r.due - 1e-9
        assert call.start <= r.completion <= call.end + 1e-9
    assert out["metrics"] == {}
