"""HunyuanVideo T2V's configuration file, plain reference, new readers and
check, on the CPU: the file is the port's configuration, the reference's
parameters are the pipeline's, the reference matches the port at the
SMOKE sizes, the K1 reader counts every call at its own cost, the
``double`` and ``single`` readers read the steps' parts, and a whole run
of the cell at SMOKE sizes is correct, then not for float8 in the steps
after the first, a step left out and a step stuck."""
import copy
import dataclasses
import json
import time

import pytest
import torch

import test_servebench_spans as synthetic
from conftest import ROOT, smoke_mix
from servebench import harness, program, spans, weights
from servebench.cost import arith
from servebench.reference import hunyuanvideo_t2v as ref

NAME = "hunyuanvideo-t2v"
CELL = "hunyuanvideo-t2v.video"
MS = synthetic.MS


def _file() -> dict:
    return json.loads((ROOT / "servebench" / "configs" / f"{NAME}.json").read_text())


def _smoke_file(dtype: str = "float32") -> dict:
    """The configuration file at the port's SMOKE widths and depths, with
    the full configuration's steps and limit."""
    import repro_torch.configs as C
    pcfg, full = C.get_smoke(NAME), _file()
    out = json.loads(json.dumps(full))
    for part in ("encoder", "dit", "decoder"):
        dc = getattr(pcfg, part)
        for k in out[part]:
            v = getattr(dc, k)
            out[part][k] = list(v) if isinstance(v, tuple) else v
        out[part]["dtype"] = dtype
    out["name"], out["pipeline"]["source"] = pcfg.name, pcfg.source
    return out


def _smoke_cell(dtype: str = "float32") -> dict:
    return {"name": f"{NAME}.smoke", "chips": 1, "cfg": _smoke_file(dtype),
            "mix": smoke_mix("hunyuanvideo_t2v_video"), "end_to_end": [], "per_layer": []}


def test_config_file_is_the_ports_config():
    import repro_torch.configs as C
    cfg = _file()
    assert program.config(cfg) == C.get(NAME)
    assert cfg["reference"] == "hunyuanvideo_t2v"
    smoke = program.config(_smoke_file())
    assert dataclasses.replace(smoke, num_steps=2) == C.get_smoke(NAME)


def test_param_specs_are_the_pipelines_parameters():
    from repro_torch.models import pipeline as pl
    cfg = _file()
    pipe = pl.Pipeline(program.config(cfg), "meta")
    want = {n: (tuple(p.shape), p.dtype) for n, p in pipe.named_parameters()}
    got = {n: (tuple(s), getattr(torch, dt)) for n, s, dt, *_ in ref.param_specs(cfg)}
    assert got == want
    assert len(ref.param_specs(cfg)) == len(want)
    params = sum(p.numel() for p in pipe.parameters()) / 1e9
    assert params == pytest.approx(cfg["params_b"], abs=0.005)


def test_reference_matches_the_port_on_cpu(cpu):
    from repro_torch.models import pipeline as pl
    cfg = _smoke_file()
    w = weights.for_config(cfg, cpu, 2 ** 31 + 77)
    pipe = program.pipeline(program.config(cfg), w)
    res, sec = 90, 1.0                               # 720 px x 1 s at an eighth of the side
    grid = program.config(cfg).latent_grid(res, sec)
    assert grid == (4, 5, 5)
    tokens = torch.randint(0, cfg["encoder"]["vocab_size"], (1, 77))
    noise = torch.randn((1, 100, cfg["dit"]["latent_dim"]))
    cond = pl.encode(pipe, tokens)
    out = pl.decode(pipe, pl.diffuse(pipe, cond, noise.shape, noise=noise, grid=grid), grid)
    want = ref.generate(w, cfg, tokens, noise, res, sec)
    assert out.shape == want.shape == (4, 80, 80, 3)
    assert ref.pixel_gap(out, want) < 1e-4
    # the control reads far above the sound program
    assert ref.pixel_gap(ref.generate(w, cfg, tokens, noise, res, sec, fp8=True), want) > 0.05


# --- K1's reader --------------------------------------------------------------------

def _launch(k: int, latent: int, steps: int = 6):
    from servebench import window
    return window.Launch([k], 540, 1.0, steps, {"E": 1.0, "D": 1.0, "C": 1.0}, latent, 77)


def _k1_run(calls: int, k1_s: float):
    from servebench import window
    run = window.Run(cfg=_file(), mix={}, seconds=1.0)
    run.launches = [_launch(0, 4356), _launch(1, 8712)]
    run.trace = {"k1_calls": calls, "k1_s": k1_s}
    return run


def _k1_bound() -> float:
    """By hand: 60 joint calls and 2 refiner calls a step at (24, 128), 30
    causal encoder calls at (32, 128) a launch, each at its own bound."""
    total = 0.0
    for latent in (4356, 8712):
        l = latent + 77
        joint = max(4 * l * l * 24 * 128 / 989e12, 2 * 4 * l * 24 * 128 / 3.35e12)
        refine = max(4 * 77 * 77 * 24 * 128 / 989e12, 2 * 4 * 77 * 24 * 128 / 3.35e12)
        enc = max(4 * (77 * 78 // 2) * 32 * 128 / 989e12, 2 * 4 * 77 * 32 * 128 / 3.35e12)
        total += 6 * (60 * joint + 2 * refine) + 30 * enc
    return total


def test_k1_reader_counts_every_call_at_its_own_cost():
    read = harness.reader("k1_roofline_pct.video")
    calls = 2 * (6 * 62 + 30)
    bound = _k1_bound()
    assert read(_k1_run(calls, 2 * bound)) == pytest.approx(50.0)
    assert read(_k1_run(calls, bound)) == pytest.approx(100.0)
    for wrong in (calls - 1, calls + 1, 2 * 6 * 60):
        assert read(_k1_run(wrong, 2 * bound)) is None
    assert read(_k1_run(calls, 0.0)) is None
    run = _k1_run(calls, 2 * bound)
    run.trace = None
    assert read(run) is None
    # the uniform DiT's reader counts layers x steps only, and reads nothing here
    assert harness.reader("k1_roofline_pct")(_k1_run(calls, 2 * bound)) is None


def test_the_causal_cost_counts_the_kept_pairs():
    from repro_torch.kernels import flash_attention as fa
    read = harness.reader("k1_roofline_pct.video")
    causal_cost = read.__globals__["causal_cost"]
    for b, l, h, d in ((1, 77, 32, 128), (2, 100, 8, 64)):
        q = torch.empty((b, l, h, d), dtype=torch.bfloat16, device="meta")
        assert causal_cost(b, l, h, d) == fa.cost(q, q, q, causal=True)
    assert arith.k1_cost(1, 77, 77, 24, 128) == fa.cost(
        torch.empty((1, 77, 24, 128), dtype=torch.bfloat16, device="meta"),
        torch.empty((1, 77, 24, 128), dtype=torch.bfloat16, device="meta"),
        torch.empty((1, 77, 24, 128), dtype=torch.bfloat16, device="meta"), causal=False)


# --- the parts' readers ---------------------------------------------------------------

def _with_parts(drop=()):
    """The synthetic spans, each step holding a ``double`` and a ``single``
    span: step 0 (31-50 ms on the device) 12 + 6 ms, step 1 (50-70) 13 + 6."""
    out = synthetic._spans()
    sid = 1000
    for s in [s for s in out if s.name == "step"]:
        lo = s.device_start_ns
        split = lo + (12 if s.attrs["step"] == 0 else 13) * MS
        for name, a, b in (("double", lo, split), ("single", split, split + 6 * MS)):
            if (s.id, name) in drop:
                continue
            out.append(synthetic._sp(sid, name, s.id, s.host_start_ns, s.host_end_ns, a, b,
                                     blocks=2, tokens=1101))
            sid += 1
    return out


@pytest.mark.parametrize("name,want", [("double_ms_per_step.video", 12.5),
                                       ("single_ms_per_step.video", 6.0)])
def test_the_parts_readers(monkeypatch, name, want):
    box = {"spans": _with_parts()}
    monkeypatch.setattr(spans, "recorded", lambda: box["spans"])
    read = harness.reader(name)
    assert read(synthetic._run()) == pytest.approx(want)
    box["spans"] = _with_parts(drop={(106, name.split("_")[0])})
    assert read(synthetic._run()) is None
    box["spans"] = synthetic._spans()                # a port that records no parts
    assert read(synthetic._run()) is None


def test_the_host_lead_reads_the_steps_around_their_parts(monkeypatch):
    monkeypatch.setattr(spans, "recorded", _with_parts)
    lead = harness.reader("dit_host_lead_ms.video")(synthetic._run())
    monkeypatch.setattr(spans, "recorded", synthetic._spans)
    assert lead is not None
    assert lead == harness.reader("dit_host_lead_ms.tput")(synthetic._run())


def test_the_entries_in_benchmark_json():
    bench = harness.load_benchmark()
    (conf,) = [c for c in bench["configs"] if c["name"] == NAME]
    assert conf["file"] == f"servebench/configs/{NAME}.json" and conf["reduced"] == []
    (cell,) = [w for w in bench["workloads"] if w["name"] == CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (NAME, "hunyuanvideo_t2v_video", 1)
    c = harness.cell(bench, CELL)
    assert [m["name"] for m in c["end_to_end"]] == ["throughput_mpx_s", "setup_s"]
    mine = [m for m in c["per_layer"]]
    assert [m["name"] for m in mine] == [
        "dit_ms_per_step.video", "double_ms_per_step.video", "single_ms_per_step.video",
        "k1_roofline_pct.video", "mfu_pct.video", "device_idle_pct.video", "encode_ms.video",
        "decode_ms.video", "dit_graph_share.video", "dit_host_lead_ms.video"]
    assert all(m["moves"] == "throughput_mpx_s" and m["workloads"] == [CELL] for m in mine)
    for m in mine:
        harness.reader(m["name"])
    mix = c["mix"]
    assert mix["kind"] == "closed" and mix["clients"] == 4
    assert [(k["resolution"], k["seconds"], k["weight"]) for k in mix["classes"]] == \
        [(540, 1, 3), (720, 1, 3), (540, 2, 1)]
    tokens = [program.config(_file()).latent_tokens(k["resolution"], k["seconds"]) + 77
              for k in mix["classes"]]
    assert tokens == [4433, 8177, 8789]


# --- whole runs at SMOKE sizes ----------------------------------------------------------

def _run(cell, cpu, seconds=4.0):
    return harness.run(cell, 2 ** 31 + 303, seconds, False, cpu, time.perf_counter())


@pytest.fixture
def bf16_cell():
    """The cell in bfloat16, as served, held to the configuration's limit."""
    return _smoke_cell("bfloat16")


def test_sound_runs_are_correct(cpu, bf16_cell):
    out, run = _run(_smoke_cell(), cpu)
    assert out["correct"], out["compared"]
    assert out["compared"]["pixel_gap"]["value"] < 1e-4
    assert out["attempted"] == len(run.requests) > 0 and out["failed"] == 0
    assert {la.resolution for la in run.launches} <= {67, 90}
    out, _ = _run(bf16_cell, cpu)
    assert out["correct"], out["compared"]


def _grid_box(monkeypatch):
    """Keeps the grid each Diffuse is given."""
    from repro_torch.models import pipeline as pl
    real, box = pl.diffuse, {}

    def keep(*a, grid=None, **kw):
        box["grid"] = grid
        return real(*a, grid=grid, **kw)
    monkeypatch.setattr(pl, "diffuse", keep)
    return box


def test_a_denoising_step_left_out_is_caught(cpu, bf16_cell, monkeypatch):
    from repro_torch.models import pipeline as pl
    real = pl.diffuse

    def short(pipe, cond, shape, generator=None, num_steps=None, noise=None, grid=None):
        return real(pipe, cond, shape, generator, (num_steps or pipe.cfg.num_steps) - 1, noise,
                    grid)
    monkeypatch.setattr(pl, "diffuse", short)
    out, run = _run(bf16_cell, cpu)
    assert out["failed"] == 0 and not out["correct"], out["compared"]


def test_the_middle_step_stuck_is_caught(cpu, bf16_cell, monkeypatch):
    """The middle DDIM step hands its latents on unchanged."""
    from repro_torch.models import diffusion
    ts = diffusion.ddim_timesteps(bf16_cell["cfg"]["pipeline"]["num_steps"])
    ab = torch.cumprod(1.0 - diffusion.jax_linspace(1e-4, 0.02, 1000), 0)
    mid = float(ab[ts[len(ts) // 2]])
    real = diffusion.ddim_update

    def stuck(x, eps, ab_t, ab_n):
        if float(ab_t) != mid:
            real(x, eps, ab_t, ab_n)
    monkeypatch.setattr(diffusion, "ddim_update", stuck)
    out, _ = _run(bf16_cell, cpu)
    assert out["failed"] == 0 and not out["correct"], out["compared"]


def test_steps_after_the_first_in_float8_are_caught(cpu, bf16_cell, monkeypatch):
    """Every step but the first predicted by the reference with float8
    e4m3 products, in the program's place."""
    from repro_torch.models import diffusion, mmdit
    box = _grid_box(monkeypatch)
    real = mmdit.MMDiT.step_parts
    cfg = bf16_cell["cfg"]

    def fp8(self, x, tb, cond, ab_t, ab_n, extra, carry):
        if float(tb[0]) == 999.0:
            return real(self, x, tb, cond, ab_t, ab_n, extra, carry)

        def run():
            w = {f"dit.{n}": p for n, p in self.named_parameters()}
            lat = x.reshape(x.shape[0], *box["grid"], x.shape[-1])
            eps = ref.dit_forward(w, cfg, lat, tb, cond.float(), fp8=True).reshape(x.shape)
            diffusion.ddim_update(x, eps, ab_t, ab_n)
        return [diffusion.Part(None, {}, run)]
    monkeypatch.setattr(mmdit.MMDiT, "step_parts", fp8)
    out, _ = _run(copy.deepcopy(bf16_cell), cpu)
    assert out["failed"] == 0 and not out["correct"], out["compared"]
