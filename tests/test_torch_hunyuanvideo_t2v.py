"""HunyuanVideo T2V as released (``configs/hunyuanvideo_t2v.py``,
``models/mmdit.py``) against its plain reference,
``servebench/reference/hunyuanvideo_t2v.py`` (float32, nothing of the port).

On the CPU at SMOKE (2 dual + 2 single blocks, 4 heads of 32, RoPE axes
(8, 12, 12)), both in float32 to rtol 1e-4: the encoder (no final norm),
the token refiner, one dual-stream and one single-stream block, the whole
DiT on a non-square grid with f > 1, and ``generate``'s pixels. Five
plausible faults planted in the port must each miss that tolerance. The
step's two parts, their spans, the grid through ``diffuse`` and ``serve``,
the graphs' key holding the grid only for a DiT that reads it, and the
reference's ``PIPELINE_IDS`` left as they were. The ``gpu`` tests hold the
two graphs of a step to its eager parts on the card, bit for bit, at full
width (two blocks of each kind), and check that ``quickstart.warm``
leaves ``serve`` nothing to capture:

  PYTHONPATH=src python -m pytest -m gpu tests/test_torch_hunyuanvideo_t2v.py
"""
import dataclasses
import gc
import sys
import weakref
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

import repro_torch.configs as TC
from repro_torch import trace
from repro_torch.core.profiler import H100_SXM, Profiler
from repro_torch.kernels import ops
from repro_torch.launch import quickstart
from repro_torch.models import diffusion, mmdit
from repro_torch.models import pipeline as pl

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from servebench import weights as sb_weights  # noqa: E402
from servebench.reference import hunyuanvideo_t2v as ref  # noqa: E402

NAME = "hunyuanvideo-t2v"
RTOL = 1e-4
LC = 77
GRID = (3, 2, 5)                     # f > 1, h != w


def cfg_dict(pcfg) -> dict:
    """A configuration file's content for the port's PipelineConfig."""
    def section(dc):
        out = {}
        for f in dataclasses.fields(dc):
            v = getattr(dc, f.name)
            out[f.name] = (str(v).replace("torch.", "") if isinstance(v, torch.dtype)
                           else list(v) if isinstance(v, tuple) else v)
        return out
    return {"name": pcfg.name, "reference": "hunyuanvideo_t2v",
            "pipeline": {"num_steps": pcfg.num_steps, "max_cond_len": pcfg.max_cond_len,
                         "is_video": pcfg.is_video, "source": pcfg.source},
            "encoder": section(pcfg.encoder), "dit": section(pcfg.dit),
            "decoder": section(pcfg.decoder)}


def _weights(cfg: dict, seed: int, device="cpu") -> dict:
    """The benchmark's seeded weights, with every modulation bias drawn
    wide: each block's gates, shifts and scales then weigh at every t."""
    w = sb_weights.for_config(cfg, torch.device(device), seed)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    for name, p in w.items():
        if name.endswith("mod_b"):
            p.copy_(0.3 * torch.randn(p.shape, generator=g, device=device))
    return w


def _pipe(cfg: dict, w: dict) -> pl.Pipeline:
    pipe = pl.Pipeline(TC.get_smoke(NAME), "meta")
    pipe.load_state_dict(w, strict=True, assign=True)
    return pipe.eval()


@pytest.fixture(scope="module")
def smoke():
    cfg = cfg_dict(TC.get_smoke(NAME))
    cfg["pipeline"]["num_steps"] = TC.get(NAME).num_steps
    w = _weights(cfg, 20261)
    return cfg, w, _pipe(cfg, w)


def _close(got: torch.Tensor, want: torch.Tensor) -> None:
    torch.testing.assert_close(got, want, rtol=RTOL, atol=RTOL * float(want.abs().max()))


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _inputs(cfg, b=2, grid=GRID, seed=3):
    g = torch.Generator().manual_seed(seed)
    n = grid[0] * grid[1] * grid[2]
    tokens = torch.randint(0, cfg["encoder"]["vocab_size"], (b, LC), generator=g)
    noise = torch.randn((b, n, cfg["dit"]["latent_dim"]), generator=g)
    return tokens, noise


# --- the configuration ---------------------------------------------------------

def test_config_is_the_release_and_smoke_its_cut():
    full, smoke = TC.get(NAME), TC.get_smoke(NAME)
    dit = full.dit
    assert (dit.num_layers, dit.double_layers, dit.d_model, dit.num_heads, dit.d_ff) == \
        (60, 20, 3072, 24, 12288)
    assert (dit.rope_axes, dit.rope_theta, dit.refiner_layers, dit.guidance) == \
        ((16, 56, 56), 256.0, 2, 6.0)
    enc = full.encoder
    assert (enc.num_layers, enc.num_heads, enc.num_kv_heads, enc.final_norm) == (30, 32, 8, False)
    assert full.num_steps == 6 and full.is_video and full.decoder.name == "ae-kl-hyv"
    assert (smoke.dit.double_layers, smoke.dit.num_layers - smoke.dit.double_layers,
            smoke.dit.num_heads, smoke.dit.d_model // smoke.dit.num_heads,
            smoke.dit.rope_axes) == (2, 2, 4, 32, (8, 12, 12))
    pipe = pl.Pipeline(full, "meta")
    assert isinstance(pipe.dit, mmdit.MMDiT)
    count = {n: sum(p.numel() for p in m.parameters()) / 1e9
             for n, m in (("E", pipe.encoder), ("D", pipe.dit), ("C", pipe.decoder))}
    assert count["E"] == pytest.approx(7.07, abs=0.005)
    assert count["D"] == pytest.approx(12.81, abs=0.005)
    assert sum(count.values()) == pytest.approx(19.88, abs=0.005)
    # the profiler prices the DiT the pipeline builds, and one chip holds it
    prof = Profiler(full, hw=H100_SXM)
    assert prof.info["D"].params == sum(p.numel() for p in pipe.dit.parameters())
    assert prof.k_min == 1


def test_a_list_from_a_file_is_a_tuple():
    dit = dataclasses.replace(TC.get(NAME).dit, rope_axes=[16, 56, 56])
    assert dit.rope_axes == (16, 56, 56) and dit == TC.get(NAME).dit
    hash(dit)


def test_pipeline_ids_and_the_reference_parity_configs_are_unchanged():
    assert TC.PIPELINE_IDS == ("sd3", "flux", "cogvideox", "hunyuanvideo")
    assert NAME not in TC.PIPELINE_IDS and NAME not in TC.ARCH_IDS
    for name in TC.PIPELINE_IDS:
        for cfg in (TC.get(name), TC.get_smoke(name)):
            assert (cfg.dit.double_layers, cfg.dit.rope_axes, cfg.dit.refiner_layers,
                    cfg.dit.guidance, cfg.encoder.final_norm) == (0, (), 0, 0.0, True)
            assert pl.dit_class(cfg.dit) is diffusion.DiT
    assert TC.get("hunyuanvideo").dit.num_layers == 64


# --- parity at SMOKE -------------------------------------------------------------

def test_encoder_stops_before_the_final_norm(smoke):
    cfg, w, pipe = smoke
    tokens, _ = _inputs(cfg)
    got = pl.encode(pipe, tokens)
    with ref.plain_math():
        want = ref.encode(w, cfg, tokens)
        normed = ref.encode(w, dict(cfg, encoder=dict(cfg["encoder"], final_norm=True)), tokens)
    _close(got, want)
    assert _gap(normed, want) > 10 * RTOL


def test_refiner(smoke):
    cfg, w, pipe = smoke
    tokens, _ = _inputs(cfg)
    cond = pl.encode(pipe, tokens)
    t = torch.tensor([999.0, 250.0])
    temb = diffusion.timestep_embedding(t, cfg["dit"]["time_embed_dim"])
    with ref.plain_math():
        want = ref.refiner(w, cfg, cond, ref.timestep_embedding(t, 256), False)
    _close(pipe.dit.txt_in(cond, temb), want)


def _block_inputs(cfg, w, grid=GRID):
    """(img, txt, SiLU(vec)) entering a block: the streams drawn at random."""
    g = torch.Generator().manual_seed(11)
    d = cfg["dit"]["d_model"]
    img = torch.randn((2, grid[0] * grid[1] * grid[2], d), generator=g)
    txt = torch.randn((2, LC, d), generator=g)
    with ref.plain_math():
        va = ref.vec_act(w, cfg, torch.tensor([700.0, 100.0]))
    return img, txt, va


def _tables(cfg, grid=GRID):
    dit = cfg["dit"]
    return (mmdit.rope_table(grid, tuple(dit["rope_axes"]), dit["rope_theta"]),
            ref.rope3d_cos_sin(grid, dit["rope_axes"], dit["rope_theta"], "cpu"))


def test_rope_table_is_the_adjacent_pairs_cos_and_sin(smoke):
    cfg, _, _ = smoke
    table, (cos, sin) = _tables(cfg)
    assert table.shape == (30, 16) and table.dtype == torch.complex64
    torch.testing.assert_close(table.real.repeat_interleave(2, dim=1), cos)
    torch.testing.assert_close(table.imag.repeat_interleave(2, dim=1), sin)
    # t-major: token (f, h, w) = (1, 0, 0) is row h * w = 10, at angle 1 on the t axis' first pair
    assert float(torch.angle(table[10, 0])) == pytest.approx(1.0)
    assert float(table[10, 4:].imag.abs().max()) == 0.0


def test_one_dual_block(smoke):
    cfg, w, pipe = smoke
    img, txt, va = _block_inputs(cfg, w)
    table, (cos, sin) = _tables(cfg)
    with torch.no_grad():
        got = pipe.dit.dual[1](img, txt, va, table)
    with ref.plain_math():
        want = ref.dual_block(w, cfg, 1, img, txt, va, cos, sin)
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_one_single_block(smoke):
    cfg, w, pipe = smoke
    img, txt, va = _block_inputs(cfg, w)
    x = torch.cat([img, txt], dim=1)
    table, (cos, sin) = _tables(cfg)
    with torch.no_grad():
        got = pipe.dit.single[0](x, va, table)
    with ref.plain_math():
        want = ref.single_block(w, cfg, 0, x, va, cos, sin)
    _close(got, want)


def _dit_pair(cfg, w, pipe, grid=GRID):
    tokens, noise = _inputs(cfg, grid=grid)
    cond = pl.encode(pipe, tokens)
    t = torch.tensor([999.0, 333.0])
    with torch.no_grad():
        got = pipe.dit(noise, t, cond, grid=grid)
    with ref.plain_math():
        want = ref.dit_forward(w, cfg, noise.reshape(2, *grid, -1), t, cond)
    return got, want.reshape(got.shape)


@pytest.mark.parametrize("grid", [GRID, (1, 4, 4)])
def test_whole_dit_on_a_grid(smoke, grid):
    cfg, w, pipe = smoke
    got, want = _dit_pair(cfg, w, pipe, grid)
    _close(got, want)


def test_generate_pixel_gap(smoke):
    cfg, w, pipe = smoke
    res, sec = 64, 0.5                      # a (2, 4, 4) grid at SMOKE
    grid = TC.get_smoke(NAME).latent_grid(res, sec)
    tokens, noise = _inputs(cfg, b=1, grid=grid)
    cond = pl.encode(pipe, tokens)
    lat = pl.diffuse(pipe, cond, noise.shape, num_steps=6, noise=noise, grid=grid)
    out = pl.decode(pipe, lat, grid)
    want = ref.generate(w, cfg, tokens, noise, res, sec)
    assert out.shape == want.shape == (grid[0], 64, 64, 3)
    assert ref.pixel_gap(out, want) < 1e-4
    assert float(want.std()) > 0.01


# --- negative controls: each fault misses the tolerance ---------------------------

def _half_split(x, table):
    n, h = table.shape[0], x.shape[-1] // 2
    c, s = table.real[:, None], table.imag[:, None]
    x1, x2 = x[:, :n, :, :h].clone(), x[:, :n, :, h:].clone()
    x[:, :n, :, :h] = x1 * c - x2 * s
    x[:, :n, :, h:] = x2 * c + x1 * s
    return x


FAULTS = {
    "rope pairs split in halves": ("rope_rows", _half_split),
    "rope on the text rows": ("rope_rows", lambda x, table, real=mmdit.rope_rows: real(
        x, table[torch.arange(x.shape[1]) % table.shape[0]])),
    "qk-norm left out": ("qk_norm", lambda x, w, eps: x.float().clone()),
    "rmsnorm for layernorm": ("layer_norm", lambda x, eps: F.rms_norm(x, (x.shape[-1],),
                                                                       eps=eps)),
    "text stream on the video weights": (None, None),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_fault_misses_the_tolerance(smoke, fault, monkeypatch):
    cfg, w, pipe = smoke
    attr, fake = FAULTS[fault]
    if attr is not None:
        monkeypatch.setattr(mmdit, attr, fake)
    else:
        shared = {n.replace(".img.", ".txt."): p for n, p in w.items()
                  if ".dual." in n and ".img." in n}
        pipe = _pipe(cfg, {**w, **shared})
    got, want = _dit_pair(cfg, w, pipe)
    assert _gap(got, want) > 10 * RTOL, fault


# --- the step's parts, spans and the grid through the stages ----------------------

def test_the_step_parts_give_forward_bit_for_bit(smoke):
    cfg, _, pipe = smoke
    tokens, noise = _inputs(cfg)
    cond = pl.encode(pipe, tokens)
    got = diffusion.ddim_denoise(pipe.dit, noise, cond, 3, GRID)
    alpha_bar = torch.cumprod(1.0 - diffusion.jax_linspace(1e-4, 0.02, 1000), dim=0)
    ts = diffusion.ddim_timesteps(3)
    x = noise.clone()
    with torch.no_grad():
        for i, t in enumerate(ts):
            ab_n = alpha_bar[ts[i + 1]] if i + 1 < 3 else torch.ones(())
            eps = pipe.dit(x, torch.full((2,), float(t)), cond, grid=GRID)
            x0 = (x - torch.sqrt(1 - alpha_bar[t]) * eps) / torch.sqrt(alpha_bar[t])
            x = torch.sqrt(ab_n) * x0 + torch.sqrt(1 - ab_n) * eps
    assert torch.equal(got, x)
    parts = pipe.dit.step_parts(x, torch.zeros(2), cond, alpha_bar[0], alpha_bar[1],
                                pipe.dit.grid_inputs(GRID), {})
    assert [(p.span, p.attrs) for p in parts] == [
        ("double", {"tokens": 30 + LC, "blocks": 2}), ("single", {"tokens": 30 + LC, "blocks": 2})]


def test_the_dit_needs_the_grid(smoke):
    cfg, _, pipe = smoke
    tokens, noise = _inputs(cfg)
    cond = pl.encode(pipe, tokens)
    with pytest.raises(ValueError, match="grid"):
        pl.diffuse(pipe, cond, noise.shape, noise=noise, num_steps=1)


def test_traced_cpu_steps_hold_double_and_single_spans(smoke):
    cfg, _, pipe = smoke
    tokens, noise = _inputs(cfg)
    cond = pl.encode(pipe, tokens)
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        diffusion.ddim_denoise(pipe.dit, noise, cond, 2, GRID)
    found = trace.spans()
    trace.clear()
    steps = [s for s in found if s.name == "step"]
    assert [s.attrs for s in steps] == [{"step": 0, "t": 999, "graphed": 0},
                                        {"step": 1, "t": 0, "graphed": 0}]
    for s in steps:
        kids = [c for c in found if c.parent == s.id]
        assert [(c.name, c.attrs) for c in kids] == [
            ("double", {"tokens": 30 + LC, "blocks": 2}),
            ("single", {"tokens": 30 + LC, "blocks": 2})]
        assert s.host_start_ns <= kids[0].host_start_ns <= kids[1].host_end_ns <= s.host_end_ns


def test_serve_carries_the_grid_on_the_cpu():
    cfg = TC.get_smoke(NAME)
    pipe = pl.build(cfg, "cpu", seed=0)
    classes = quickstart.smoke_requests(NAME)
    assert classes == ((67, 0.5),)
    from repro_torch.core.request import Request
    recs = quickstart.serve(cfg, [Request(cfg.name, r, s) for r, s in classes], device="cpu",
                            pipe=pipe, num_steps=2)
    grid = cfg.latent_grid(*classes[0])
    assert grid == (2, 4, 4)
    assert tuple(recs[0]["output"].shape) == (2, 64, 64, 3)
    assert recs[0]["num_steps"] == 2


@pytest.mark.parametrize("name", [NAME, "sd3", "flux"])
def test_the_graph_key_holds_the_grid_only_where_the_dit_reads_it(name):
    """One captured step serves a shape on every grid where the DiT's
    positions are 1D, whether or not the caller names the grid."""
    cfg = TC.get_smoke(name).dit
    dit = pl.dit_class(cfg)(cfg, "meta")
    noise = torch.empty((1, 30, cfg.latent_dim), device="meta")
    cond = torch.empty((1, LC, cfg.cond_dim), dtype=cfg.dtype, device="meta")
    shapes = ((1, 30, cfg.latent_dim), (1, LC, cfg.cond_dim), cfg.dtype)
    grids = (GRID, [3, 5, 2], (1, 5, 6))
    keys = [diffusion.graph_key(dit, noise, cond, g) for g in grids]
    if name == NAME:
        assert keys == [shapes + (tuple(g),) for g in grids]
    else:
        assert keys == [diffusion.graph_key(dit, noise, cond)] * 3 == [shapes + (None,)] * 3


# --- the card ------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; run on the card")
    return torch.device("cuda")


def _card_cut():
    """The release at full width, two blocks of each kind and two encoder layers."""
    full = TC.get(NAME)
    return dataclasses.replace(full, encoder=dataclasses.replace(full.encoder, num_layers=2),
                               dit=dataclasses.replace(full.dit, num_layers=4, double_layers=2))


def _card_dit(cuda):
    cfg = cfg_dict(_card_cut())
    w = sb_weights.for_config(cfg, cuda, 7)
    pipe = pl.Pipeline(_card_cut(), "meta")
    pipe.load_state_dict(w, strict=True, assign=True)
    return pipe.eval()


def _card_inputs(pipe, cuda, grid, b=1):
    g = torch.Generator(device=cuda).manual_seed(5)
    n = grid[0] * grid[1] * grid[2]
    noise = torch.randn((b, n, 64), generator=g, device=cuda)
    tokens = torch.randint(0, 1000, (b, LC), generator=g, device=cuda)
    return noise, pl.encode(pipe, tokens)


def _eager(dit, noise, cond, steps, grid):
    alpha_bar = torch.cumprod(1.0 - diffusion.jax_linspace(1e-4, 0.02, 1000), 0).to(noise.device)
    ts = diffusion.ddim_timesteps(steps)
    one = torch.ones((), dtype=torch.float32, device=noise.device)
    extra = dit.grid_inputs(grid, noise.device)
    x = noise.clone()
    with torch.no_grad():
        for i, t in enumerate(ts):
            ab_n = alpha_bar[ts[i + 1]] if i + 1 < steps else one
            tb = torch.full((x.shape[0],), float(t), dtype=torch.float32, device=x.device)
            diffusion.ddim_step(dit, x, tb, cond, alpha_bar[t], ab_n, extra)
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("grid", [(2, 8, 8), (1, 33, 33)])
def test_graphed_parts_equal_the_eager_step_on_card(cuda, grid):
    pipe = _card_dit(cuda)
    noise, cond = _card_inputs(pipe, cuda, grid)
    ops.reset_launches()
    want = _eager(pipe.dit, noise, cond, 3, grid)
    eager = dict(ops.LAUNCHES)
    ops.reset_launches()
    got = diffusion.ddim_denoise(pipe.dit, noise, cond, 3, grid)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (got - want).abs().max().item()
    assert ops.LAUNCHES == eager == {"flash_attention": 3 * (4 + 2), "adaln_rmsnorm": 0,
                                     "ssm_scan": 0}
    (key,) = pipe.dit.step_graphs.shapes
    assert key == (tuple(noise.shape), tuple(cond.shape), cond.dtype, grid)
    assert len(pipe.dit.step_graphs.shapes[key].graphs) == 2
    # a second grid of as many tokens is a graph of its own, and its answer differs
    other = (grid[0], grid[2], grid[1]) if grid[1] != grid[2] else (grid[0] * grid[1], 1, grid[2])
    again = diffusion.ddim_denoise(pipe.dit, noise, cond, 3, other)
    assert len(pipe.dit.step_graphs.shapes) == 2 and not torch.equal(again, got)
    assert torch.equal(again, _eager(pipe.dit, noise, cond, 3, other))


@pytest.mark.gpu
def test_traced_steps_on_card_time_each_part(cuda):
    pipe = _card_dit(cuda)
    grid = (2, 8, 8)
    noise, cond = _card_inputs(pipe, cuda, grid)
    diffusion.ddim_denoise(pipe.dit, noise, cond, 2, grid)          # captured untraced
    trace.clear()
    with profile(activities=[ProfilerActivity.CUDA]):
        diffusion.ddim_denoise(pipe.dit, noise, cond, 2, grid)
        found = trace.spans()
    trace.clear()
    steps = [s for s in found if s.name == "step"]
    assert [s.attrs["graphed"] for s in steps] == [1, 1]
    for s in steps:
        kids = [c for c in found if c.parent == s.id]
        assert [c.name for c in kids] == ["double", "single"]
        assert all(c.device_end_ns > c.device_start_ns for c in kids)
        assert s.device_start_ns <= kids[0].device_start_ns
        assert kids[0].device_end_ns <= kids[1].device_start_ns
        assert kids[1].device_end_ns <= s.device_end_ns


@pytest.mark.gpu
@pytest.mark.parametrize("name", [NAME, "sd3"])
def test_deleting_the_pipeline_frees_its_dit_without_the_collector(cuda, name):
    """The captured steps hold the DiT's buffers, never the DiT: no cycle
    keeps its weights and its graphs' pool after the pipeline goes."""
    if name == NAME:
        pipe, grid = _card_dit(cuda), (2, 8, 8)
    else:
        full = TC.get(name)
        pipe = pl.build(dataclasses.replace(full, dit=dataclasses.replace(full.dit, num_layers=2),
                                            encoder=dataclasses.replace(full.encoder,
                                                                        num_layers=2)),
                        cuda, seed=0)
        grid = (1, 16, 16)
    noise, cond = _card_inputs(pipe, cuda, grid) if name == NAME else (
        torch.randn((1, 256, pipe.cfg.dit.latent_dim), device=cuda),
        torch.zeros((1, LC, pipe.cfg.dit.cond_dim), dtype=pipe.cfg.dit.dtype, device=cuda))
    diffusion.ddim_denoise(pipe.dit, noise, cond, 2, grid)
    assert len(pipe.dit.step_graphs.shapes) == 1
    dit = weakref.ref(pipe.dit)
    gc.disable()
    try:
        del pipe
        assert dit() is None
    finally:
        gc.enable()


@pytest.mark.gpu
@pytest.mark.parametrize("name", [NAME, "sd3"])
def test_warm_then_serve_captures_nothing_new(cuda, name, monkeypatch):
    """``quickstart.warm`` captures the step graphs that ``serve`` then
    replays: the first served request of a shape pays no capture."""
    from repro_torch.core.request import Request
    if name == NAME:
        pipe, cls = _card_dit(cuda), (540, 1.0)
    else:
        full = TC.get(name)
        pipe = pl.build(dataclasses.replace(full, dit=dataclasses.replace(full.dit, num_layers=2),
                                            encoder=dataclasses.replace(full.encoder,
                                                                        num_layers=2)),
                        cuda, seed=0)
        cls = (256, 0.0)
    reqs = [Request(pipe.cfg.name, *cls)]
    quickstart.warm(pipe, reqs)
    keys = list(pipe.dit.step_graphs.shapes)
    made = []
    real = torch.cuda.CUDAGraph
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda *a, **k: made.append(a) or real(*a, **k))
    recs = quickstart.serve(pipe.cfg, reqs, device=cuda, pipe=pipe, num_steps=2)
    monkeypatch.undo()
    assert recs[0]["num_steps"] == 2
    assert made == [] and list(pipe.dit.step_graphs.shapes) == keys and len(keys) == 1
