"""The DDIM loop's two paths (``models/diffusion.ddim_denoise``): a step
replayed from a CUDA graph of ``ddim_step`` on a card, run eagerly
elsewhere.

On the CPU: the split-out step gives the former loop's latents bit for bit,
CPU, ``meta`` and DTensor parameters stay eager and make no graph cache,
each condition that keeps a step eager does so, the cache follows moved
weights, and a traced run's ``step`` spans say ``graphed=0``. The ``gpu``
tests hold the graphs to the eager steps on the card, bit for bit, and
check the cache, the shared pool and the memory given back:

  PYTHONPATH=src python -m pytest -m gpu tests/test_torch_diffusion_graph.py

The card's tests run a two-layer cut of sd3's DiT at full width: the SMOKE
config is float32 with heads of 32, which K1 does not take.
"""
import dataclasses
from types import SimpleNamespace

import pytest
import torch
import torch.distributed as dist
from torch import nn
from torch.profiler import ProfilerActivity, profile

import repro_torch.configs as TC
from repro_torch import trace
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import diffusion
from repro_torch.models import pipeline as tpl
from repro_torch.sharding import partition, spmd

COND_LEN = 77


def _old_loop(dit, noise, cond, num_steps):
    """``ddim_denoise`` as it was before the step was split out."""
    betas = diffusion.jax_linspace(1e-4, 0.02, 1000)
    alpha_bar = torch.cumprod(1.0 - betas, dim=0).to(noise.device)
    ts = diffusion.ddim_timesteps(num_steps)
    one = torch.ones((), dtype=torch.float32, device=noise.device)
    x = noise
    for i, t in enumerate(ts):
        t_next = ts[i + 1] if i + 1 < num_steps else -1
        ab_t = alpha_bar[t]
        ab_n = alpha_bar[t_next] if t_next >= 0 else one
        tb = torch.full((x.shape[0],), float(t), dtype=torch.float32, device=x.device)
        eps = dit(x, tb, cond)
        x0 = (x - torch.sqrt(1 - ab_t) * eps) / torch.sqrt(ab_t)
        x = torch.sqrt(ab_n) * x0 + torch.sqrt(1 - ab_n) * eps
    return x


def _fill_modulation(dit, seed):
    """AdaLN-Zero starts every block as the identity: give the modulation
    small values so that the blocks' work shows in the latents."""
    g = torch.Generator(device=dit.x_in.device).manual_seed(seed)
    with torch.no_grad():
        for w in [layer.mod for layer in dit.layers] + [dit.final_mod]:
            w.copy_(torch.randn(w.shape, generator=g, device=w.device) * 0.02)


def _dit(cfg, dev, seed=0):
    dit = diffusion.DiT(cfg, dev)
    dit.init_(torch.Generator(device=dev).manual_seed(seed))
    _fill_modulation(dit, seed + 1)
    return dit.eval()


def _inputs(cfg, dev, b, lx, seed=2):
    g = torch.Generator(device=dev).manual_seed(seed)
    noise = torch.randn((b, lx, cfg.latent_dim), generator=g, device=dev)
    cond = torch.randn((b, COND_LEN, cfg.cond_dim), generator=g, device=dev).to(cfg.dtype)
    return noise, cond


# --- CPU ---------------------------------------------------------------------

@pytest.mark.parametrize("pipeline", ["sd3", "flux"])
@pytest.mark.parametrize("b", [1, 2])
def test_step_body_gives_the_old_loop_bit_for_bit(pipeline, b):
    pcfg = TC.get_smoke(pipeline)
    dit = _dit(pcfg.dit, torch.device("cpu"))
    noise, cond = _inputs(pcfg.dit, torch.device("cpu"), b, pcfg.latent_tokens(64))
    keep = noise.clone()
    for steps in (1, pcfg.num_steps, 5):
        got = diffusion.ddim_denoise(dit, noise, cond, steps)
        assert got.dtype == torch.float32
        assert torch.equal(got, _old_loop(dit, noise, cond, steps)), steps
    assert torch.equal(noise, keep)                  # the caller's noise is never written
    assert dit.step_graphs is None


def test_meta_stays_eager():
    cfg = TC.get("sd3").dit
    dit = diffusion.DiT(cfg, "meta")
    noise = torch.empty((2, 1024, cfg.latent_dim), device="meta")
    cond = torch.empty((2, COND_LEN, cfg.cond_dim), dtype=cfg.dtype, device="meta")
    out = diffusion.ddim_denoise(dit, noise, cond, 3)
    assert out.is_meta and out.shape == noise.shape and out.dtype == torch.float32
    assert dit.step_graphs is None


@pytest.fixture
def world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            world_size=1, rank=0)
    try:
        yield mesh_lib.make_host_mesh(1, "cpu")
    finally:
        dist.destroy_process_group()


def test_dtensor_parameters_stay_eager(world_of_one):
    from torch.distributed.tensor.experimental import implicit_replication
    pcfg = TC.get_smoke("sd3")
    plain = _dit(pcfg.dit, torch.device("cpu"))
    dit = _dit(pcfg.dit, torch.device("cpu"))
    partition.distribute_model(dit, {n: partition.P() for n, _ in dit.named_parameters()},
                               world_of_one)
    assert all(spmd.is_dtensor(p) for p in dit.parameters())
    noise, cond = _inputs(pcfg.dit, torch.device("cpu"), 1, 16)
    with implicit_replication():
        got = diffusion.ddim_denoise(dit, noise, cond, 3)
        # a card's latents would not make it replay either: the parameters decide
        assert diffusion.step_graphs(dit, SimpleNamespace(is_cuda=True)) is None
    assert torch.equal(got, diffusion.ddim_denoise(plain, noise, cond, 3))
    assert dit.step_graphs is None


@pytest.fixture
def card_free(monkeypatch):
    """``step_graphs`` on the CPU with a stand-in for a card's latents: no
    capture under way and pool handles that need no card."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    handles = iter(range(1, 1000))
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, next(handles)))
    return SimpleNamespace(is_cuda=True)


@pytest.mark.parametrize("case", ["cpu latents", "grad on", "counter set", "capturing"])
def test_each_condition_keeps_the_step_eager(card_free, monkeypatch, case):
    dit = _dit(TC.get_smoke("sd3").dit, torch.device("cpu"))
    x = card_free
    with torch.no_grad():
        assert diffusion.step_graphs(dit, x) is not None
    dit.step_graphs = None
    grad = torch.no_grad()
    if case == "cpu latents":
        x = torch.zeros(1)
    elif case == "grad on":
        grad = torch.enable_grad()
    elif case == "counter set":
        monkeypatch.setattr(ops, "COUNTER", object())
    else:
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with grad:
        assert diffusion.step_graphs(dit, x) is None
    assert dit.step_graphs is None


def test_the_cache_follows_the_weights(card_free):
    dit = _dit(TC.get_smoke("sd3").dit, torch.device("cpu"))
    with torch.no_grad():
        first = diffusion.step_graphs(dit, card_free)
        assert first.ptrs == tuple(p.data_ptr() for p in dit.parameters())
        assert diffusion.step_graphs(dit, card_free) is first and dit.step_graphs is first
        dit.layers[1].wo.mul_(2.0)                  # in place: the graphs read it where it is
        assert diffusion.step_graphs(dit, card_free) is first
        dit.layers[1].wo = nn.Parameter(dit.layers[1].wo.clone())   # moved: the graphs go
        second = diffusion.step_graphs(dit, card_free)
    assert second is not first and dit.step_graphs is second
    assert second.ptrs == tuple(p.data_ptr() for p in dit.parameters())
    assert second.pool != first.pool and second.shapes == {}


def test_traced_cpu_steps_say_eager():
    pcfg = TC.get_smoke("sd3")
    dit = _dit(pcfg.dit, torch.device("cpu"))
    noise, cond = _inputs(pcfg.dit, torch.device("cpu"), 1, 16)
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        diffusion.ddim_denoise(dit, noise, cond, 4)
    steps = [s for s in trace.spans() if s.name == "step"]
    trace.clear()
    assert [s.attrs for s in steps] == [
        {"step": i, "t": t, "graphed": 0} for i, t in enumerate(diffusion.ddim_timesteps(4))]


# --- the card ------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; run on the card")
    return torch.device("cuda")


def _cut(layers=2):
    """sd3 at full width, ``layers`` deep: K1 takes its bf16 heads of 64."""
    full = TC.get("sd3")
    return dataclasses.replace(
        full, encoder=dataclasses.replace(full.encoder, num_layers=layers),
        dit=dataclasses.replace(full.dit, num_layers=layers))


def _eager(dit, noise, cond, num_steps):
    """``ddim_step`` called step by step, outside any graph."""
    betas = diffusion.jax_linspace(1e-4, 0.02, 1000)
    alpha_bar = torch.cumprod(1.0 - betas, dim=0).to(noise.device)
    ts = diffusion.ddim_timesteps(num_steps)
    one = torch.ones((), dtype=torch.float32, device=noise.device)
    x = noise.clone()
    with torch.no_grad():
        for i, t in enumerate(ts):
            ab_n = alpha_bar[ts[i + 1]] if i + 1 < num_steps else one
            tb = torch.full((x.shape[0],), float(t), dtype=torch.float32, device=x.device)
            diffusion.ddim_step(dit, x, tb, cond, alpha_bar[t], ab_n)
    return x


STEPS = 4


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("lx", [256, 1024])
def test_graphed_denoise_equals_eager_on_card(cuda, b, lx):
    cfg = _cut().dit
    dit = _dit(cfg, cuda)
    noise, cond = _inputs(cfg, cuda, b, lx)
    ops.reset_launches()
    want = _eager(dit, noise, cond, STEPS)
    eager_launches = dict(ops.LAUNCHES)
    ops.reset_launches()
    got = diffusion.ddim_denoise(dit, noise, cond, STEPS)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (got - want).abs().max().item()
    assert ops.LAUNCHES == eager_launches == {
        "flash_attention": cfg.num_layers * STEPS,
        "adaln_rmsnorm": (2 * cfg.num_layers + 1) * STEPS, "ssm_scan": 0}
    # no grid given: the uniform DiT reads none, and the key says so
    assert list(dit.step_graphs.shapes) == [((b, lx, cfg.latent_dim),
                                             (b, COND_LEN, cfg.cond_dim), cfg.dtype, None)]
    assert [len(cap.graphs) for cap in dit.step_graphs.shapes.values()] == [1]


@pytest.mark.gpu
def test_same_shape_captures_nothing_new_and_keeps_earlier_latents(cuda, monkeypatch):
    cfg = _cut().dit
    dit = _dit(cfg, cuda)
    noise, cond = _inputs(cfg, cuda, 1, 256)
    other, _ = _inputs(cfg, cuda, 1, 256, seed=5)
    first = diffusion.ddim_denoise(dit, noise, cond, STEPS)
    (cap,) = dit.step_graphs.shapes.values()
    made = []
    real = torch.cuda.CUDAGraph
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda *a, **k: made.append(a) or real(*a, **k))
    second = diffusion.ddim_denoise(dit, other, cond, STEPS)
    monkeypatch.undo()
    assert made == [] and list(dit.step_graphs.shapes.values()) == [cap]
    assert torch.equal(first, _eager(dit, noise, cond, STEPS))
    assert torch.equal(second, _eager(dit, other, cond, STEPS))


@pytest.mark.gpu
def test_a_new_shape_captures_one_graph_into_the_shared_pool(cuda):
    cfg = _cut().dit
    dit = _dit(cfg, cuda)
    for lx in (256, 1024):
        noise, cond = _inputs(cfg, cuda, 1, lx)
        diffusion.ddim_denoise(dit, noise, cond, 2)
    graphs = dit.step_graphs
    assert len(graphs.shapes) == 2
    assert {g.pool() for cap in graphs.shapes.values() for g in cap.graphs} == {graphs.pool}


@pytest.mark.gpu
def test_reassigned_weight_invalidates_the_graphs(cuda):
    cfg = _cut().dit
    dit = _dit(cfg, cuda)
    noise, cond = _inputs(cfg, cuda, 1, 256)
    before = diffusion.ddim_denoise(dit, noise, cond, STEPS)
    old = dit.step_graphs
    with torch.no_grad():
        dit.x_out = nn.Parameter(dit.x_out * 2.0, requires_grad=False)
    after = diffusion.ddim_denoise(dit, noise, cond, STEPS)
    assert dit.step_graphs is not old
    assert not torch.equal(after, before)
    assert torch.equal(after, _eager(dit, noise, cond, STEPS))


@pytest.mark.gpu
def test_deleting_the_pipeline_gives_its_graphs_memory_back(cuda):
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    pipe = tpl.build(_cut(), cuda, seed=0)
    toks = torch.zeros((1, COND_LEN), dtype=torch.long, device=cuda)
    for res in (256, 512):
        tpl.generate(pipe, toks, res, num_steps=2)
    assert len(pipe.dit.step_graphs.shapes) == 2
    torch.cuda.synchronize()
    grown = torch.cuda.memory_reserved()
    del pipe
    torch.cuda.empty_cache()
    back = torch.cuda.memory_reserved()
    assert back <= reserved + 64 * 2 ** 20, (reserved, grown, back)


@pytest.mark.gpu
def test_traced_steps_on_card_say_graphed(cuda):
    cfg = _cut().dit
    dit = _dit(cfg, cuda)
    noise, cond = _inputs(cfg, cuda, 1, 256)
    diffusion.ddim_denoise(dit, noise, cond, STEPS)            # captured untraced
    trace.clear()
    with profile(activities=[ProfilerActivity.CUDA]):
        diffusion.ddim_denoise(dit, noise, cond, STEPS)
        steps = [s for s in trace.spans() if s.name == "step"]
    trace.clear()
    assert [s.attrs["graphed"] for s in steps] == [1] * STEPS
    assert all(s.device_end_ns > s.device_start_ns for s in steps)
