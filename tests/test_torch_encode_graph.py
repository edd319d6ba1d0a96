"""Encode's two paths (``models/pipeline.encode``): a replay of one CUDA
graph a prompt shape on a card (``pipeline.EncodeGraphs``, held by the
``Pipeline``), the encoder's pass run eagerly elsewhere.

On the CPU: the eager pass gives the former ``encode``'s states bit for bit,
CPU, ``meta`` and DTensor parameters make no graph cache, each condition
that keeps Encode eager does so (one predicate, ``graphs.replay_ptrs``,
decides for Encode and the DDIM steps alike), the cache follows moved
weights, and traced encodes say ``graphed=0``. The ``gpu`` tests hold the
replays to the eager pass on the card, bit for bit, for full-width cuts of
sd3's T5-width encoder and hunyuanvideo-t2v's causal GQA encoder, and check
the cache, the launch counts, the states handed out and that
``quickstart.warm`` leaves ``serve`` nothing to capture:

  PYTHONPATH=src python -m pytest -m gpu tests/test_torch_encode_graph.py
"""
import dataclasses
import gc
import weakref
from types import SimpleNamespace

import pytest
import torch
import torch.distributed as dist
from torch import nn
from torch.profiler import ProfilerActivity, profile

import repro_torch.configs as TC
from repro_torch import trace
from repro_torch.core.request import Request
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import quickstart
from repro_torch.models import diffusion, graphs
from repro_torch.models import pipeline as pl
from repro_torch.sharding import partition, spmd

LC = 77
PIPELINES = ["sd3", "flux", "hunyuanvideo-t2v"]


def _former_encode(pipe, tokens):
    """``pl.encode`` as it was before Encode could replay a graph."""
    enc = pipe.encoder
    with torch.no_grad():
        x = enc.embed_tokens(tokens)
        x = enc.run_layers(x)
        return enc.apply_final_norm(x) if enc.cfg.final_norm else x


def _tokens(cfg, dev, b=1, seed=3):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, cfg.encoder.vocab_size, (b, LC), generator=g, device=dev)


def _smoke(name):
    cfg = TC.get_smoke(name)
    return cfg, pl.build(cfg, "cpu", seed=0)


# --- CPU ---------------------------------------------------------------------

@pytest.mark.parametrize("name", PIPELINES)
@pytest.mark.parametrize("b", [1, 2])
def test_cpu_encode_gives_the_former_encode_bit_for_bit(name, b):
    cfg, pipe = _smoke(name)
    tokens = _tokens(cfg, torch.device("cpu"), b)
    keep = tokens.clone()
    got = pl.encode(pipe, tokens)
    assert torch.equal(got, _former_encode(pipe, tokens))
    assert torch.equal(tokens, keep)
    assert pipe.encode_graphs is None
    assert "encode_graphs" not in vars(pipe.encoder)        # the shared Transformer holds none


def test_meta_stays_eager():
    cfg = TC.get("sd3")
    pipe = pl.Pipeline(cfg, "meta")
    tokens = torch.zeros((2, LC), dtype=torch.long, device="meta")
    out = pl.encode(pipe, tokens)
    assert out.is_meta and out.shape == (2, LC, cfg.encoder.d_model)
    assert out.dtype == cfg.encoder.dtype
    assert pipe.encode_graphs is None


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
    cfg, plain = _smoke("sd3")
    _, pipe = _smoke("sd3")
    partition.distribute_model(pipe.encoder, {n: partition.P()
                                              for n, _ in pipe.encoder.named_parameters()},
                               world_of_one)
    assert all(spmd.is_dtensor(p) for p in pipe.encoder.parameters())
    tokens = _tokens(cfg, torch.device("cpu"))
    with implicit_replication():
        got = pl.encode(pipe, tokens)
        # tokens on a card would not make it replay either: the parameters decide
        assert pl.encode_graphs(pipe, SimpleNamespace(is_cuda=True)) is None
        got = got.full_tensor() if spmd.is_dtensor(got) else got
    assert torch.equal(got, pl.encode(plain, tokens))
    assert pipe.encode_graphs is None


@pytest.fixture
def card_free(monkeypatch):
    """``encode_graphs`` on the CPU with a stand-in for a card's tokens: no
    capture under way and pool handles that need no card."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    handles = iter(range(1, 1000))
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, next(handles)))
    return SimpleNamespace(is_cuda=True)


@pytest.mark.parametrize("case", ["cpu tokens", "grad on", "counter set", "capturing"])
def test_each_condition_keeps_encode_eager(card_free, monkeypatch, case):
    cfg, pipe = _smoke("sd3")
    x = card_free
    with torch.no_grad():
        assert pl.encode_graphs(pipe, x) is not None
    pipe.encode_graphs = None
    tokens = _tokens(cfg, torch.device("cpu"), 2)
    want = _former_encode(pipe, tokens)
    grad = torch.no_grad()
    if case == "cpu tokens":
        x = tokens
    elif case == "grad on":
        grad = torch.enable_grad()
    elif case == "counter set":
        monkeypatch.setattr(ops, "COUNTER", object())     # sd3's encoder runs no kernel op
    else:
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with grad:
        assert pl.encode_graphs(pipe, x) is None
        got = pl.encode(pipe, tokens)
    assert torch.equal(got, want)
    assert pipe.encode_graphs is None


def test_one_predicate_decides_for_encode_and_the_steps(card_free, monkeypatch):
    _, pipe = _smoke("sd3")
    seen = []
    real = graphs.replay_ptrs

    def refuse(module, x):
        seen.append(module)
        return None
    with torch.no_grad():
        assert real(pipe.encoder, card_free) is not None
        monkeypatch.setattr(graphs, "replay_ptrs", refuse)
        assert pl.encode_graphs(pipe, card_free) is None
        assert diffusion.step_graphs(pipe.dit, card_free) is None
    assert seen == [pipe.encoder, pipe.dit]
    assert pipe.encode_graphs is None and pipe.dit.step_graphs is None


def test_the_cache_follows_the_encoders_weights(card_free):
    _, pipe = _smoke("sd3")
    enc = pipe.encoder
    with torch.no_grad():
        first = pl.encode_graphs(pipe, card_free)
        assert first.ptrs == tuple(p.data_ptr() for p in enc.parameters())
        assert pl.encode_graphs(pipe, card_free) is first and pipe.encode_graphs is first
        enc.layers[1].wo.mul_(2.0)                  # in place: the graphs read it where it is
        assert pl.encode_graphs(pipe, card_free) is first
        pipe.dit.x_out = nn.Parameter(pipe.dit.x_out.clone())   # the DiT's: not Encode's
        assert pl.encode_graphs(pipe, card_free) is first
        enc.layers[1].wo = nn.Parameter(enc.layers[1].wo.clone())   # moved: the graphs go
        second = pl.encode_graphs(pipe, card_free)
    assert second is not first and pipe.encode_graphs is second
    assert second.ptrs == tuple(p.data_ptr() for p in enc.parameters())
    assert second.pool != first.pool and second.shapes == {}


def test_traced_cpu_encodes_say_eager():
    cfg, pipe = _smoke("sd3")
    tokens = _tokens(cfg, torch.device("cpu"))
    req = Request(cfg.name, *quickstart.smoke_requests("sd3")[0])
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        pl.encode(pipe, tokens)
        quickstart.serve(cfg, [req], device="cpu", pipe=pipe, num_steps=1)
        found = trace.spans()
    trace.clear()
    enc = [s for s in found if s.name == "encoder"]
    assert [s.attrs for s in enc] == [{"graphed": 0}, {"graphed": 0}]
    assert enc[0].parent is None
    (stage,) = [s for s in found if s.name == "encode"]
    assert enc[1].parent == stage.id                # inside the served launch's Encode
    assert all(s.device_start_ns is None for s in enc)


# --- the card ------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; run on the card")
    return torch.device("cuda")


def _cut(name):
    """``name`` at full width, its encoder and its DiT two layers deep (K1
    takes the bf16 heads of 128 of hunyuanvideo-t2v's causal encoder)."""
    full = TC.get(name)
    dit = dataclasses.replace(full.dit, num_layers=2,
                              double_layers=1 if full.dit.double_layers else 0)
    return dataclasses.replace(full, encoder=dataclasses.replace(full.encoder, num_layers=2),
                               dit=dit)


def _card_pipe(name, cuda):
    return pl.build(_cut(name), cuda, seed=0)


CARD = ["sd3", "hunyuanvideo-t2v"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CARD)
@pytest.mark.parametrize("b", [1, 2])
def test_replay_equals_eager_on_card(cuda, name, b):
    pipe = _card_pipe(name, cuda)
    tokens = _tokens(pipe.cfg, cuda, b)
    ops.reset_launches()
    want = _former_encode(pipe, tokens)
    eager = dict(ops.LAUNCHES)
    ops.reset_launches()
    got = pl.encode(pipe, tokens)                    # captured, then replayed
    first = dict(ops.LAUNCHES)
    ops.reset_launches()
    again = pl.encode(pipe, tokens)                  # replayed
    torch.cuda.synchronize()
    assert torch.equal(got, want), (got.float() - want.float()).abs().max().item()
    assert torch.equal(again, want)
    k1 = pipe.cfg.encoder.num_layers if name == "hunyuanvideo-t2v" else 0
    assert eager == first == dict(ops.LAUNCHES) == {"flash_attention": k1,
                                                      "adaln_rmsnorm": 0, "ssm_scan": 0}
    assert list(pipe.encode_graphs.shapes) == [((b, LC), torch.long)]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CARD)
def test_same_shape_captures_nothing_new_and_keeps_earlier_states(cuda, name, monkeypatch):
    pipe = _card_pipe(name, cuda)
    a, b = _tokens(pipe.cfg, cuda, seed=3), _tokens(pipe.cfg, cuda, seed=4)
    first = pl.encode(pipe, a)
    (cap,) = pipe.encode_graphs.shapes.values()
    made = []
    real = torch.cuda.CUDAGraph
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda *x, **k: made.append(x) or real(*x, **k))
    second = pl.encode(pipe, b)
    monkeypatch.undo()
    assert made == [] and list(pipe.encode_graphs.shapes.values()) == [cap]
    assert first.data_ptr() != second.data_ptr() != cap.out.data_ptr()
    assert torch.equal(first, _former_encode(pipe, a))
    assert torch.equal(second, _former_encode(pipe, b))
    assert not torch.equal(first, second)


@pytest.mark.gpu
def test_moved_weights_invalidate_the_graphs(cuda):
    pipe = _card_pipe("sd3", cuda)
    tokens = _tokens(pipe.cfg, cuda)
    before = pl.encode(pipe, tokens)
    old = pipe.encode_graphs
    with torch.no_grad():
        wo = pipe.encoder.layers[0].wo
        pipe.encoder.layers[0].wo = nn.Parameter(wo * 2.0, requires_grad=False)
    after = pl.encode(pipe, tokens)
    assert pipe.encode_graphs is not old
    assert not torch.equal(after, before)
    assert torch.equal(after, _former_encode(pipe, tokens))


@pytest.mark.gpu
def test_deleting_the_pipeline_frees_its_encoder_without_the_collector(cuda):
    """The captured Encode holds the encoder's buffers, never the encoder:
    no cycle keeps its weights and its graphs' pool after the pipeline goes."""
    pipe = _card_pipe("sd3", cuda)
    pl.encode(pipe, _tokens(pipe.cfg, cuda))
    assert len(pipe.encode_graphs.shapes) == 1
    enc = weakref.ref(pipe.encoder)
    gc.disable()
    try:
        del pipe
        assert enc() is None
    finally:
        gc.enable()


@pytest.mark.gpu
@pytest.mark.parametrize("name", CARD)
def test_warm_then_serve_captures_nothing_in_a_timed_encode(cuda, name, monkeypatch):
    """``quickstart.warm`` captures the Encode graph that ``serve`` then
    replays: no served request's timed E stage pays a capture."""
    pipe = _card_pipe(name, cuda)
    cls = (540, 1.0) if name == "hunyuanvideo-t2v" else (256, 0.0)
    reqs = [Request(pipe.cfg.name, *cls)]
    quickstart.warm(pipe, reqs)
    keys = list(pipe.encode_graphs.shapes)
    made = []
    real = torch.cuda.CUDAGraph
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda *x, **k: made.append(x) or real(*x, **k))
    quickstart.serve(pipe.cfg, reqs, device=cuda, pipe=pipe, num_steps=1)
    monkeypatch.undo()
    assert made == [] and list(pipe.encode_graphs.shapes) == keys == [((1, LC), torch.long)]


@pytest.mark.gpu
def test_traced_encode_on_card_says_graphed(cuda):
    pipe = _card_pipe("sd3", cuda)
    reqs = [Request(pipe.cfg.name, 256, 0.0)]
    quickstart.warm(pipe, reqs)                                  # captured untraced
    trace.clear()
    with profile(activities=[ProfilerActivity.CUDA]):
        quickstart.serve(pipe.cfg, reqs, device=cuda, pipe=pipe, num_steps=1)
        found = trace.spans()
    trace.clear()
    (enc,) = [s for s in found if s.name == "encoder"]
    (stage,) = [s for s in found if s.name == "encode"]
    assert enc.attrs == {"graphed": 1} and enc.parent == stage.id
    assert stage.device_end_ns > stage.device_start_ns
