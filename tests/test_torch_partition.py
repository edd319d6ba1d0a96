"""The port's partition rules against the reference's, leaf by leaf.

Every LLM of the zoo at full size: the port's model on ``meta`` and the
reference's parameter tree through ``jax.eval_shape``, its stacked layers
mapped onto the port's ``layers.{i}.*`` names by the scan plan
(``convert._plan_layers``) with the stacked lead dimension dropped. Then
``validate_divisibility``, ``zero_shard``, ``state_specs``, ``batch_specs``
and ``cache_specs`` on the same fake meshes, and ``named``'s placements on
a world-size-1 gloo mesh.
"""
import functools
import os

import jax
import pytest
import torch
import torch.distributed as dist

import repro.configs as JC
import repro_torch.configs as TC
from repro.models import transformer as jtf
from repro.sharding import partition as jpart
from repro.training import loop as jloop
from repro_torch import convert
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as ttf
from repro_torch.sharding import partition as tpart
from repro_torch.training import loop as tloop

MESHES = {"16x16": mesh_lib.make_production_mesh(),
          "4x2": mesh_lib.MeshShape(("data", "model"), (4, 2))}
ARCHS = list(TC.ARCH_IDS)


class _FakeMesh:
    """The reference's functions read only ``mesh.shape``."""

    def __init__(self, shape: mesh_lib.MeshShape):
        self.shape = shape.shape


class _Stacked:
    """A reference leaf of a stacked layer: ``[r]`` is repeat r's (the spec
    or shape without the lead dimension), as ``convert._plan_layers``
    indexes arrays."""

    def __init__(self, leaf):
        self.leaf = leaf

    def __getitem__(self, r):
        return tuple(self.leaf)[1:]


def _unstack(cfg, tree, model):
    """A reference tree (specs or shapes) keyed by the port's parameter names."""
    def wrap(x):
        return {k: wrap(v) for k, v in x.items()} if isinstance(x, dict) else _Stacked(x)
    top = {k: v for k, v in tree.items() if k != "blocks"}
    blocks = [[wrap(stack) for stack in block] for block in tree["blocks"]]
    out = convert._lm_arrays(cfg, model, dict(top, blocks=blocks))
    return {k: (tuple(v.leaf) if isinstance(v, _Stacked) else tuple(v)) for k, v in out.items()}


def _shape_tuple(s):
    return tuple(s.shape)


@functools.lru_cache(maxsize=None)
def _sides(arch):
    """(the reference's config, its param shapes, the port's meta model)."""
    jcfg = JC.get(arch)
    shapes = jax.eval_shape(lambda k: jtf.init(jcfg, k), jax.random.PRNGKey(0))
    model = ttf.Transformer(TC.get(arch), "meta")
    return jcfg, shapes, model


def _ref_by_name(arch, specs):
    jcfg, shapes, model = _sides(arch)
    return _unstack(TC.get(arch), specs, model)


def _port_params(arch):
    return dict(_sides(arch)[2].named_parameters())


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_references_on_every_leaf(arch):
    jcfg, shapes, model = _sides(arch)
    want = _ref_by_name(arch, jpart.param_specs(jcfg, shapes))
    got = tpart.param_specs(TC.get(arch), model)
    assert set(got) == set(want)
    assert {n: tuple(s) for n, s in got.items()} == want
    # the shapes line up too, so every spec is read against the same tensor
    ref_shapes = _unstack(TC.get(arch), jax.tree_util.tree_map(_shape_tuple, shapes,
                                                               is_leaf=lambda x: hasattr(
                                                                   x, "shape")), model)
    assert {n: tuple(p.shape) for n, p in _port_params(arch).items()} == ref_shapes


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_validate_divisibility_and_zero_shard_equal_the_references(arch, mesh):
    jcfg, shapes, model = _sides(arch)
    m = MESHES[mesh]
    jspecs = jpart.param_specs(jcfg, shapes)
    tspecs = tpart.param_specs(TC.get(arch), model)
    params = _port_params(arch)
    jval = jpart.validate_divisibility(jspecs, shapes, _FakeMesh(m))
    tval = tpart.validate_divisibility(tspecs, params, m)
    assert {n: tuple(s) for n, s in tval.items()} == _ref_by_name(arch, jval)
    jz = _ref_by_name(arch, jpart.zero_shard(jval, shapes, _FakeMesh(m)))
    tz = {n: tuple(s) for n, s in tpart.zero_shard(tval, params, m).items()}
    assert tz == jz


@pytest.mark.parametrize("fsdp", [False, True], ids=["zero", "fsdp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_state_specs_equal_the_references(arch, fsdp):
    jcfg, shapes, model = _sides(arch)
    m = MESHES["16x16"]
    jstate = jax.eval_shape(lambda: jloop.init_state(jcfg, jax.random.PRNGKey(0)))
    jspec = jpart.validate_divisibility(
        jpart.state_specs(jcfg, jstate, zero_mesh=_FakeMesh(m), fsdp=fsdp), jstate, _FakeMesh(m))
    params = _port_params(arch)
    tree = tpart.StateTree(params=params, opt=tpart.AdamWState(
        step=torch.empty((), device="meta"), mu=params, nu=params))
    tspec = tpart.validate_divisibility(
        tpart.state_specs(TC.get(arch), tree, zero_mesh=m, fsdp=fsdp), tree, m)
    for got, want in ((tspec.params, jspec.params), (tspec.opt.mu, jspec.opt.mu),
                      (tspec.opt.nu, jspec.opt.nu)):
        assert {n: tuple(s) for n, s in got.items()} == _ref_by_name(arch, want)
    assert tuple(tspec.opt.step) == tuple(jspec.opt.step) == ()


@pytest.mark.parametrize("axes", [("data",), ("pod", "data")], ids=["data", "pod-data"])
def test_batch_specs_equal_the_references(axes):
    import numpy as np
    batch = {"tokens": np.zeros((8, 64)), "labels": np.zeros((8, 64)),
             "patch_embeds": np.zeros((8, 256, 1024)), "codes": np.zeros((8, 4, 64))}
    want = jpart.batch_specs(batch, axes)
    got = tpart.batch_specs(batch, axes)
    assert {k: tuple(v) for k, v in got.items()} == {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_the_references(arch, mesh, batch):
    jcfg, _, model = _sides(arch)
    m = MESHES[mesh]
    max_len = 4096
    jcache = jax.eval_shape(lambda: jtf.init_cache(jcfg, batch, max_len))
    jspec = jpart.cache_specs(jcfg, jcache, batch, _FakeMesh(m), ("data",))
    caches = model.init_cache(batch, max_len)
    tspec = tpart.cache_specs(TC.get(arch), caches, batch, m, ("data",))
    layers = convert._plan_layers(TC.get(arch), [[{k: _Stacked(v) for k, v in stack.items()}
                                                  for stack in block] for block in jspec])
    assert len(layers) == len(tspec)
    for got, want in zip(tspec, layers):
        assert {k: tuple(v) for k, v in got.items()} == want
    for got, c in zip(tspec, caches):
        assert set(got) == set(c)


@pytest.fixture
def world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            world_size=1, rank=0)
    try:
        yield mesh_lib.make_host_mesh(1, "cpu")
    finally:
        dist.destroy_process_group()


def test_named_placements_on_a_world_of_one(world_of_one):
    """Each mesh dimension is Shard(d) where its axis shards dim d, else
    Replicate; a tuple of axes shards one dim on both (in mesh order only);
    a distributed state's DTensors carry these placements."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = world_of_one
    assert tuple(mesh.mesh_dim_names) == ("data", "model") and tuple(mesh.shape) == (1, 1)
    P = tpart.P
    cases = {P(None, "model"): (Replicate(), Shard(1)), P("model", None): (Replicate(), Shard(0)),
             P("data", "model"): (Shard(0), Shard(1)), P(): (Replicate(), Replicate()),
             P(None, ("data", "model"), None): (Shard(1), Shard(1)),
             P("model", None, "data"): (Shard(2), Shard(0))}
    for spec, want in cases.items():
        assert tpart.placements(spec, mesh) == want, spec
    assert tpart.named({"a": P(None, "model"), "b": [P()]}, mesh) == {
        "a": (Replicate(), Shard(1)), "b": [(Replicate(), Replicate())]}
    with pytest.raises(ValueError, match="order"):
        tpart.placements(P(("model", "data"),), mesh)
    cfg = TC.get_smoke("deepseek-moe-16b")
    full = tloop.init_state(cfg, 0, "cpu")
    sspec = tpart.state_specs(cfg, full, zero_mesh=mesh)
    state = tloop.init_state(cfg, 0, "cpu", mesh=mesh, zero=True)
    assert any(tuple(sspec.opt.mu[n]) != tuple(sspec.params[n]) for n in sspec.params)
    for name, p in state.params.items():
        assert tuple(p.placements) == tpart.placements(sspec.params[name], mesh), name
        for moments, spec in ((state.opt.mu, sspec.opt.mu), (state.opt.nu, sspec.opt.nu)):
            assert tuple(moments[name].placements) == tpart.placements(spec[name], mesh), name
        assert torch.equal(p.full_tensor(), full.params[name]), name


def test_distribute_refuses_a_dim_that_does_not_divide(world_of_one):
    """The port never leans on DTensor's uneven shards."""
    with pytest.raises(ValueError, match="does not divide"):
        tpart._check_divides(tpart.P("model"), (7,), MESHES["4x2"], "w")
    assert tpart.validate_divisibility({"w": tpart.P("model")}, {"w": torch.empty(7)},
                                       MESHES["4x2"]) == {"w": tpart.P(None)}


def test_production_mesh_and_data_axes_match_the_reference():
    from repro.launch import mesh as jmesh
    assert jmesh.data_axes(False) == mesh_lib.data_axes(False) == ("data",)
    assert jmesh.data_axes(True) == mesh_lib.data_axes(True) == ("pod", "data")
    assert mesh_lib.make_production_mesh().shape == {"data": 16, "model": 16}
    assert mesh_lib.make_production_mesh(multi_pod=True).shape == {"pod": 2, "data": 16,
                                                                   "model": 16}
    assert mesh_lib.make_production_mesh(multi_pod=True).size == 512


@pytest.mark.parametrize("arch", ARCHS)
def test_activation_spec_lands_where_the_references_scan_body_starts(arch):
    """``set_activation_sharding``'s constraint applies before the first
    layer of each repeat of each scan-plan block's cycle: where the
    reference's scan body constrains its carry."""
    jcfg = JC.get(arch)
    want, i = set(), 0
    for cycle, repeat in jcfg.scan_plan():
        for _ in range(repeat):
            want.add(i)
            i += len(cycle)
    model = _sides(arch)[2]
    assert model.cycle_starts() == frozenset(want) and i == len(model.layers)
