"""Partition rules: parameter, optimizer, batch and cache specs, and their
DTensor placements.

Counterpart of ``repro/sharding/partition.py``, with the same rules and the
same outcome. Conventions (single-pod mesh ("data", "model"); multi-pod
prepends "pod"):

* tensor parallelism on ``model``: attention/ffn projections shard their
  hidden dimension; embeddings shard the vocab; MoE experts shard the
  expert dimension (expert parallelism);
* ``data`` (x ``pod``) carries the batch; decode caches shard sequence
  across whatever axes the batch does not use (flash-decoding style);
* per-head scalars, norms, and small LoRA/conv params replicate.

A spec is a ``P``: one entry per tensor dimension, each a mesh-axis name,
``None`` (replicated) or a tuple of names (sharded over their product,
major to minor), as ``jax.sharding.PartitionSpec``. Rules are name-based
over ``named_parameters()`` names (``layers.3.moe.w_gate``); the port keeps
one module per layer, so no spec has the reference's stacked lead
dimension. ``named`` turns specs into DTensor placements on a
``DeviceMesh`` and ``distribute_state`` puts a whole train state on one.
A "mesh" here is anything whose axis sizes ``axis_sizes`` can read: a
``DeviceMesh`` with named dimensions, or ``launch.mesh.MeshShape``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Sequence, Tuple

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.training.optimizer import AdamWState

# leaf-name -> rule for the layer's parameter
_COL = "col"     # shard last (output) dim on model
_ROW = "row"     # shard first (input/contraction) dim on model
_REP = "rep"

_RULES: Dict[str, str] = {
    # embeddings / heads
    "embed": "vocab_in",
    "lm_head": "vocab_out",
    "codebook_embed": "cb_embed",
    "codebook_head": "cb_head",
    "vision_proj": _REP,
    # attention
    "wq": _COL, "wk": _COL, "wv": _COL, "wo": _ROW,
    # dense ffn
    "w_gate": _COL, "w_up": _COL, "w_down": _ROW,
    # moe
    "router": _REP,
    "shared_gate": _COL, "shared_up": _COL, "shared_down": _ROW,
    # mamba2
    "in_proj": _COL, "out_proj": _ROW,
    "conv_w": "conv", "conv_b": "conv_b",
    "A_log": _REP, "D": _REP, "dt_bias": _REP, "norm_w": "vec_model",
    # rwkv6
    "w_r": _COL, "w_k": _COL, "w_v": _COL, "w_g": _COL, "w_o": _ROW,
    "decay_w0": _REP, "decay_A": _REP, "decay_B": _COL,
    "bonus_u": _REP, "mu": _REP, "cm_mu": _REP,
    "ln_w": _REP, "ln_b": _REP,
    "cm_rk": _COL, "cm_kv": _COL, "cm_vo": _ROW,
    # norms / misc
    "ln1": _REP, "ln2": _REP, "q_norm": _REP, "k_norm": _REP,
    "final_norm": _REP,
}

# moe expert tensors are distinguished by path ("moe" ancestor)
_MOE_EXPERT_LEAVES = {"w_gate", "w_up", "w_down"}


class P(tuple):
    """A partition spec: per tensor dimension a mesh-axis name, None, or a
    tuple of names. Trailing dimensions left out replicate. As
    ``PartitionSpec`` does, a tuple of one name is that name and an empty
    one is None."""

    def __new__(cls, *dims):
        return super().__new__(cls, (None if isinstance(d, tuple) and not d
                                     else d[0] if isinstance(d, tuple) and len(d) == 1 else d
                                     for d in dims))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class StateTree(NamedTuple):
    """A train state as a tree: ``params`` (name -> leaf) and ``opt`` (an
    ``AdamWState`` of leaves). Holds the specs of a state, its tensors
    (``state_tree``) or its placements (``named``)."""
    params: Dict[str, Any]
    opt: AdamWState


def state_tree(state) -> StateTree:
    """A ``training.loop.TrainState`` as a ``StateTree`` of its tensors."""
    return StateTree(params=state.params, opt=state.opt)


def _tree_map(fn, specs, *others):
    """``fn(spec, *leaves)`` over the P leaves of ``specs``, walking
    ``others`` (trees of the same structure) in lockstep."""
    if isinstance(specs, P):
        return fn(specs, *others)
    if isinstance(specs, Mapping):
        return {k: _tree_map(fn, s, *(o[k] for o in others)) for k, s in specs.items()}
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return type(specs)(*(_tree_map(fn, s, *(getattr(o, f) for o in others))
                             for f, s in zip(specs._fields, specs)))
    if isinstance(specs, (list, tuple)):
        return type(specs)(_tree_map(fn, s, *(o[i] for o in others))
                           for i, s in enumerate(specs))
    raise TypeError(f"not a spec tree: {type(specs).__name__}")


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (named dimensions) or of
    anything with a ``shape`` mapping (``launch.mesh.MeshShape``)."""
    if isinstance(mesh.shape, Mapping):
        return dict(mesh.shape)
    if not mesh.mesh_dim_names:
        raise ValueError("the mesh's dimensions have no names")
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axes(ax) -> Tuple[str, ...]:
    return (ax,) if isinstance(ax, str) else tuple(ax)


def _leaf_rule(name: str) -> Tuple[str, bool]:
    """(rule, is_moe_expert) of a ``named_parameters()`` name."""
    names = name.split(".")
    leaf = names[-1]
    moe = "moe" in names and leaf in _MOE_EXPERT_LEAVES
    return _RULES.get(leaf, _REP), moe


def _spec_for(rule: str, ndim: int, moe: bool, model: str) -> P:
    if moe:
        # (E, D, F) / (E, F, D): expert parallelism on the expert dim
        return P(model, None, None)
    base = {
        _COL: (None, model),
        _ROW: (model, None),
        "vocab_in": (model, None),
        "vocab_out": (None, model),
        "cb_embed": (None, model, None),
        "cb_head": (None, None, model),
        "conv": (None, model),
        "conv_b": (model,),
        "vec_model": (model,),
        _REP: tuple([None] * ndim),
    }[rule]
    assert len(base) == ndim, (rule, ndim, base)
    return P(*base)


def param_specs(cfg: ModelConfig, params, *, model_axis: str = "model") -> Dict[str, P]:
    """name -> P for ``params`` (a model, or name -> tensor; ``meta``
    tensors will do)."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    specs = {}
    for name, leaf in params.items():
        rule, moe = _leaf_rule(name)
        specs[name] = _spec_for(rule, len(_shape(leaf)), moe, model_axis)
    return specs


def validate_divisibility(specs, shapes, mesh):
    """Replace specs whose sharded dims don't divide the mesh axis size
    (e.g. 56 heads on a 16-way model axis shards the fused H*Dh dim
    instead — if even that fails, replicate)."""
    sizes = axis_sizes(mesh)

    def fix(spec: P, leaf):
        shape = _shape(leaf)
        out = []
        for dim, ax in enumerate(tuple(spec) + (None,) * (len(shape) - len(spec))):
            if ax is None:
                out.append(None)
                continue
            size = 1
            for a in _axes(ax):
                size *= sizes[a]
            out.append(ax if shape[dim] % size == 0 else None)
        return P(*out)

    return _tree_map(fix, specs, shapes)


def zero_shard(specs, shapes, mesh, data_axis: str = "data"):
    """ZeRO-style sharding: additionally shard each tensor's largest
    still-replicated dim over the data axis (when divisible). Applied to the
    AdamW moments (and optionally the params = FSDP) it removes the dominant
    optimizer-state term from peak memory at the cost of per-step
    (reduce-)scatter/gather collectives."""
    dsize = axis_sizes(mesh)[data_axis]

    def fix(spec: P, leaf):
        shape = _shape(leaf)
        dims = tuple(spec) + (None,) * (len(shape) - len(spec))
        cands = [i for i, ax in enumerate(dims)
                 if ax is None and shape[i] % dsize == 0 and shape[i] >= dsize]
        if not cands:
            return P(*dims)
        best = max(cands, key=lambda i: shape[i])
        out = list(dims)
        out[best] = data_axis
        return P(*out)

    return _tree_map(fix, specs, shapes)


def state_specs(cfg: ModelConfig, state, *, model_axis: str = "model", zero_mesh=None,
                fsdp: bool = False) -> StateTree:
    """Train-state specs (``state``: a ``TrainState`` or a ``StateTree`` of
    tensors): params and AdamW moments share layouts; the step scalar
    replicates. ``zero_mesh`` enables ZeRO sharding of the f32 moments over
    the data axis; ``fsdp`` extends it to the params."""
    tree = state if isinstance(state, StateTree) else state_tree(state)
    pspec = param_specs(cfg, tree.params, model_axis=model_axis)
    mspec = param_specs(cfg, tree.opt.mu, model_axis=model_axis)
    nspec = param_specs(cfg, tree.opt.nu, model_axis=model_axis)
    if zero_mesh is not None:
        mspec = zero_shard(mspec, tree.opt.mu, zero_mesh)
        nspec = zero_shard(nspec, tree.opt.nu, zero_mesh)
        if fsdp:
            pspec = zero_shard(pspec, tree.params, zero_mesh)
    return StateTree(params=pspec, opt=AdamWState(step=P(), mu=mspec, nu=nspec))


def batch_specs(batch_shape: Mapping[str, Any], data_axes) -> Dict[str, P]:
    """Shard the batch dimension across the data(+pod) axes."""
    return {k: P(data_axes, *([None] * (len(_shape(v)) - 1))) for k, v in batch_shape.items()}


def cache_specs(cfg: ModelConfig, caches: Sequence[Mapping[str, Any]], batch: int, mesh,
                data_axes, model_axis: str = "model") -> list:
    """Decode-cache specs, one dict per layer of ``Transformer.init_cache``.

    KV tensors ("k"/"v": (B, S, Hkv, Dh), "pos": (B, S)): batch shards on the
    data axes when divisible; the sequence dim shards on ``model`` — and on
    data+model when B=1 (long_500k flash-decoding layout). SSM/conv/shift
    states shard batch only.
    """
    sizes = axis_sizes(mesh)
    daxes = _axes(data_axes)
    data_size = 1
    for a in daxes:
        data_size *= sizes[a]
    batch_ok = batch % data_size == 0 and batch >= data_size
    b_ax = data_axes if batch_ok else None
    s_ax = model_axis if batch_ok else (*daxes, model_axis)
    s_size = sizes[model_axis] if batch_ok else data_size * sizes[model_axis]

    def spec(name: str, leaf) -> P:
        shape = _shape(leaf)
        if name in ("k", "v", "pos"):     # (B, S, Hkv, Dh) / (B, S)
            sa = s_ax if shape[1] % s_size == 0 else None
            return P(b_ax, sa, *([None] * (len(shape) - 2)))
        return P(b_ax, *([None] * (len(shape) - 1)))

    return [{name: spec(name, leaf) for name, leaf in layer.items()} for layer in caches]


def placements(spec: P, mesh) -> tuple:
    """The DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``:
    per mesh dimension ``Shard(d)`` where that axis shards tensor dimension
    ``d``, else ``Replicate()``. A dimension sharded over a tuple of axes is
    ``Shard(d)`` on each of them; the tuple must list them in mesh order
    (major to minor), as DTensor shards them."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    where: Dict[str, int] = {}
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = _axes(ax)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"{spec}: the axes of dim {d} are not in the mesh's order {names}")
        for a in axes:
            if a in where:
                raise ValueError(f"{spec}: axis {a!r} shards two dimensions")
            where[a] = d
    return tuple(Shard(where[n]) if n in where else Replicate() for n in names)


def named(tree_specs, mesh):
    """Each P of ``tree_specs`` as its placements on ``mesh``."""
    return _tree_map(lambda s: placements(s, mesh), tree_specs)


def _check_divides(spec: P, shape: Tuple[int, ...], mesh, what: str) -> None:
    sizes = axis_sizes(mesh)
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        size = 1
        for a in _axes(ax):
            size *= sizes[a]
        if shape[dim] % size:
            raise ValueError(f"{what}: dim {dim} of {shape} does not divide over {ax} ({size}); "
                             "run validate_divisibility first")


def distribute(t: torch.Tensor, spec: P, mesh, what: str = "tensor"):
    """``t`` (the same full tensor on every rank) as a DTensor placed by
    ``spec``: each rank keeps a copy of its own shard, and nothing is sent.
    Raises where a sharded dim does not divide: the port never leans on
    DTensor's uneven shards."""
    from torch.distributed.tensor import DTensor, Shard

    _check_divides(spec, tuple(t.shape), mesh, what)
    pl = placements(spec, mesh)
    coord = mesh.get_coordinate()
    local = t.detach()
    for mdim, p in enumerate(pl):
        if isinstance(p, Shard):
            local = local.chunk(mesh.size(mdim), dim=p.dim)[coord[mdim]]
    return DTensor.from_local(local.clone(), mesh, pl, run_check=False, shape=t.shape,
                              stride=t.stride())


def distribute_model(model, specs: Mapping[str, P], mesh):
    """``model`` on ``mesh``, in place: each parameter becomes a DTensor
    parameter placed by ``specs`` (name -> P), keeping ``requires_grad``.
    Every rank must hold the same full model (the same seed)."""
    from torch import nn

    for name, p in list(model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        setattr(mod, leaf, nn.Parameter(distribute(p.data, specs[name], mesh, name),
                                        requires_grad=p.requires_grad))
    return model


def distribute_state(state, sspec: StateTree, mesh):
    """The train state on ``mesh``, in place: each parameter of the model
    becomes a DTensor parameter placed by ``sspec.params``, and each moment
    a DTensor placed by ``sspec.opt``. The step, a replicated scalar
    (``P()``), stays a plain tensor: every rank holds the same one. Every
    rank must hold the same full state (the same seed)."""
    distribute_model(state.model, sspec.params, mesh)
    opt = state.opt
    mu = {n: distribute(t, sspec.opt.mu[n], mesh, f"mu.{n}") for n, t in opt.mu.items()}
    nu = {n: distribute(t, sspec.opt.nu[n], mesh, f"nu.{n}") for n, t in opt.nu.items()}
    if tuple(sspec.opt.step) or opt.step.dim():
        raise ValueError("the step is a replicated scalar")
    state.opt = AdamWState(step=opt.step, mu=mu, nu=nu)
    return state
