"""DTensor helpers for the models' sharded training pass.

The sharded train step runs the models' own code on DTensor parameters and
a DTensor batch, and DTensor's sharding propagation inserts the
collectives, as ``jax.jit`` with ``in_shardings`` does for the reference.
Where an op has no DTensor sharding strategy (or a wrong one), the model
redistributes at that op with these helpers; each call site says why.
On plain tensors every helper is the identity, or calls ``fn`` as is, so
the single-device pass does not change by a bit.

A batch-major activation is ``Shard(0)`` on the mesh dimensions that
carry the batch (``data``) and replicated or sharded otherwise.

``replicate_unsupported`` is the dry run's catch-all: a call that DTensor
cannot shard runs again on replicated inputs, as XLA's partitioner
reshards what it must (``launch/dryrun.py``).
"""
from __future__ import annotations

import collections
from typing import Callable, Sequence

import torch
from torch.overrides import TorchFunctionMode


_PLAIN = (torch.Tensor, torch.nn.Parameter)


def is_dtensor(x) -> bool:
    if type(x) in _PLAIN:           # the single-device path asks this per layer
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def shards(x, dim: int) -> int:
    """How many shards a DTensor ``x`` is cut into along tensor dimension
    ``dim`` (the product of the mesh dimensions that shard it); 1 for any
    other tensor."""
    if not is_dtensor(x):
        return 1
    from torch.distributed.tensor import Shard

    n = 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            n *= x.device_mesh.size(i)
    return n


def reshape(x, *shape):
    """``x.reshape(*shape)``. For a DTensor whose sharded dimension DTensor
    cannot split evenly into the new ones (a projection's output sharded
    into fewer columns than a head holds: 4 KV heads on 16 ranks), ``x`` is
    gathered whole first, as XLA's partitioner reshards there; its
    gradient takes the same path back."""
    if not is_dtensor(x):
        return x.reshape(*shape)
    return _Reshape.apply(x, shape)


def _whole_if_refused(x, shape):
    try:
        return x.reshape(shape)
    except RuntimeError:
        from torch.distributed.tensor import Replicate

        return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim).reshape(shape)


class _Reshape(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape = x.shape
        return _whole_if_refused(x, shape)

    @staticmethod
    def backward(ctx, grad):
        return _whole_if_refused(grad, ctx.shape), None


def local(fn: Callable, *args, keep: Sequence[int] = (0,), shared: Sequence[int] = (),
          whole: bool = False):
    """``fn`` on the local tensors of ``args``, for a region of ops without
    DTensor strategies (or whose strategy search costs more than the
    region); its outputs come back as DTensors.

    The arguments keep the first DTensor argument's shards of the tensor
    dimensions in ``keep`` (the batch, by default) and are gathered whole
    along every other dimension; ``fn`` must treat each index of a kept
    dimension on its own, and every output keeps the same shards (a
    (B, ...) output for the batch). With ``whole`` every argument and
    output is replicated. Arguments indexed by ``shared`` (parameters) are
    taken whole; their gradients are each rank's partial sums over its
    shard (``Partial`` on the mesh dimensions that shard the others).
    Plain tensors pass as they are; with no DTensor argument ``fn`` runs as
    is."""
    dts = [a for j, a in enumerate(args) if is_dtensor(a) and j not in shared]
    if not dts:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = dts[0].device_mesh
    rows = tuple(p if isinstance(p, Shard) and p.dim in keep and not whole else Replicate()
                 for p in dts[0].placements)
    rep = (Replicate(),) * mesh.ndim
    partial = tuple(Partial() if isinstance(p, Shard) else Replicate() for p in rows)
    local_args = []
    for j, a in enumerate(args):
        if not is_dtensor(a):
            local_args.append(a)
        elif j in shared:
            local_args.append(a.redistribute(mesh, rep).to_local(grad_placements=partial))
        else:
            local_args.append(a.redistribute(mesh, rows).to_local(grad_placements=rows))
    out = fn(*local_args)

    def wrap(t):
        if not isinstance(t, torch.Tensor):
            return t
        return DTensor.from_local(t, mesh, rows, run_check=False)

    return tuple(wrap(t) for t in out) if isinstance(out, tuple) else wrap(out)


class replicate_unsupported(TorchFunctionMode):
    """Inside it, a torch call on DTensors that DTensor refuses (no
    strategy, an uneven split of a sharded dimension) is made again with
    every DTensor argument replicated, the all-gathers that takes included;
    an in-place call writes its result back into its first argument in
    that argument's placements. ``calls`` counts the calls so made by
    name. The ops of a refused call that ran before it was refused run
    twice."""

    def __init__(self):
        super().__init__()
        self.calls = collections.Counter()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        try:
            return func(*args, **kwargs)
        except (RuntimeError, NotImplementedError) as e:
            from torch.distributed.tensor import DTensor, Replicate
            from torch.utils._pytree import tree_flatten, tree_map

            dts = [a for a in tree_flatten((args, kwargs))[0] if isinstance(a, DTensor)]
            if not dts or all(isinstance(p, Replicate) for d in dts for p in d.placements):
                raise
            name = getattr(func, "__name__", str(func))

            def whole(a):
                if not isinstance(a, DTensor):
                    return a
                return a.redistribute(a.device_mesh, [Replicate()] * a.device_mesh.ndim)

            rargs, rkwargs = tree_map(whole, (args, kwargs))
            try:
                out = func(*rargs, **rkwargs)
            except Exception:
                raise e from None
            self.calls[name] += 1
            first = args[0] if args else None
            inplace = name == "__setitem__" or (name.endswith("_") and not name.endswith("__"))
            if inplace and isinstance(first, DTensor) and rargs[0] is not first:
                with torch.no_grad():
                    first.copy_(rargs[0].redistribute(first.device_mesh, first.placements))
                return None if name == "__setitem__" else first
            return out
