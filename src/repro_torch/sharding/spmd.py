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
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch


def is_dtensor(x) -> bool:
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
