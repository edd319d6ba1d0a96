"""Per-device FLOPs, HBM bytes, collectives and peak live bytes of a step,
counted op by op as it runs.

Counterpart of ``repro/roofline/hlo.py``, which parses XLA's partitioned
HLO. The port has no HLO: the step runs eagerly, on ``meta`` tensors for
a dry run (nothing is allocated) or on the card, under a
``TorchDispatchMode`` that sees each ATen op one device runs. Sharded
steps run on DTensors over a ``torch.distributed`` world, a fake one
(``fake_world``) for a dry run: each rank's local ops are what one device
runs.

* **flops**: the local ops' products, by ``torch.utils.flop_counter``'s
  formulas (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``convolution``,
  ``sdpa`` and their backward), plus each kernel op's ``cost``;
* **hbm_bytes**: the eager model, with no fusion: every compute op reads
  its operands and writes its result once (a stride-0 dimension once);
  views, allocations and metadata ops move nothing; an op that overwrites
  its first argument (``copy_``, ``fill_``, ``zero_``) does not read it;
  plus each kernel op's ``cost``;
* **collective_wire_bytes**, **collective_counts**: the functional
  collectives DTensor calls (``_c10d_functional``), each result's bytes
  times the reference's wire factor for its group of g ranks: all-gather,
  reduce-scatter and all-to-all (g - 1) / g, all-reduce 2 (g - 1) / g,
  permute 1. ``wire_by_group`` keeps the bytes per group, whose span
  prices them (``analysis.Roofline``);
* **kernel_calls**: the kernel ops' calls, whose cost each op reports
  (``kernels/ops.py``'s ``COUNTER``): a kernel is a ``ctypes`` call no
  dispatch mode sees, and on ``meta`` it runs nothing;
* **peak_bytes**: the arguments' bytes plus the most bytes the step's own
  storages held at once, each storage tracked from the op that made it to
  the death of its last tensor (the counterpart of ``memory_analysis()``).

Only the local ops count. DTensor's ops are passed to DTensor, which runs
the local ops they stand for; the ops its sharding propagation runs on
global shapes under a ``FakeTensorMode`` (once per op signature, then
cached) are skipped, so the first and the second call of a step count the
same. The reference's loop multipliers have no counterpart: an eager loop
runs every iteration. Where the reference approximates a convolution's
work (``_conv_flops``: the kernel's elements over its last dimension), the
port counts ``torch.utils.flop_counter``'s exact formula.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

# functional collective op name -> the reference's kind
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "_dtensor")

_A = torch.ops.aten
# ops that move no bytes: allocations, metadata, and views the schema does not mark
_NO_BYTES = {
    _A.empty, _A.empty_like, _A.empty_strided, _A.new_empty, _A.new_empty_strided,
    _A.detach, _A.alias, _A.lift_fresh, _A._unsafe_view, _A.set_, _A.resize_,
    _A.sym_size, _A.sym_stride, _A.sym_numel, _A.sym_storage_offset, _A.is_same_size,
}
# ops that overwrite their first argument without reading it
_OVERWRITE = {_A.copy_, _A.fill_, _A.zero_}


def wire_factor(kind: str, group: int) -> float:
    """Bytes on the wire per result byte of a collective over ``group`` ranks."""
    ring = (group - 1) / group
    return {"all-gather": ring, "reduce-scatter": ring, "all-reduce": 2 * ring,
            "all-to-all": ring, "collective-permute": 1.0}[kind]


def unique_bytes(t: torch.Tensor) -> int:
    """Bytes a tensor addresses: a stride-0 (broadcast) dimension counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        n *= size if stride else 1
    return n * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


@dataclasses.dataclass
class ModuleCosts:
    """One device's counts of a step (the module docstring)."""
    flops: float
    hbm_bytes: float
    collective_wire_bytes: float
    collective_counts: Dict[str, int]
    kernel_calls: Dict[str, int]
    peak_bytes: int
    # wire bytes per collective group (its ranks, in order)
    wire_by_group: Dict[Tuple[int, ...], float] = dataclasses.field(default_factory=dict)
    # op name -> [calls, flops, HBM bytes, wire bytes]
    by_op: Dict[str, list] = dataclasses.field(default_factory=dict)

    def wide_wire_bytes(self, link_domain_chips: int) -> float:
        """The wire bytes of groups that do not lie inside one block of
        ``link_domain_chips`` consecutive ranks (0: every group is inside)."""
        if not link_domain_chips:
            return 0.0
        return sum(b for ranks, b in self.wire_by_group.items()
                   if len({r // link_domain_chips for r in ranks}) > 1)


class Counter(TorchDispatchMode):
    """The counting mode: enter it (``with counter:``) around a step, then
    read ``costs()``. ``kernels/ops.py`` reports its kernel calls to it
    while it is ``ops.COUNTER``."""

    def __init__(self, args=()):
        super().__init__()
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.wire = 0.0
        self.coll_counts: Dict[str, int] = {}
        self.kernel_calls: Dict[str, int] = {}
        self.wire_by_group: Dict[Tuple[int, ...], float] = {}
        self.by_op: Dict[str, list] = {}
        self._pause = 0
        self._storages: Dict[int, list] = {}     # storage key -> [bytes, live tensors]
        self._live = 0
        self._peak = 0
        # the arguments' storages: live throughout, their views add nothing
        self._held = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                      for t in _local_tensors(args)}
        self._base = sum(self._held.values())
        self._groups: Dict[str, Tuple[int, ...]] = {}
        self._prev = None

    # -- the kernel ops' hook ------------------------------------------------

    @contextlib.contextmanager
    def paused(self) -> Iterator[None]:
        """Ops inside are not counted (a kernel's plain version)."""
        self._pause += 1
        try:
            yield
        finally:
            self._pause -= 1

    def kernel(self, name: str, cost: Tuple[float, float], out) -> None:
        """One call of kernel ``name``: its (operations, bytes) and its outputs."""
        if self._pause:
            return
        self.flops += cost[0]
        self.hbm_bytes += cost[1]
        self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1
        self._tally(name, cost[0], cost[1], 0.0)
        self._track(out)

    def _tally(self, name: str, flops: float, nbytes: float, wire: float) -> None:
        row = self.by_op.setdefault(name, [0, 0.0, 0.0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        row[3] += wire

    # -- the mode ------------------------------------------------------------

    def __enter__(self):
        from repro_torch.kernels import ops
        self._prev, ops.COUNTER = ops.COUNTER, self
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.COUNTER = self._prev
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented            # DTensor runs the local ops
        out = func(*args, **kwargs)
        if self._pause or torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out                       # sharding propagation on global shapes
        self._count(func, args, kwargs, out)
        self._track(out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry
        packet = func._overloadpacket
        flops = wire = nbytes = 0.0
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
        if func.namespace in _COLLECTIVE_NAMESPACES:
            kind = _COLLECTIVE_OPS.get(func._opname)
            if kind is None:
                return                       # wait_tensor, the mesh's group lookup
            ranks = self._group(args)
            wire = sum(unique_bytes(t) for t in _tensors(out)) * wire_factor(kind, len(ranks))
            self.wire += wire
            self.wire_by_group[ranks] = self.wire_by_group.get(ranks, 0.0) + wire
            self.coll_counts[kind] = self.coll_counts.get(kind, 0) + 1
        if not (func.is_view or packet in _NO_BYTES):
            ins = _tensors((args, kwargs))
            if packet in _OVERWRITE and args and isinstance(args[0], torch.Tensor):
                ins = ins[1:]
            nbytes = (sum(unique_bytes(t) for t in ins)
                      + sum(unique_bytes(t) for t in _tensors(out)))
        self.flops += flops
        self.hbm_bytes += nbytes
        if flops or nbytes or wire:
            self._tally(func._opname, flops, nbytes, wire)

    def _group(self, args) -> Tuple[int, ...]:
        """The ranks of a collective's group, named by its last string argument."""
        import torch.distributed as dist
        from torch.distributed.distributed_c10d import _resolve_process_group
        name = [a for a in args if isinstance(a, str)][-1]
        if name not in self._groups:
            self._groups[name] = tuple(dist.get_process_group_ranks(_resolve_process_group(name)))
        return self._groups[name]

    # -- live bytes ----------------------------------------------------------

    def _track(self, out) -> None:
        for t in _tensors(out):
            if _is_dtensor_type(type(t)):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._held:
                continue
            entry = self._storages.get(key)
            if entry is None:
                entry = self._storages[key] = [st.nbytes(), 0]
                self._live += entry[0]
                self._peak = max(self._peak, self._live)
            entry[1] += 1
            weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self._live -= entry[0]
            del self._storages[key]

    def costs(self) -> ModuleCosts:
        return ModuleCosts(flops=self.flops, hbm_bytes=self.hbm_bytes,
                           collective_wire_bytes=self.wire,
                           collective_counts=dict(self.coll_counts),
                           kernel_calls=dict(self.kernel_calls),
                           peak_bytes=self._base + self._peak,
                           wire_by_group=dict(self.wire_by_group),
                           by_op={k: list(v) for k, v in self.by_op.items()})


def _is_dtensor_type(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, type) and issubclass(t, DTensor)


def _local_tensors(tree) -> list:
    """The tensors of ``tree`` (modules' parameters and buffers, dataclass
    fields, containers), each DTensor as its local shard."""
    out = []

    def walk(x):
        if isinstance(x, torch.nn.Module):
            for t in list(x.parameters()) + list(x.buffers()):
                walk(t)
        elif isinstance(x, torch.Tensor):
            out.append(x.to_local() if _is_dtensor_type(type(x)) else x)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    return out


@contextlib.contextmanager
def fake_world(size: int) -> Iterator[None]:
    """A ``torch.distributed`` world of ``size`` ranks on a fake backend, this
    process its rank 0: collectives return at once and move nothing, so a
    DTensor step on ``meta`` shows one device's local ops and collectives.
    Torn down on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a torch.distributed world is already up")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def count(fn: Callable, *args, **kwargs) -> Tuple[Any, ModuleCosts]:
    """(``fn(*args, **kwargs)``, its counts); the arguments' bytes (their
    local shards) open the live bytes."""
    counter = Counter(args)
    with counter:
        out = fn(*args, **kwargs)
    return out, counter.costs()


def module_costs(fn: Callable, *args, world: Optional[int] = None, **kwargs) -> ModuleCosts:
    """One device's counts of ``fn(*args, **kwargs)``; with ``world``, run
    inside a fake world of that many ranks (``fake_world``)."""
    with fake_world(world) if world else contextlib.nullcontext():
        return count(fn, *args, **kwargs)[1]
