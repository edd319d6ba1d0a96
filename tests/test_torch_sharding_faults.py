"""Known faults of the sharded paths, for the negative controls of
``tests/test_torch_sharding.py`` and ``tests/test_torch_smoke_checks.py``.

``faulty_suite`` is a rank function for ``shard_check.run``: the ranks
import this module, so it imports nothing heavier than torch. Each fault
is a context that swaps one piece of the port for a broken one and puts it
back on leaving:

* ``fault("a2a_swapped")`` — Ulysses' two all-to-alls exchanged (sequence
  and head axes swapped);
* ``fault("ladder_no_decay")`` — the scan's ladder adds each rank's chunk
  state to the prefix without decaying the prefix;
* ``dropped_update(name)`` — the sharded step computes every AdamW update
  and moment but leaves the parameter ``name`` as it was.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch

from repro_torch.launch import shard_check as sc

FAULTS = ("ladder_no_decay", "a2a_swapped")


@contextlib.contextmanager
def fault(name: Optional[str]):
    """Inside the block ``sequence_parallel`` carries the known fault
    ``name`` (None: none)."""
    from repro_torch.sharding import sequence_parallel as sp

    saved = (sp._ladder, sp._seq_to_heads, sp._heads_to_seq)
    if name == "ladder_no_decay":
        def ladder(every, rank):
            carry = torch.zeros_like(every[0, ..., :-1])
            for i in range(rank):
                carry = carry + every[i, ..., :-1]
            return carry
        sp._ladder = ladder
    elif name == "a2a_swapped":
        sp._seq_to_heads, sp._heads_to_seq = sp._heads_to_seq, sp._seq_to_heads
    elif name is not None:
        raise ValueError(f"unknown fault {name!r}; known: {FAULTS}")
    try:
        yield
    finally:
        sp._ladder, sp._seq_to_heads, sp._heads_to_seq = saved


@contextlib.contextmanager
def dropped_update(name: str):
    """Inside the block AdamW's step on a mesh updates the moments of every
    parameter but leaves the DTensor parameter ``name`` unchanged (the
    unsharded step, on plain tensors, is untouched)."""
    from repro_torch.sharding import spmd
    from repro_torch.training import optimizer

    real = optimizer.update

    def update(cfg, grads, state, params):
        p = params[name]
        kept = p.detach().clone() if spmd.is_dtensor(p) else None
        out = real(cfg, grads, state, params)
        if kept is not None:
            with torch.no_grad():
                p.copy_(kept)
        return out

    optimizer.update = update
    try:
        yield
    finally:
        optimizer.update = real


def faulty_suite(rank: int, world: int, device: torch.device,
                 attn: Sequence[sc.AttnCase] = (), scan: Sequence[sc.ScanCase] = (),
                 train: Sequence[sc.TrainCase] = (), state_arrays: Optional[dict] = None,
                 dropped: Sequence[sc.TrainCase] = (), leaf: str = "layers.0.wq") -> dict:
    """``shard_check.suite_ranks`` and then the faults -> its result with
    "faults": the first Ulysses case under "a2a_swapped", the first scan
    case under "ladder_no_decay", and the ``dropped`` train cases with
    ``leaf``'s update dropped ("dropped_update"); and "uneven": the error
    ``shard_sequence`` raises on a length that does not divide over the
    ranks."""
    from repro_torch.sharding import sequence_parallel as sp

    out = sc.suite_ranks(rank, world, device, attn, scan, train, state_arrays)
    with fault("a2a_swapped"):
        bad_attn = sc.ulysses_ranks(rank, world, device, attn[:1])
    with fault("ladder_no_decay"):
        bad_scan = sc.scan_ranks(rank, world, device, scan[:1])
    with dropped_update(leaf):
        bad_train = sc.train_ranks(rank, world, device, dropped, state_arrays)
    out["faults"] = {"a2a_swapped": bad_attn, "ladder_no_decay": bad_scan,
                     "dropped_update": bad_train}
    mesh = sc._model_mesh(world, device)
    try:
        sp.shard_sequence(torch.zeros(1, world + 1, 2), mesh)
        out["uneven"] = None
    except ValueError as e:
        out["uneven"] = str(e)
    return out


def test_the_faults_put_back_what_they_replace():
    """Each fault swaps its piece in and restores it on leaving, also when
    the block raises; an unknown fault is refused."""
    from repro_torch.sharding import sequence_parallel as sp
    from repro_torch.training import optimizer

    saved = (sp._ladder, sp._seq_to_heads, sp._heads_to_seq, optimizer.update)
    for name in FAULTS:
        with fault(name):
            assert (sp._ladder, sp._seq_to_heads, sp._heads_to_seq) != saved[:3]
        assert (sp._ladder, sp._seq_to_heads, sp._heads_to_seq) == saved[:3]
    try:
        with dropped_update("layers.0.wq"):
            assert optimizer.update is not saved[3]
            raise KeyError("inside")
    except KeyError:
        pass
    assert optimizer.update is saved[3]
    try:
        with fault("no such fault"):
            pass
    except ValueError as e:
        assert "unknown fault" in str(e)
    else:
        raise AssertionError("an unknown fault ran")
