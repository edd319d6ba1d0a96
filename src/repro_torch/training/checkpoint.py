"""Checkpoints: a flat name -> tensor dict in one file.

Counterpart of ``repro/training/checkpoint.py``. ``save`` writes with
``torch.save`` to a temporary file and moves it into place with
``os.replace``, so a reader never sees half a checkpoint; ``restore`` loads
with ``weights_only=True`` and checks the keys, shapes and dtypes against
``like``. ``torch.save`` keeps bf16 as it is (numpy has no bf16), and needs
no package beyond PyTorch. ``state_tree`` flattens a train state, the
parameters with their AdamW moments and step.
"""
from __future__ import annotations

import os
from typing import Dict, Mapping

import torch

Tree = Dict[str, torch.Tensor]


def save(path: str, tree: Mapping[str, torch.Tensor]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save({k: t.detach().cpu() for k, t in tree.items()}, tmp)
    os.replace(tmp, path)


def restore(path: str, like: Mapping[str, torch.Tensor]) -> Tree:
    """The checkpoint's tensors on ``like``'s devices; raises ValueError if
    its keys, or any tensor's shape or dtype, differ from ``like``'s."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    if set(data) != set(like):
        raise ValueError(f"checkpoint keys mismatch: {sorted(set(data) ^ set(like))}")
    out = {}
    for k, ref in like.items():
        t = data[k]
        if t.shape != ref.shape or t.dtype != ref.dtype:
            raise ValueError(f"{k}: checkpoint holds {tuple(t.shape)} {t.dtype}, "
                             f"expected {tuple(ref.shape)} {ref.dtype}")
        out[k] = t.to(ref.device)
    return out


def state_tree(state) -> Tree:
    """A train state (``loop.TrainState``) as one flat dict: ``params.<name>``,
    ``mu.<name>``, ``nu.<name>`` and ``step``."""
    tree = {f"params.{n}": p.detach() for n, p in state.params.items()}
    tree.update({f"mu.{n}": t for n, t in state.opt.mu.items()})
    tree.update({f"nu.{n}": t for n, t in state.opt.nu.items()})
    tree["step"] = state.opt.step
    return tree


def save_state(path: str, state) -> None:
    save(path, state_tree(state))


@torch.no_grad()
def restore_state(path: str, state):
    """Write a checkpoint of ``state``'s shapes into ``state``'s parameters
    and moments in place; returns the state with the checkpoint's step."""
    tree = restore(path, state_tree(state))
    for k, t in state_tree(state).items():
        if k != "step":
            t.copy_(tree[k])
    return type(state)(state.model, state.opt._replace(step=tree["step"]))
