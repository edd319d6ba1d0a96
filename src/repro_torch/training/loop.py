"""The train state, the loss, the train step and a simple training loop.

Counterpart of ``repro/training/loop.py``. The step is forward, backward and
an AdamW update, with the MoE layers' load-balance aux loss folded into the
loss. The forward is ``Transformer.train_forward``: the reference's training
math in plain PyTorch on every device, differentiated by autograd (the
reference has no backward kernel, and its training reaches none of its
kernels).

On a mesh (``init_state(..., mesh=...)``) the state is sharded by the
partition rules (``sharding.partition.state_specs``): the parameters and
moments are DTensors, the step shards each batch with ``batch_specs`` and
runs the same forward and backward on them, and DTensor's propagation
inserts the collectives (the reference's ``jax.jit`` with
``in_shardings``). The metrics come back as plain tensors, the same on
every rank.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.data import pipeline
from repro_torch.models import transformer
from repro_torch.models.common import ModelConfig
from repro_torch.training import optimizer as opt_lib


@dataclasses.dataclass
class TrainState:
    """The model (its parameters take gradients) and the AdamW state; on a
    mesh, the ``DeviceMesh`` ("data", "model")."""
    model: transformer.Transformer
    opt: opt_lib.AdamWState
    mesh: Any = None

    @property
    def params(self) -> Dict[str, torch.nn.Parameter]:
        return dict(self.model.named_parameters())


def init_state(cfg: ModelConfig, seed: int = 0, device=None, *, mesh=None, zero: bool = False,
               fsdp: bool = False) -> TrainState:
    """``transformer.build``'s seeded model on ``device`` (``cuda`` by
    default), its parameters turned learnable, and zero moments. With
    ``mesh`` (a ``DeviceMesh`` on that device type) every rank builds the
    same model from the seed and the state is then sharded: the moments
    ZeRO-sharded over ``data`` with ``zero``, the parameters too with
    ``fsdp``, every spec validated against the mesh."""
    model = transformer.build(cfg, device, seed).requires_grad_(True)
    state = TrainState(model, opt_lib.init(dict(model.named_parameters())))
    if mesh is None:
        return state
    return shard_state(cfg, state, mesh, zero=zero, fsdp=fsdp)


def shard_state(cfg: ModelConfig, state: TrainState, mesh, *, zero: bool = False,
                fsdp: bool = False) -> TrainState:
    """The full ``state`` (the same on every rank) sharded on ``mesh``, in
    place, by ``state_specs`` (``zero``: the moments over ``data``;
    ``fsdp``: the parameters too), validated against the mesh."""
    from repro_torch.sharding import partition

    tree = partition.state_tree(state)
    sspec = partition.state_specs(cfg, tree, zero_mesh=mesh if (zero or fsdp) else None,
                                  fsdp=fsdp)
    sspec = partition.validate_divisibility(sspec, tree, mesh)
    state = partition.distribute_state(state, sspec, mesh)
    state.mesh = mesh
    return state


def shard_batch(state: TrainState, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The full batch (the same on every rank) as DTensors sharded by
    ``batch_specs`` over ``data``; unchanged off a mesh."""
    if state.mesh is None:
        return batch
    from repro_torch.sharding import partition, spmd

    specs = partition.batch_specs(batch, "data")
    return {k: v if spmd.is_dtensor(v) else partition.distribute(v, specs[k], state.mesh, k)
            for k, v in batch.items()}


def token_nll(cfg: ModelConfig, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each scored position's negative log-likelihood, float32: (B, L), or
    (B, L, K) for ``audio_codec`` (logits (B, L, K, V), labels (B, K, L)).
    A vision model's logits cover [vision prefix; text]: only the text
    positions are scored."""
    if cfg.modality == "audio_codec":
        labels = labels.movedim(1, 2)
    elif logits.shape[1] != labels.shape[1]:
        logits = logits[:, logits.shape[1] - labels.shape[1]:]
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels[..., None].long())[..., 0]


def loss_fn(model: transformer.Transformer, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy plus the MoE aux loss -> (loss, metrics)."""
    logits, aux = model.train_forward(batch["tokens"], batch.get("patch_embeds"))
    nll = torch.mean(token_nll(model.cfg, logits, batch["labels"]))
    loss = nll + aux
    return loss, {"loss": loss.detach(), "nll": nll.detach(), "aux": aux.detach()}


def make_train_step(cfg: ModelConfig, ocfg: Optional[opt_lib.AdamWConfig] = None):
    """-> ``train_step(state, batch) -> (state, metrics)``: the parameters
    and moments are updated in place; the metrics are ``loss``, ``nll``,
    ``aux``, ``grad_norm`` and ``lr`` (scalar tensors on the device)."""
    ocfg = ocfg or opt_lib.AdamWConfig()

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        params = state.params
        for p in params.values():
            p.grad = None
        with _on_mesh(state):
            loss, metrics = loss_fn(state.model, shard_batch(state, batch))
            loss.backward()
            grads = {n: p.grad for n, p in params.items()}
            if state.mesh is not None:
                # each gradient to its moment's layout (a reduce-scatter or an
                # all-reduce of the pending sums)
                grads = {n: opt_lib.to_layout(g, state.opt.mu[n]) for n, g in grads.items()}
            gnorm = opt_lib.global_norm(grads)
            _, opt = opt_lib.update(ocfg, grads, state.opt, params)
        for p in params.values():
            p.grad = None
        metrics = {k: opt_lib.full(v) for k, v in metrics.items()}
        metrics = dict(metrics, grad_norm=gnorm, lr=opt_lib.schedule(ocfg, opt.step))
        return dataclasses.replace(state, opt=opt), metrics

    return train_step


def _on_mesh(state: TrainState):
    """DTensors meet plain tensors (positions, masks, scalars) in the
    models' code: on a mesh those count as replicated."""
    if state.mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def train(cfg: ModelConfig, data: Iterator[Dict[str, np.ndarray]], num_steps: int,
          seed: int = 0, ocfg: Optional[opt_lib.AdamWConfig] = None, log_every: int = 10,
          device=None) -> Tuple[TrainState, list]:
    """The single-device loop of the examples and tests: ``num_steps`` steps on
    ``device`` (``cuda`` by default); a history row (metrics as floats,
    ``step`` and the host ``wall`` seconds) every ``log_every`` steps and at
    the last."""
    dev = _device.resolve(device)
    state = init_state(cfg, seed, dev)
    step_fn = make_train_step(cfg, ocfg)
    history = []
    t0 = time.perf_counter()
    for i in range(num_steps):
        state, metrics = step_fn(state, pipeline.to_tensors(next(data), dev))
        if i % log_every == 0 or i == num_steps - 1:
            row = {k: float(v) for k, v in metrics.items()}
            row["step"] = i
            row["wall"] = time.perf_counter() - t0
            history.append(row)
    return state, history
