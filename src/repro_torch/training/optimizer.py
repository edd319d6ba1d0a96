"""AdamW with decoupled weight decay and a warmup-cosine schedule.

Counterpart of ``repro/training/optimizer.py``, as plain functions on dicts
of tensors (name -> tensor). The moments are float32 whatever the
parameter's dtype; each update computes in float32 and casts the result to
the parameter's dtype, and the gradients are clipped by their global norm
first. ``torch.optim.AdamW`` does neither: it keeps bf16 moments for bf16
parameters and clips nothing.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, NamedTuple, Optional, Tuple, Union

import torch

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    grad_clip: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    mu: Tree                # float32 first moments
    nu: Tree                # float32 second moments


def schedule(cfg: AdamWConfig, step: Union[int, torch.Tensor]) -> torch.Tensor:
    """The learning rate at ``step`` (float32): linear warmup to ``lr``, then
    a cosine down to ``min_lr_ratio * lr`` at ``total_steps``."""
    step = torch.as_tensor(step).float()
    warm = step / max(1.0, cfg.warmup_steps)
    frac = torch.clamp((step - cfg.warmup_steps) / max(1.0, cfg.total_steps - cfg.warmup_steps),
                       0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params: Tree) -> AdamWState:
    """Step 0 and zero moments (float32, on each parameter's device)."""
    dev = next(iter(params.values())).device
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev), mu=zeros,
                      nu={n: torch.zeros_like(z) for n, z in zeros.items()})


def global_norm(tree: Union[Tree, Iterable[Optional[torch.Tensor]]]) -> torch.Tensor:
    """The float32 norm of every leaf together (each leaf's norm summed in
    float32, then the norm of those); a None leaf (a parameter that took no
    gradient) counts as zeros."""
    leaves = [x for x in (tree.values() if isinstance(tree, dict) else tree) if x is not None]
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(x, dtype=torch.float32) for x in leaves]))


@torch.no_grad()
def update(cfg: AdamWConfig, grads: Dict[str, Optional[torch.Tensor]], state: AdamWState,
           params: Tree) -> Tuple[Tree, AdamWState]:
    """One AdamW step of ``params`` by ``grads`` (a None gradient is zeros,
    as the reference's gradient of an unused parameter). The parameters and
    the moments are written in place, leaf by leaf, so that the step holds
    no second copy of them; returns (params, the new state)."""
    step = state.step + 1
    stepf = step.float()
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    bias1 = 1 - torch.tensor(cfg.b1, device=stepf.device) ** stepf
    bias2 = 1 - torch.tensor(cfg.b2, device=stepf.device) ** stepf
    for name, p in params.items():
        m, v, g = state.mu[name], state.nu[name], grads.get(name)
        g = torch.zeros_like(m) if g is None else g.float() * scale
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)                  # b1 m + (1 - b1) g
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)           # b2 v + (1 - b2) g^2
        del g
        pf = p.float()                                            # p itself if float32
        delta = (m / bias1).div_((v / bias2).sqrt_().add_(cfg.eps))
        delta.add_(pf, alpha=cfg.weight_decay).mul_(lr)
        if pf is p:
            p.sub_(delta)
        else:
            p.copy_(pf.sub_(delta))
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu)
