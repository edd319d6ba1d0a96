"""Carry weights across from the reference's parameter pytree.

``from_jax(cfg, np_params, device)`` builds the port's ``Pipeline`` from the
reference's ``{"encode", "diffuse", "decode"}`` pytree given as numpy arrays
(the caller converts them; this module imports no JAX). Layer stacks are
split into per-layer modules, HWIO conv kernels become OIHW, and every
array goes through float32 (lossless for bf16) before taking the
parameter's own dtype.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.models.pipeline import Pipeline, PipelineConfig


def _assign(p: torch.Tensor, arr: Any, name: str) -> None:
    a = torch.from_numpy(np.asarray(arr, dtype=np.float32).copy())
    if tuple(a.shape) != tuple(p.shape):
        raise ValueError(f"{name}: shape {tuple(a.shape)} does not fit {tuple(p.shape)}")
    with torch.no_grad():
        p.copy_(a.to(device=p.device, dtype=p.dtype))


def _stacked_layers(blocks) -> list:
    """The reference's ``blocks[bi][pi]`` stacks as one list of per-layer dicts."""
    layers = []
    for block in blocks:
        if len(block) != 1:
            raise NotImplementedError("cycling layer patterns are not ported yet")
        stack = block[0]
        n = len(next(iter(stack.values())))
        layers += [{k: v[i] for k, v in stack.items()} for i in range(n)]
    return layers


def from_jax(cfg: PipelineConfig, np_params: Mapping[str, Dict], device=None) -> Pipeline:
    dev = torch.device("cpu" if device is None else device)
    pipe = Pipeline(cfg, dev).eval()

    enc, p = pipe.encoder, np_params["encode"]
    for name in ("embed", "final_norm", "lm_head"):
        if hasattr(enc, name):
            _assign(getattr(enc, name), p[name], f"encode.{name}")
    layers = _stacked_layers(p["blocks"])
    if len(layers) != len(enc.layers):
        raise ValueError(f"encoder: {len(layers)} layers for {len(enc.layers)}")
    for i, (mod, lp) in enumerate(zip(enc.layers, layers)):
        for name, t in mod.named_parameters():
            _assign(t, lp[name], f"encode.layers.{i}.{name}")

    dit, p = pipe.dit, np_params["diffuse"]
    for name in ("x_in", "cond_in", "t_mlp1", "t_mlp2", "final_mod", "x_out", "pos_freq"):
        _assign(getattr(dit, name), p[name], f"diffuse.{name}")
    for i, mod in enumerate(dit.layers):
        for name, t in mod.named_parameters():
            _assign(t, p["layers"][name][i], f"diffuse.layers.{i}.{name}")

    dec, p = pipe.decoder, np_params["decode"]
    for name, t in dec.named_parameters():
        _assign(t, np.asarray(p[name], dtype=np.float32).transpose(3, 2, 0, 1),
                f"decode.{name}")
    return pipe
