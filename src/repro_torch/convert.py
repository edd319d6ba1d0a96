"""Carry weights across from the reference's parameter pytrees.

``from_jax(cfg, np_params, device)`` builds the port's ``Pipeline`` from the
reference's ``{"encode", "diffuse", "decode"}`` pytree, and
``from_jax_lm(cfg, np_params, device)`` its ``Transformer`` from the
reference's ``transformer.init`` pytree, both given as numpy arrays (the
caller converts them; this module imports no JAX). Layer stacks are split
into per-layer modules in execution order, HWIO conv kernels become OIHW,
and every array goes through float32 (lossless for bf16) before taking the
parameter's own dtype. Both build on ``cuda`` unless given another device.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.models.common import ModelConfig
from repro_torch.models.pipeline import Pipeline, PipelineConfig
from repro_torch.models.transformer import Transformer


def _assign(p: torch.Tensor, arr: Any, name: str) -> None:
    a = torch.from_numpy(np.asarray(arr, dtype=np.float32).copy())
    if tuple(a.shape) != tuple(p.shape):
        raise ValueError(f"{name}: shape {tuple(a.shape)} does not fit {tuple(p.shape)}")
    with torch.no_grad():
        p.copy_(a.to(device=p.device, dtype=p.dtype))


def _flat(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    """A nested dict of arrays keyed by dotted names, as ``named_parameters``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _plan_layers(cfg: ModelConfig, blocks) -> list:
    """The reference's ``blocks[bi][pi]`` stacks as one list of per-layer
    dicts in execution order: block by block, repeat by repeat, cycle
    position by cycle position (``ModelConfig.plan_kinds``)."""
    plan = cfg.scan_plan()
    if len(blocks) != len(plan):
        raise ValueError(f"{len(blocks)} parameter blocks for a scan plan of {len(plan)}")
    layers = []
    for block, (cycle, repeat) in zip(blocks, plan):
        stacks = [_flat(stack) for stack in block]
        if len(stacks) != len(cycle):
            raise ValueError(f"{len(stacks)} stacks for a cycle of {len(cycle)}")
        layers += [{k: a[r] for k, a in stack.items()}
                   for r in range(repeat) for stack in stacks]
    return layers


def _assign_layers(mods, layers: list, what: str) -> None:
    if len(layers) != len(mods):
        raise ValueError(f"{what}: {len(layers)} layers for {len(mods)}")
    for i, (mod, lp) in enumerate(zip(mods, layers)):
        names = dict(mod.named_parameters())
        if set(names) != set(lp):
            raise ValueError(f"{what}.layers.{i}: parameters {sorted(names)} "
                             f"do not match {sorted(lp)}")
        for name, t in names.items():
            _assign(t, lp[name], f"{what}.layers.{i}.{name}")


def from_jax(cfg: PipelineConfig, np_params: Mapping[str, Dict], device=None) -> Pipeline:
    dev = _device.resolve(device)
    pipe = Pipeline(cfg, dev).eval()

    enc, p = pipe.encoder, np_params["encode"]
    for name in ("embed", "final_norm", "lm_head"):
        if hasattr(enc, name):
            _assign(getattr(enc, name), p[name], f"encode.{name}")
    _assign_layers(enc.layers, _plan_layers(cfg.encoder, p["blocks"]), "encode")

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


def from_jax_lm(cfg: ModelConfig, np_params: Mapping[str, Any], device=None) -> Transformer:
    """The port's ``Transformer`` from the reference's ``transformer.init``
    pytree (numpy arrays), layers unstacked in scan-plan order (with each
    layer's ``q_norm``/``k_norm`` where the config has ``qk_norm``), and the
    front ends' ``vision_proj``, ``codebook_embed`` and ``codebook_head``."""
    model = Transformer(cfg, _device.resolve(device)).eval()
    for name in ("embed", "final_norm", "lm_head", "vision_proj", "codebook_embed",
                 "codebook_head"):
        if hasattr(model, name):
            _assign(getattr(model, name), np_params[name], name)
    _assign_layers(model.layers, _plan_layers(cfg, np_params["blocks"]), "lm")
    return model
