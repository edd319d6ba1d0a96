"""Carry weights across from the reference's parameter pytrees.

``from_jax(cfg, np_params, device)`` builds the port's ``Pipeline`` from the
reference's ``{"encode", "diffuse", "decode"}`` pytree, and
``from_jax_lm(cfg, np_params, device)`` its ``Transformer`` from the
reference's ``transformer.init`` pytree, both given as numpy arrays (the
caller converts them; this module imports no JAX), and ``from_jax_state``
a ``training.loop.TrainState`` from the reference's ``TrainState``: its
parameters, AdamW moments and step. Layer stacks are split
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
from repro_torch.training import loop, optimizer


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
    for name, a in _lm_arrays(cfg, model, np_params).items():
        _assign(model.get_parameter(name), a, name)
    return model


def _lm_arrays(cfg: ModelConfig, model: Transformer, tree: Mapping[str, Any]) -> Dict[str, Any]:
    """A pytree of the reference's parameter structure (its parameters, or
    its AdamW moments) keyed by ``model``'s parameter names: the front ends'
    and head's by name, the layers' unstacked in scan-plan order. Raises
    ValueError where the names differ."""
    names = dict(model.named_parameters())
    out = {name: a for name, a in tree.items() if name != "blocks"}
    for i, lp in enumerate(_plan_layers(cfg, tree["blocks"])):
        out.update({f"layers.{i}.{k}": a for k, a in lp.items()})
    if set(out) != set(names):
        raise ValueError(f"the reference's parameters {sorted(set(out) - set(names))} and the "
                         f"port's {sorted(set(names) - set(out))} do not match")
    return out


def from_jax_state(cfg: ModelConfig, params: Mapping[str, Any], mu: Mapping[str, Any],
                   nu: Mapping[str, Any], step: int, device=None) -> loop.TrainState:
    """The port's train state from the reference's ``TrainState``: its
    ``params`` (through ``from_jax_lm``, then made learnable), its
    ``opt.mu``/``opt.nu`` moments (float32) and ``opt.step``, as numpy."""
    model = from_jax_lm(cfg, params, device).requires_grad_(True)
    names = dict(model.named_parameters())
    moments = []
    for tree in (mu, nu):
        arrays = _lm_arrays(cfg, model, tree)
        moments.append({n: torch.from_numpy(np.array(arrays[n], dtype=np.float32)).to(p.device)
                        for n, p in names.items()})
    dev = model.embed.device
    return loop.TrainState(model, optimizer.AdamWState(
        step=torch.tensor(int(step), dtype=torch.int32, device=dev), mu=moments[0],
        nu=moments[1]))
