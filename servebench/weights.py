"""The benchmark's weights, made on the device from the seed.

One buffer a dtype, filled from N(0, 1) by a generator on the device in a
few large draws, then cut into the parameters (each starting on a 128-byte
boundary) and scaled to the std that ``param_specs`` gives; the
reference's ``finish`` then sets the few that it derives. The port's
pipeline and the plain reference read these same tensors.
"""
from __future__ import annotations

import importlib
import math
from typing import Dict, Sequence, Tuple

import torch

DRAW_ELEMENTS = 2 ** 30          # one draw fills at most this many elements
ALIGN_BYTES = 128


def make(specs: Sequence[Tuple[str, Tuple[int, ...], str, float]], device: torch.device,
         seed: int) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out: Dict[str, torch.Tensor] = {}
    for dtype_name in sorted({s[2] for s in specs}):
        dtype = getattr(torch, dtype_name)
        align = ALIGN_BYTES // torch.empty((), dtype=dtype).element_size()
        group, offsets, n = [s for s in specs if s[2] == dtype_name], [], 0
        for _, shape, _, _ in group:
            offsets.append(n)
            n += -(-math.prod(shape) // align) * align
        flat = torch.empty(n, dtype=dtype, device=device)
        for i in range(0, n, DRAW_ELEMENTS):
            flat[i:i + DRAW_ELEMENTS].normal_(generator=gen)
        for (name, shape, _, std), off in zip(group, offsets):
            out[name] = flat[off:off + math.prod(shape)].view(shape).mul_(std)
    return out


def for_config(cfg: dict, device: torch.device, seed: int) -> Dict[str, torch.Tensor]:
    """The weights of configuration ``cfg`` from ``seed``, as its plain
    reference specifies them."""
    ref = importlib.import_module(f"servebench.reference.{cfg['reference']}")
    w = make(ref.param_specs(cfg), device, seed)
    ref.finish(w, cfg)
    return w
