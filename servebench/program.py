"""The system under test: the port's diffusion pipeline and its serving loop.

This is the only module of the benchmark that imports the port
(``repro_torch``). It builds the port's ``PipelineConfig`` from a
configuration file, puts the benchmark's weights into the port's
``Pipeline`` without copying them, and calls
``repro_torch.launch.quickstart.serve``, the served entry.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from repro_torch.core.request import Request
from repro_torch.launch import quickstart
from repro_torch.models import pipeline as pl
from repro_torch.models.common import ModelConfig
from repro_torch.models.diffusion import DecoderConfig, DiTConfig


def _fields(section: dict) -> dict:
    out = dict(section)
    out["dtype"] = getattr(torch, out["dtype"])
    if "layer_pattern" in out:
        out["layer_pattern"] = tuple(out["layer_pattern"])
    return out


def config(cfg: dict) -> pl.PipelineConfig:
    """The port's configuration, field for field from the file."""
    p = cfg["pipeline"]
    return pl.PipelineConfig(name=cfg["name"], encoder=ModelConfig(**_fields(cfg["encoder"])),
                             dit=DiTConfig(**_fields(cfg["dit"])),
                             decoder=DecoderConfig(**_fields(cfg["decoder"])),
                             num_steps=p["num_steps"], max_cond_len=p["max_cond_len"],
                             is_video=p["is_video"], source=p["source"])


def pipeline(pcfg: pl.PipelineConfig, weights: Dict[str, torch.Tensor]) -> pl.Pipeline:
    """The port's pipeline holding ``weights`` themselves (no copy): built on
    ``meta``, then every parameter assigned its tensor."""
    pipe = pl.Pipeline(pcfg, "meta")
    pipe.load_state_dict(weights, strict=True, assign=True)
    return pipe.eval()


def request(pcfg: pl.PipelineConfig, resolution: int, seconds: float, arrival: float,
            deadline: float, cond_len: int) -> Request:
    # serve() fills in a deadline of exactly 0.0 from its own model
    return Request(pcfg.name, resolution, seconds, arrival=arrival,
                   deadline=deadline if deadline != 0.0 else -1e-9, cond_len=cond_len)


def serve(pcfg: pl.PipelineConfig, requests: Sequence[Request], pipe: pl.Pipeline,
          device: torch.device, seed: int, num_steps=None) -> List[dict]:
    return quickstart.serve(pcfg, requests, device=device, seed=seed, pipe=pipe,
                            num_steps=num_steps)

