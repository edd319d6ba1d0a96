"""Whether the window's outputs are right: the served pixels against the
plain reference, on requests drawn from the seed before the window.

``serve`` draws a call's prompt ids from ``numpy.random.default_rng(seed)``,
one array of ``cond_len`` ids a request in the order the requests were
handed over, and each launch's starting noise, (batch, L, latent_dim) in
float32, from a generator on the device seeded ``seed + 1 + the lead's
place``; a request's noise is its row of its launch. ``inputs`` works both
out again from the call's seed and the launch's members, and the reference
recomputes everything else from the benchmark's own weights.

The number compared is ``pixel_gap``: the largest over the sampled
requests of ||served - reference|| / ||reference|| over the request's
pixels. With it: requests that failed or were never served, and stamps
taken before the device finished (``window.py``). Each must stay within
its limit.
"""
from __future__ import annotations

import importlib
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from servebench.window import Run, Served


def reference(cfg: dict):
    """The configuration's plain reference module (``reference/<name>.py``)."""
    return importlib.import_module(f"servebench.reference.{cfg['reference']}")


def inputs(run: Run, r: Served, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(prompt ids (1, Lc), starting noise (1, L, latent_dim)) of a served request."""
    call = run.calls[r.call]
    launch = run.launches[r.launch]
    rng = np.random.default_rng(call.seed)
    vocab = run.cfg["encoder"]["vocab_size"]
    ids = [rng.integers(0, vocab, size=launch.cond_tokens) for _ in range(r.pos + 1)][-1]
    lead = run.requests[launch.members[0]]
    gen = torch.Generator(device=device)
    gen.manual_seed(call.seed + 1 + lead.pos)
    noise = torch.randn((len(launch.members), launch.latent_tokens, run.cfg["dit"]["latent_dim"]),
                        dtype=torch.float32, device=device, generator=gen)
    j = launch.members.index(r.index)
    return torch.from_numpy(ids)[None].to(device), noise[j:j + 1]


def gaps(run: Run, weights: Dict[str, torch.Tensor], device: torch.device,
         fp8: bool = False) -> List[Tuple[Served, float]]:
    """(request, pixel gap) for every sampled request that was served: the
    served output against the float32 reference, or with ``fp8`` the
    control (the reference one precision below bfloat16) in its place."""
    ref = reference(run.cfg)
    out = []
    for r in run.requests:
        if r.output is None:
            continue
        tokens, noise = inputs(run, r, device)
        want = ref.generate(weights, run.cfg, tokens, noise, r.resolution, r.seconds)
        got = (ref.generate(weights, run.cfg, tokens, noise, r.resolution, r.seconds, fp8=True)
               if fp8 else r.output)
        out.append((r, ref.pixel_gap(got, want)))
        del want, got
    return out


def compare(run: Run, weights: Dict[str, torch.Tensor], device: torch.device,
            sampled: int) -> Dict[str, dict]:
    """The numbers that decide ``correct``, each with its limit."""
    found = gaps(run, weights, device)
    for r, g in found:
        print(f"checked request {r.index}: {r.resolution} px, call {r.call}, "
              f"pixel gap {g:.6g}", file=sys.stderr)
    worst = max((g for _, g in found), default=None)
    return {
        "pixel_gap": {"value": worst, "limit": run.cfg["limits"]["pixel_gap"]},
        "unchecked": {"value": sampled - len(found), "limit": 0},
        "failed": {"value": sum(r.completion is None for r in run.requests), "limit": 0},
        "stamps_early": {"value": run.stamps_early, "limit": 0},
    }


def passed(checks: Dict[str, dict]) -> bool:
    """Every number read and within its limit."""
    return all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
