"""Serve diffusion requests stage by stage with the TridentServe planners.

Counterpart of ``examples/quickstart.py``: the pipeline is built on the
device from a seed, the Dynamic Orchestrator places stage replicas on the
chips, the Resource-Aware Dispatcher dispatches the pending requests onto
idle units, and each decision's Encode -> Diffuse -> Decode runs on the
device with every stage timed.

  PYTHONPATH=src python -m repro_torch.launch.quickstart --pipeline flux --device cpu --smoke

``--pipeline`` is one of sd3 (the default), flux, cogvideox and hunyuanvideo.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.dispatcher import Dispatcher
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.profiler import H100_SXM, Profiler
from repro_torch.core.request import STAGES, Request
from repro_torch.models import pipeline as pl

# The (resolution, seconds) classes served on one chip: classes of the
# reference's MIXES[pipeline]["light"] (core/workloads.py). The heavier ones
# (flux at 2048-4096 px, cogvideox at 720 px or past 2 s, hunyuanvideo at
# 720 px or past 1 s) are not served yet.
REQUESTS = {
    "sd3": ((512, 0.0), (1024, 0.0), (1536, 0.0)),
    "flux": ((512, 0.0), (1024, 0.0)),
    "cogvideox": ((480, 2.0),),
    "hunyuanvideo": ((540, 1.0),),
}


def smoke_requests(pipeline: str) -> tuple:
    """REQUESTS[pipeline] scaled down for the SMOKE configs: an eighth of the
    side, half the seconds (the videos keep two or more latent frames)."""
    return tuple((res // 8, sec / 2) for res, sec in REQUESTS[pipeline])


@torch.no_grad()
def warm(pipe: pl.Pipeline, requests: Sequence[Request]) -> None:
    """Run each (resolution, seconds, prompt length) class of ``requests``
    once, untimed, with one denoising step, so that the first calls at each
    shape (library plan choice, allocator growth) fall outside the stage
    times ``serve`` reports."""
    dev = pipe.dit.x_in.device
    gen = _device.generator(dev, 0)
    for res, sec, cond_len in dict.fromkeys((r.resolution, r.seconds, r.cond_len)
                                            for r in requests):
        toks = torch.zeros((1, cond_len), dtype=torch.long, device=dev)
        pl.generate(pipe, toks, res, sec, generator=gen, num_steps=1)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cfg: pl.PipelineConfig, requests: Sequence[Request], device=None, seed: int = 0,
          pipe: Optional[pl.Pipeline] = None) -> List[Dict]:
    """Serve ``requests`` on one chip: ``device``, ``cuda`` by default.

    Returns one record per request, in the order given: its output pixels,
    the measured ms of each stage (``stage_ms``), the profiler's prediction
    for the same stage on ``H100_SXM`` (``predicted_ms``) and the dispatch
    decision. ``pipe`` may carry an already built pipeline; otherwise one is
    built from ``seed``.
    """
    dev = _device.resolve(device)
    if pipe is None:
        pipe = pl.build(cfg, dev, seed)
    prof = Profiler(cfg, hw=H100_SXM)
    for r in requests:
        if not r.deadline:
            r.deadline = r.arrival + 2.5 * prof.pipeline_time(r)
    plan = Orchestrator(prof, num_chips=1).generate(requests)
    if plan is None:
        raise RuntimeError(f"no feasible placement of {cfg.name} on one chip")
    disp = Dispatcher(prof)

    rng = np.random.default_rng(seed)
    index = {r.rid: i for i, r in enumerate(requests)}
    tokens = {r.rid: torch.from_numpy(rng.integers(0, cfg.encoder.vocab_size, size=r.cond_len))
              for r in requests}
    records: List[Optional[Dict]] = [None] * len(requests)
    pending = list(requests)
    idle = set(range(plan.num_units))
    free_at = {g: 0.0 for g in idle}
    t_start = time.perf_counter()
    while pending:
        tau = time.perf_counter() - t_start
        decisions = disp.dispatch(pending, plan, idle, free_at, tau)
        if not decisions:
            raise RuntimeError(f"the dispatcher placed none of {len(pending)} pending requests")
        for d in decisions:
            batch = [d.request, *d.corequests]
            req = d.request
            toks = torch.stack([tokens[r.rid] for r in batch]).to(dev)
            grid = cfg.latent_grid(req.resolution, req.seconds)
            shape = (len(batch), cfg.latent_tokens(req.resolution, req.seconds),
                     cfg.dit.latent_dim)
            noise = torch.randn(shape, dtype=torch.float32, device=dev,
                                generator=_device.generator(dev, seed + 1 + index[req.rid]))
            timers = {s: _device.StageTimer(dev) for s in STAGES}
            with timers["E"]:
                cond = pl.encode(pipe, toks)
            with timers["D"]:
                lat = pl.diffuse(pipe, cond, shape, noise=noise)
            with timers["C"]:
                out = pl.decode(pipe, lat, grid)
            stage_ms = {s: timers[s].ms() for s in STAGES}
            k = prof.k_min
            chips = {"E": max(1, len(d.e_units)) * k, "D": d.degree * k,
                     "C": max(1, len(d.c_units)) * k}
            frames = out.shape[0] // len(batch)
            for j, r in enumerate(batch):
                done = time.perf_counter() - t_start
                for s in STAGES:
                    r.stage_done[s] = done
                records[index[r.rid]] = {
                    "rid": r.rid, "resolution": r.resolution, "seconds": r.seconds,
                    "batch": len(batch),
                    "output": out[j * frames:(j + 1) * frames],
                    "stage_ms": stage_ms,
                    "predicted_ms": {s: prof.stage_time(r, s, chips[s]) * 1e3 for s in STAGES},
                    "decision": {"vr_type": d.vr_type, "degree": d.degree,
                                 "d_units": d.d_units, "e_units": d.e_units,
                                 "c_units": d.c_units},
                }
                pending.remove(r)
    return records


def main(argv: Optional[Sequence[str]] = None) -> None:
    import repro_torch.configs as C

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pipeline", default="sd3", choices=list(C.PIPELINE_IDS))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true", help="the reduced same-family pipeline")
    args = ap.parse_args(argv)
    cfg = C.get_smoke(args.pipeline) if args.smoke else C.get(args.pipeline)
    classes = smoke_requests(args.pipeline) if args.smoke else REQUESTS[args.pipeline]
    reqs = [Request(cfg.name, res, sec) for res, sec in classes]
    pipe = pl.build(cfg, args.device)
    warm(pipe, reqs)
    for rec in serve(cfg, reqs, device=args.device, pipe=pipe):
        print(f"res={rec['resolution']} s={rec['seconds']} out={tuple(rec['output'].shape)} "
              f"stage_ms={ {s: round(v, 3) for s, v in rec['stage_ms'].items()} } "
              f"decision={rec['decision']}")


if __name__ == "__main__":
    main()
