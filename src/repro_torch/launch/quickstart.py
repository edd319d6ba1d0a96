"""Serve diffusion requests stage by stage with the TridentServe planners.

Counterpart of ``examples/quickstart.py``: the pipeline is built on the
device from a seed, the Dynamic Orchestrator places stage replicas on the
chips, the Resource-Aware Dispatcher dispatches the pending requests onto
idle units, and each decision's Encode -> Diffuse -> Decode runs on the
device with every stage timed.

  PYTHONPATH=src python -m repro_torch.launch.quickstart --pipeline flux --device cpu --smoke
  PYTHONPATH=src python -m repro_torch.launch.quickstart --pipeline cogvideox --heavy 720x10 \\
      --num-steps 1

``--pipeline`` is one of sd3 (the default), flux, cogvideox and hunyuanvideo,
or the port-only hunyuanvideo-t2v (HunyuanVideo's released DiT; 540 px x
1 s, no HEAVY classes). Without ``--heavy`` it serves the pipeline's
REQUESTS classes; ``--heavy`` serves classes of HEAVY, and ``--num-steps``
cuts every DDIM loop (the records then carry the steps, and the Diffuse
prediction is scaled to them).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch import trace
from repro_torch.core.dispatcher import Dispatcher
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.profiler import H100_SXM, Profiler
from repro_torch.core.request import STAGES, Request
from repro_torch.models import pipeline as pl

# Table 5's (resolution, seconds) classes (core/workloads.py MIXES), split
# in two. REQUESTS: the classes served whole, with all their steps, from
# sd3 and flux at 128 px up to the middle of each mix. HEAVY: the rest, up
# to flux at 4096 px (65613 DiT tokens) and cogvideox at 720 px x 10 s
# (81077), whose Diffuse runs for seconds a step on one H100.
REQUESTS = {
    "sd3": ((128, 0.0), (256, 0.0), (512, 0.0), (1024, 0.0), (1536, 0.0)),
    "flux": ((128, 0.0), (256, 0.0), (512, 0.0), (1024, 0.0)),
    "cogvideox": ((480, 2.0),),
    "hunyuanvideo": ((540, 1.0),),
    "hunyuanvideo-t2v": ((540, 1.0),),      # port-only, outside Table 5
}
HEAVY = {
    "sd3": (),
    "flux": ((2048, 0.0), (3072, 0.0), (4096, 0.0)),
    "cogvideox": ((480, 4.0), (480, 8.0), (480, 10.0), (720, 2.0), (720, 4.0), (720, 8.0),
                  (720, 10.0)),
    "hunyuanvideo": ((540, 2.0), (540, 4.0), (540, 8.0), (720, 1.0), (720, 2.0), (720, 4.0),
                     (720, 8.0)),
}
STAGE_SPANS = {"E": "encode", "D": "diffuse", "C": "decode"}   # each stage's span when traced


def smoke_requests(pipeline: str, table: Optional[Dict] = None) -> tuple:
    """``table[pipeline]`` (REQUESTS by default, or HEAVY) scaled down for the
    SMOKE configs (``smoke_classes``)."""
    return smoke_classes((table or REQUESTS)[pipeline])


def smoke_classes(classes) -> tuple:
    """(resolution, seconds) classes at the SMOKE configs' geometry: an
    eighth of the side, half the seconds (the videos keep two or more latent
    frames)."""
    return tuple((res // 8, sec / 2) for res, sec in classes)


def predicted_ms(prof: Profiler, req: Request, stage: str, chips: int,
                 num_steps: Optional[int] = None) -> float:
    """The profiler's ms for one stage of ``req`` on ``chips`` chips. With
    ``num_steps``, Diffuse runs that many DDIM steps instead of the
    config's: its FLOPs and bytes are linear in the steps, the dispatch
    overhead is paid once a stage, so only the steps' part is scaled."""
    t = prof.stage_time(req, stage, chips)
    if stage == "D" and num_steps is not None:
        fixed = prof.hw.dispatch_overhead
        t = fixed + (t - fixed) * num_steps / prof.cfg.num_steps
    return t * 1e3


@torch.no_grad()
def warm(pipe: pl.Pipeline, requests: Sequence[Request]) -> None:
    """Run each (resolution, seconds, prompt length) class of ``requests``
    once, untimed, with one denoising step, so that the first calls at each
    shape (library plan choice, allocator growth, on a card the capture of
    its Encode and DDIM step graphs) fall outside the stage times ``serve``
    reports."""
    dev = pipe.dit.x_out.device
    gen = _device.generator(dev, 0)
    for res, sec, cond_len in dict.fromkeys((r.resolution, r.seconds, r.cond_len)
                                            for r in requests):
        toks = torch.zeros((1, cond_len), dtype=torch.long, device=dev)
        pl.generate(pipe, toks, res, sec, generator=gen, num_steps=1)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cfg: pl.PipelineConfig, requests: Sequence[Request], device=None, seed: int = 0,
          pipe: Optional[pl.Pipeline] = None, num_steps: Optional[int] = None) -> List[Dict]:
    """Serve ``requests`` on one chip: ``device``, ``cuda`` by default.

    Returns one record per request, in the order given: its output pixels,
    the measured ms of each stage (``stage_ms``), the profiler's prediction
    for the same stage on ``H100_SXM`` (``predicted_ms``), the DDIM steps
    its Diffuse ran (``num_steps``: the config's, or the ``num_steps`` given
    to cut the loop) and the dispatch decision. ``pipe`` may carry an
    already built pipeline; otherwise one is built from ``seed``.

    While a profiler session is active the call records its spans
    (``repro_torch.trace``): ``serve``, ``plan``, each ``dispatch`` round,
    each ``launch`` with its stages (``STAGE_SPANS``), their DDIM ``step``
    spans and the ``sync`` on the stage timers.
    """
    dev = _device.resolve(device)
    with trace.span("serve", anchor=dev, requests=len(requests), seed=seed):
        return _serve(cfg, requests, dev, seed, pipe, num_steps)


def _serve(cfg: pl.PipelineConfig, requests: Sequence[Request], dev: torch.device, seed: int,
           pipe: Optional[pl.Pipeline], num_steps: Optional[int]) -> List[Dict]:
    if pipe is None:
        pipe = pl.build(cfg, dev, seed)
    with trace.span("plan") as sp:
        prof = Profiler(cfg, hw=H100_SXM)
        for r in requests:
            if not r.deadline:
                r.deadline = r.arrival + 2.5 * prof.pipeline_time(r)
        plan = Orchestrator(prof, num_chips=1).generate(requests)
        if plan is None:
            raise RuntimeError(f"no feasible placement of {cfg.name} on one chip")
        disp = Dispatcher(prof)
        sp.set(units=plan.num_units)

    rng = np.random.default_rng(seed)
    index = {r.rid: i for i, r in enumerate(requests)}
    tokens = {r.rid: torch.from_numpy(rng.integers(0, cfg.encoder.vocab_size, size=r.cond_len))
              for r in requests}
    records: List[Optional[Dict]] = [None] * len(requests)
    pending = list(requests)
    idle = set(range(plan.num_units))
    free_at = {g: 0.0 for g in idle}
    steps = num_steps or cfg.num_steps
    t_start = time.perf_counter()
    while pending:
        tau = time.perf_counter() - t_start
        with trace.span("dispatch", pending=len(pending)) as sp:
            decisions = disp.dispatch(pending, plan, idle, free_at, tau)
            sp.set(decisions=len(decisions),
                   corequests=sum(len(d.corequests) for d in decisions))
        if not decisions:
            raise RuntimeError(f"the dispatcher placed none of {len(pending)} pending requests")
        for d in decisions:
            batch = [d.request, *d.corequests]
            req = d.request
            with trace.span("launch", rids=[r.rid for r in batch], batch=len(batch),
                            resolution=req.resolution, seconds=req.seconds, steps=steps):
                toks = torch.stack([tokens[r.rid] for r in batch]).to(dev)
                grid = cfg.latent_grid(req.resolution, req.seconds)
                shape = (len(batch), cfg.latent_tokens(req.resolution, req.seconds),
                         cfg.dit.latent_dim)
                noise = torch.randn(shape, dtype=torch.float32, device=dev,
                                    generator=_device.generator(dev, seed + 1 + index[req.rid]))
                # only a DiT that reads the grid is handed it: the uniform DiT's Diffuse keeps
                # its former call, so wrappers of pl.diffuse with that signature still serve it
                at = {"grid": grid} if pipe.dit.reads_grid else {}
                timers = {s: _device.StageTimer(dev, span=STAGE_SPANS[s]) for s in STAGES}
                with timers["E"]:
                    cond = pl.encode(pipe, toks)
                with timers["D"]:
                    lat = pl.diffuse(pipe, cond, shape, num_steps=num_steps, noise=noise, **at)
                with timers["C"]:
                    out = pl.decode(pipe, lat, grid)
                with trace.span("sync"):
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
                        "batch": len(batch), "num_steps": steps,
                        "output": out[j * frames:(j + 1) * frames],
                        "stage_ms": stage_ms,
                        "predicted_ms": {s: predicted_ms(prof, r, s, chips[s], num_steps)
                                         for s in STAGES},
                        "decision": {"vr_type": d.vr_type, "degree": d.degree,
                                     "d_units": d.d_units, "e_units": d.e_units,
                                     "c_units": d.c_units},
                    }
                    pending.remove(r)
    return records


def heavy_classes(pipeline: str, spec: str) -> tuple:
    """The HEAVY classes ``spec`` names: ``all``, or a comma list of RES or
    RESxSEC (``720x10``), each of which must be one of HEAVY[pipeline]."""
    table = HEAVY.get(pipeline, ())
    if spec == "all":
        return table
    out = []
    for item in spec.split(","):
        res, _, sec = item.partition("x")
        cls = (int(res), float(sec or 0.0))
        if cls not in table:
            raise ValueError(f"{pipeline} has no heavy class {item}: {table}")
        out.append(cls)
    return tuple(out)


def main(argv: Optional[Sequence[str]] = None) -> None:
    import repro_torch.configs as C

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pipeline", default="sd3", choices=list(REQUESTS))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true", help="the reduced same-family pipeline")
    ap.add_argument("--heavy", default=None, metavar="RES[xSEC],...",
                    help="serve these classes of HEAVY (e.g. 4096 or 720x10; 'all' for "
                         "every one) instead of REQUESTS")
    ap.add_argument("--num-steps", type=int, default=None,
                    help="cut each request's DDIM loop to this many steps")
    args = ap.parse_args(argv)
    cfg = C.get_smoke(args.pipeline) if args.smoke else C.get(args.pipeline)
    classes = REQUESTS[args.pipeline]
    if args.heavy:
        classes = heavy_classes(args.pipeline, args.heavy)
    if args.smoke:
        classes = smoke_classes(classes)
    reqs = [Request(cfg.name, res, sec) for res, sec in classes]
    pipe = pl.build(cfg, args.device)
    warm(pipe, reqs)
    for rec in serve(cfg, reqs, device=args.device, pipe=pipe, num_steps=args.num_steps):
        print(f"res={rec['resolution']} s={rec['seconds']} steps={rec['num_steps']} "
              f"out={tuple(rec['output'].shape)} "
              f"stage_ms={ {s: round(v, 3) for s, v in rec['stage_ms'].items()} } "
              f"decision={rec['decision']}")


if __name__ == "__main__":
    main()
