"""Paper-side dry run: the diffusion pipeline *stages* (the models
TridentServe serves) on the production mesh, on ``meta`` over a fake world.

Counterpart of ``repro/launch/dryrun_pipeline.py``. For each pipeline and
a representative request class (``CASES``: resolution, seconds, batch) it
runs one Diffuse denoise step (``DiT.forward``, the unit the dispatcher's
t_{r,i,k} measures) and one Decode pass (the port's 2D decoder, frames in
the batch) once under the counter (``roofline.counts``) on a fake 16x16
world, and prices one device's counts on ``H100_SXM`` as
``launch/dryrun.py`` does, with the same record keys.

Diffuse: the DiT's parameters column- and row-sharded over ``model``
(``_dit_param_specs``), the latents over data x model (batch, tokens),
the timesteps and the condition over data; K1 runs on each rank's batch
rows and heads, K2 on its batch rows. Decode: the latents' frames over
data x model where they divide the 256 ranks (the video cases), else over
data; the reference then splits the image's height over ``model``, which
DTensor's convolution cannot (it has no halo exchange), so an image's
Decode runs whole on each rank of a model group.

  PYTHONPATH=src python -m repro_torch.launch.dryrun_pipeline --pipeline sd3
  PYTHONPATH=src python -m repro_torch.launch.dryrun_pipeline \\
      --out results/torch_dryrun_pipelines.jsonl
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from typing import Optional

import torch

import repro_torch.configs as configs
from repro_torch.core.profiler import H100_SXM
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import diffusion
from repro_torch.sharding import partition, spmd
from repro_torch.sharding.partition import P

CASES = {
    "sd3": (1024, 0.0, 16),
    "flux": (2048, 0.0, 16),
    "cogvideox": (720, 4.0, 16),
    "hunyuanvideo": (720, 4.0, 16),
}
COND_LEN = 77
META = torch.device("meta")


def _div_axis(size: int, axis: str, sizes: dict):
    return axis if size % sizes[axis] == 0 else None


def _dit_param_specs(model: torch.nn.Module) -> dict:
    """The reference's DiT layout: q/k/v, the MLP's up projection and the
    modulation column-sharded over ``model``, the output projections
    row-sharded, the rest replicated."""
    col = {"wq", "wk", "wv", "w_up", "mod"}
    row = {"wo", "w_down"}
    specs = {}
    for name, p in model.named_parameters():
        leaf = name.split(".")[-1]
        specs[name] = (P(None, "model") if leaf in col else P("model", None) if leaf in row
                       else P(*([None] * p.dim())))
    return specs


def stage_spec(pid: str, stage: str, cfg=None, case=None, mesh_shape=None):
    """(step fn, the function placing its meta arguments on a mesh, model
    FLOPs) of one stage ("D" or "C") of ``pid`` at ``case`` (default
    ``CASES``)."""
    cfg = cfg if cfg is not None else configs.get(pid)
    res, sec, batch = case or CASES[pid]
    sizes = (mesh_shape or mesh_lib.make_production_mesh()).shape
    chips = 1
    for s in sizes.values():
        chips *= s
    lt = cfg.latent_tokens(res, sec)
    if stage == "D":
        model = diffusion.DiT(cfg.dit, META)
        args = (model, torch.empty((batch, lt, cfg.dit.latent_dim), device=META),
                torch.empty((batch,), device=META),
                torch.empty((batch, COND_LEN, cfg.dit.cond_dim), device=META))
        da = _div_axis(batch, "data", sizes)
        specs = (P(da, _div_axis(lt, "model", sizes), None), P(da), P(da, None, None))

        def shard(mesh):
            partition.distribute_model(
                model, partition.validate_divisibility(_dit_param_specs(model),
                                                       dict(model.named_parameters()), mesh),
                mesh)
            return (model,) + tuple(partition.distribute(a, s, mesh) for a, s in
                                    zip(args[1:], specs))

        n = sum(p.numel() for p in model.parameters())
        return lambda m, x, t, c: m(x, t, c), shard, 2.0 * n * batch * (lt + COND_LEN)
    model = diffusion.Decoder(cfg.decoder, META)
    f, h, w = cfg.latent_grid(res, sec)
    bf = batch * f
    z = torch.empty((bf, 2 * h, 2 * w, cfg.decoder.latent_channels), device=META)
    zspec = P(("data", "model") if bf % chips == 0 else _div_axis(bf, "data", sizes),
              None, None, None)

    def shard(mesh):
        return model, partition.distribute(z, zspec, mesh)

    n = sum(p.numel() for p in model.parameters())
    return lambda m, zz: spmd.local(m, zz), shard, 2.0 * n * batch * f * 4 * h * w


def run_case(pid: str, out_path: Optional[str] = None, cfg=None, case=None, mesh_shape=None,
             verbose: bool = True) -> list:
    """The Diffuse and Decode records of ``pid`` (appended to ``out_path``)."""
    res, sec, _ = case or CASES[pid]
    mshape = mesh_shape or mesh_lib.make_production_mesh()
    recs = []
    for stage in ("D", "C"):
        rec = {"arch": f"{pid}-{'dit' if stage == 'D' else 'ae'}", "shape": f"{res}x{sec}",
               "mesh": "x".join(map(str, mshape.sizes)), "kind": "serve"}
        t0 = time.perf_counter()
        try:
            fn, shard, mf = stage_spec(pid, stage, cfg, case, mshape)
            mc, replicated = dryrun.counted_step(fn, mshape, shard)
            roof = dryrun.record(rec, mc, mf, mshape.size, time.perf_counter() - t0, replicated)
            if verbose:
                print(roof.row(), flush=True)
        except Exception as e:
            rec.update(status="error", error=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc()[-1500:])
            if verbose:
                print(rec["arch"], "ERROR", rec["error"][:160], flush=True)
        recs.append(rec)
        if out_path:
            with open(out_path, "a") as fo:
                fo.write(json.dumps(rec) + "\n")
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--pipeline", default=None, choices=list(CASES))
    args = ap.parse_args(argv)
    print("# " + dryrun.NODE_NOTE.format(hw=H100_SXM.name, n=H100_SXM.link_domain_chips,
                                         mesh="16x16"), flush=True)
    ok = True
    for pid in ([args.pipeline] if args.pipeline else CASES):
        ok &= all(r["status"] == "ok" for r in run_case(pid, args.out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
