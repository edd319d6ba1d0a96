"""Multi-pod dry run: run every (arch x shape x mesh) step once on ``meta``
over a fake world, and price its counts on the roofline.

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
combination for the production mesh with ``ShapeDtypeStruct`` inputs.
Here the arguments are ``meta`` tensors (``launch/specs.py``; nothing is
allocated), a fake ``torch.distributed`` world of 256 (16x16) or 512
(2x16x16) ranks stands for the mesh (``roofline.counts.fake_world``; this
process is its rank 0, and no collective moves a byte), the state is
distributed over it by the partition rules, and the step runs once under
the counter (``roofline.counts``): one device's FLOPs, HBM bytes,
collectives and peak live bytes. A call DTensor cannot shard runs on
replicated inputs (``sharding.spmd.replicate_unsupported``, and
``spmd.reshape`` for a projection that does not split into its heads; the
record's ``replicated_calls`` names them), as XLA's partitioner reshards
where it must. The record keeps the reference's keys; ``t_trace_s`` (the step's
host seconds on ``meta``) stands for its ``t_lower_s`` / ``t_compile_s``,
and ``coll_wire_bytes_total`` is one device's wire bytes, as the
reference's (which its roofline then divides by the chips once more; this
one does not). The roofline is priced on ``H100_SXM``: a group inside a
node of 8 consecutive ranks at NVLink's rate, a wider one at the NIC's;
on the production meshes every ``data`` and ``model`` group is wider.
On a ``cpu`` mesh DTensor turns a shard-to-shard redistribution into an
all-gather and a chunk (its path for gloo), and the count shows that.

Usage (no card; a train step on 2x16x16 is slow to count: DTensor
searches its redistributions over three mesh dimensions):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
      --out results/torch_dryrun_single_pod.jsonl
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k --multi-pod
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
import time
import traceback
from typing import Any, Dict, Optional

import repro_torch.configs as configs
from repro_torch.configs import INPUT_SHAPES
from repro_torch.core.profiler import H100_SXM, Hardware
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs as specs_lib
from repro_torch.models import transformer as _tf
from repro_torch.roofline import analysis as ra
from repro_torch.roofline import counts
from repro_torch.sharding import partition, spmd
from repro_torch.sharding.partition import P

OPTS = ("seqshard", "zero", "fsdp", "gqa")
NODE_NOTE = ("priced on {hw}: a collective group inside {n} consecutive ranks at link_bw, "
             "a wider one at inter_node_bw; on {mesh} every data and model group is wider")


def _data_axis(mesh, multi_pod: bool):
    daxes = tuple(a for a in mesh_lib.data_axes(multi_pod) if a in partition.axis_sizes(mesh))
    return (daxes if len(daxes) > 1 else daxes[0]), daxes


def shardings_for(spec: specs_lib.LoweringSpec, cfg, mesh, multi_pod: bool,
                  opts: frozenset = frozenset()) -> tuple:
    """The specs (``partition.P`` trees) of ``spec.args``, by the
    reference's rules.

    opts: zero — ZeRO-shard the AdamW moments over the data axis; fsdp —
    additionally shard the params over data. The batch is replicated where
    it does not divide the data axes (long_500k has a batch of 1)."""
    da, daxes = _data_axis(mesh, multi_pod)
    sizes = partition.axis_sizes(mesh)
    dsize = 1
    for a in daxes:
        dsize *= sizes[a]

    def batch_like(t):
        return P(da if t.shape[0] % dsize == 0 else None, *([None] * (t.dim() - 1)))

    if spec.kind == "train":
        state, batch = spec.args
        tree = partition.state_tree(state)
        sspec = partition.state_specs(
            cfg, tree, zero_mesh=mesh if ("zero" in opts or "fsdp" in opts) else None,
            fsdp="fsdp" in opts)
        sspec = partition.validate_divisibility(sspec, tree, mesh)
        return sspec, {k: batch_like(v) for k, v in batch.items()}

    model = spec.args[0]
    params = dict(model.named_parameters())
    pspec = partition.param_specs(cfg, params)
    if "fsdp" in opts:
        pspec = partition.zero_shard(pspec, params, mesh)
    pspec = partition.validate_divisibility(pspec, params, mesh)
    if spec.kind == "prefill":
        return (pspec,) + tuple(batch_like(a) for a in spec.args[1:])
    _, tokens, cache, _ = spec.args
    cspec = partition.cache_specs(cfg, cache, spec.batch, mesh, da)
    cspec = partition.validate_divisibility(cspec, cache, mesh)
    return pspec, batch_like(tokens), cspec, None


def place(spec: specs_lib.LoweringSpec, shardings: tuple, mesh) -> tuple:
    """``spec.args`` distributed over ``mesh`` by ``shardings``
    (``shardings_for``), each rank keeping its shard."""
    dist = partition.distribute
    if spec.kind == "train":
        state, batch = spec.args
        sspec, bspec = shardings
        state = partition.distribute_state(state, sspec, mesh)
        state.mesh = mesh
        return state, {k: dist(v, bspec[k], mesh, k) for k, v in batch.items()}
    model = partition.distribute_model(spec.args[0], shardings[0], mesh)
    if spec.kind == "prefill":
        return (model,) + tuple(dist(a, s, mesh, n) for a, s, n in
                                zip(spec.args[1:], shardings[1:], spec.arg_names[1:]))
    _, tokens, cache, offset = spec.args
    cache = [{n: dist(t, cs[n], mesh, n) for n, t in layer.items()}
             for layer, cs in zip(cache, shardings[2])]
    return model, dist(tokens, shardings[1], mesh, "tokens"), cache, offset


def counted_step(fn, mesh_shape: mesh_lib.MeshShape, shard):
    """(the counts of ``fn`` on the arguments ``shard(mesh)`` places, the
    calls run replicated) inside a fake world of ``mesh_shape``'s ranks."""
    from torch.distributed.tensor.experimental import implicit_replication

    # DTensor warns of each suboptimal redistribution it makes: the counts show them
    quiet = logging.getLogger("torch.distributed.tensor")
    level = quiet.level
    quiet.setLevel(logging.ERROR)
    try:
        with counts.fake_world(mesh_shape.size):
            placed = shard(mesh_lib.build(mesh_shape, "cpu"))
            with implicit_replication(), spmd.replicate_unsupported() as fallback:
                _, mc = counts.count(fn, *placed)
            del placed
    finally:
        quiet.setLevel(level)
    return mc, dict(fallback.calls)


def record(rec: Dict[str, Any], mc, model_flops: float, chips: int, t_trace: float,
           replicated: dict, hw: Hardware = H100_SXM) -> ra.Roofline:
    """Fill ``rec`` with the reference's keys from one device's counts."""
    roof = ra.Roofline.from_costs(rec["arch"], rec["shape"], rec["mesh"], chips, mc,
                                  model_flops, hw)
    coll = ra.collective_stats(mc)
    rec.update(status="ok", t_trace_s=round(t_trace, 2),
               hlo_flops_per_device=mc.flops, hlo_bytes_per_device=mc.hbm_bytes,
               coll_wire_bytes_total=coll.total_bytes, coll_wire_bytes_wide=roof.coll_bytes_wide,
               coll_counts=coll.counts, kernel_calls=mc.kernel_calls, model_flops=model_flops,
               t_compute_s=roof.t_compute, t_memory_s=roof.t_memory,
               t_collective_s=roof.t_collective, bottleneck=roof.bottleneck,
               useful_ratio=roof.useful_ratio, peak_mem_per_device=mc.peak_bytes,
               replicated_calls=replicated, hw=hw.name)
    return roof


def run_one(arch: str, shape_name: str, multi_pod: bool = False, verbose: bool = True,
            opts: frozenset = frozenset(), cfg=None,
            mesh_shape: Optional[mesh_lib.MeshShape] = None) -> Dict[str, Any]:
    """One combination's record. ``cfg`` and ``mesh_shape`` default to the
    arch's published config and the production mesh."""
    cfg = cfg if cfg is not None else configs.get(arch)
    if "gqa" in opts and hasattr(cfg, "gqa_grouped_decode"):
        cfg = dataclasses.replace(cfg, gqa_grouped_decode=True)
    mshape = mesh_shape or mesh_lib.make_production_mesh(multi_pod=multi_pod)
    mesh_name = "x".join(map(str, mshape.sizes))
    spec = specs_lib.input_specs(arch, shape_name, cfg=cfg)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                           "kind": spec.kind, "opts": sorted(opts)}
    if spec.skipped:
        rec["status"] = "skipped"
        rec["reason"] = spec.skipped
        return rec
    t0 = time.perf_counter()
    try:
        if "seqshard" in opts:
            da, _ = _data_axis(mshape, multi_pod)
            _tf.set_activation_sharding(P(da, "model", None))

        def shard(mesh):
            return place(spec, shardings_for(spec, cfg, mesh, multi_pod, opts), mesh)

        mc, replicated = counted_step(spec.fn, mshape, shard)
        t_trace = time.perf_counter() - t0
        mf = ra.model_flops(cfg, spec.kind, spec.batch, spec.seq_len)
        roof = record(rec, mc, mf, mshape.size, t_trace, replicated)
        if verbose:
            print(roof.row(), flush=True)
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"{arch:26s} {shape_name:12s} {mesh_name:9s} "
                  f"ERROR {type(e).__name__}: {str(e)[:200]}", flush=True)
    finally:
        _tf.set_activation_sharding(None)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=list(configs.ARCH_IDS), default=None)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) on the chosen mesh")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--opt", default="",
                    help="comma list of perf switches: " + ",".join(OPTS))
    args = ap.parse_args(argv)
    opts = frozenset(o for o in args.opt.split(",") if o)
    if opts - set(OPTS):
        ap.error(f"unknown --opt {sorted(opts - set(OPTS))}; known: {OPTS}")
    if args.all:
        combos = [(a, s) for a in configs.ARCH_IDS for s in INPUT_SHAPES]
    elif args.arch and args.shape:
        combos = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    mesh = mesh_lib.make_production_mesh(multi_pod=args.multi_pod)
    print("# " + NODE_NOTE.format(hw=H100_SXM.name, n=H100_SXM.link_domain_chips,
                                  mesh="x".join(map(str, mesh.sizes))), flush=True)
    ok = True
    for a, s in combos:
        rec = run_one(a, s, multi_pod=args.multi_pod, opts=opts)
        ok &= rec["status"] in ("ok", "skipped")
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
