"""Train an LLM of the zoo: synthetic batches, the train step timed; on one
device, or sharded over a mesh of ranks.

Counterpart of ``launch/train.py``. The model is built on the device
(``cuda`` unless ``--device`` names another) from a seed; each step is
forward, backward and AdamW, timed with ``device.StageTimer`` (CUDA events
on the card).

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --smoke --steps 20 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --layers 8 --steps 10 \\
      --batch 4 --seq 2048
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch deepseek-moe-16b --smoke --mesh 2x2 --opt zero --device cpu

``--layers N`` cuts the depth to N layers. ``--mesh DxM`` (data x model)
and the ``--opt`` switches (zero: the AdamW moments sharded over data;
fsdp: the parameters too; seqshard: the residual stream sharded over
(data, model) in the training pass) shard the train state with the
partition rules (``sharding.partition``) over a ``torch.distributed`` world
started by ``torchrun``; the mesh must hold exactly its ranks (one process
alone is a world of 1). The backend (``--backend``) is ``nccl`` on ``cuda``
where each of a node's ranks (``LOCAL_WORLD_SIZE``) has a card of its own,
else ``gloo`` (the CPU, or several ranks sharing a card); the first line
prints it, and on ``cuda`` how many ranks share each card. nccl with more
ranks on a node than cards is refused. In torch 2.11 gloo's
functional all-gather on CUDA tensors, which DTensor's redistributions
call, ends the rank (SIGSEGV), so ranks sharing a card cannot run the
sharded step there; on the CPU they can. Rank 0 prints the step lines.
Without ``--mesh`` (or with ``1x1``) and ``--opt``, one process trains on
one device, with no process group.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import tempfile
from typing import FrozenSet, List, Optional, Sequence, Tuple

import torch

from repro_torch import device as _device
from repro_torch.data import pipeline
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer
from repro_torch.models.common import ModelConfig
from repro_torch.sharding import partition
from repro_torch.training import loop

OPTS = ("zero", "fsdp", "seqshard")


def run(cfg: ModelConfig, steps: int, batch: int, seq: int, device=None, log_every: int = 5,
        seed: int = 0, mesh=None, opts: FrozenSet[str] = frozenset(),
        verbose: bool = True) -> Tuple[loop.TrainState, List[dict]]:
    """``steps`` train steps of ``cfg`` on ``device`` on synthetic batches of
    ``batch`` x ``seq`` tokens -> (the state, one row per step: its metrics
    as floats, ``step`` and ``ms``). On ``mesh`` the state is sharded with
    ``opts``. Prints every ``log_every``-th row and the last if ``verbose``."""
    dev = _device.resolve(device)
    state = loop.init_state(cfg, seed, dev, mesh=mesh, zero="zero" in opts, fsdp="fsdp" in opts)
    if "seqshard" in opts:
        transformer.set_activation_sharding(partition.P("data", "model", None))
    step_fn = loop.make_train_step(cfg)
    dcfg = pipeline.DataConfig(batch=batch, seq_len=seq)
    rows = []
    try:
        for i in range(steps):
            b = pipeline.to_tensors(pipeline.synthetic_batch(cfg, dcfg, i), dev)
            with _device.StageTimer(dev) as timer:
                state, metrics = step_fn(state, b)
            row = {"step": i, "ms": timer.ms(), **{k: float(v) for k, v in metrics.items()}}
            rows.append(row)
            if verbose and (i % log_every == 0 or i == steps - 1):
                print(f"step {i:4d} loss {row['loss']:.4f} gnorm {row['grad_norm']:.2f} "
                      f"lr {row['lr']:.2e} {row['ms']:.1f} ms", flush=True)
    finally:
        transformer.set_activation_sharding(None)
    return state, rows


def local_world() -> int:
    """The ranks on this node: ``LOCAL_WORLD_SIZE`` (``torchrun`` sets it),
    else the world size."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))


def default_backend(dev: torch.device, local: int) -> str:
    """``nccl`` on ``cuda`` when each of this node's ``local`` ranks has a
    card of its own, else ``gloo`` (NCCL does not put two ranks on one
    card)."""
    return "nccl" if dev.type == "cuda" and local <= torch.cuda.device_count() else "gloo"


def card_of_rank(dev: torch.device, backend: str) -> torch.device:
    """This rank's card: ``LOCAL_RANK``'s, or under gloo with more ranks on
    the node than cards, the cards shared in turn; nccl with more ranks on
    the node than cards is refused."""
    local, cards = local_world(), torch.cuda.device_count()
    if local > cards and backend == "nccl":
        raise SystemExit(f"--backend nccl: {local} ranks on this node and {cards} card(s); "
                         f"NCCL puts one rank on each card (--backend gloo shares them)")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")) % cards)


def _start_world(backend: Optional[str], dev: torch.device) -> Tuple[str, torch.device, bool]:
    """Join the world ``torchrun`` describes in the environment, or start a
    world of one -> (backend, this rank's device, whether this call started
    the group)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_backend(), dev, False
    backend = backend or default_backend(dev, local_world())
    if dev.type == "cuda":
        dev = card_of_rank(dev, backend)
        torch.cuda.set_device(dev)
    if "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend)
    else:
        path = os.path.join(tempfile.mkdtemp(prefix="train-world-"), "rendezvous")
        dist.init_process_group(backend, init_method=f"file://{path}", world_size=1, rank=0)
    return backend, dev, True


def main(argv: Optional[Sequence[str]] = None) -> Tuple[loop.TrainState, List[dict]]:
    import repro_torch.configs as C

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=list(C.ARCH_IDS))
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--mesh", default=None,
                    help="DxM data x model mesh over the torch.distributed world "
                         "(default: every rank x 1)")
    ap.add_argument("--opt", default="", help="comma list: zero,fsdp,seqshard")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="nccl on cuda where each rank has a card of its own, else gloo")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--layers", type=int, default=None, help="cut the depth to this many layers")
    args = ap.parse_args(argv)
    opts = frozenset(o for o in args.opt.split(",") if o)
    if opts - set(OPTS):
        raise SystemExit(f"--opt {args.opt}: the switches are {','.join(OPTS)}")
    cfg = C.get_smoke(args.arch) if args.smoke else C.get(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    dev = _device.resolve(args.device)
    sharded = (args.mesh not in (None, "1x1") or opts
               or int(os.environ.get("WORLD_SIZE", "1")) > 1)
    if not sharded:
        print(f"arch={cfg.name} layers={cfg.num_layers} batch={args.batch} seq={args.seq} "
              f"device={dev}", flush=True)
        state, rows = run(cfg, args.steps, args.batch, args.seq, dev, args.log_every)
    else:
        import torch.distributed as dist

        backend, dev, started = _start_world(args.backend, dev)
        try:
            world, rank = dist.get_world_size(), dist.get_rank()
            d, m = ((int(x) for x in args.mesh.split("x")) if args.mesh else (world, 1))
            if d * m != world:
                raise SystemExit(f"--mesh {d}x{m} needs {d * m} ranks; the world size is "
                                 f"{world} (start it with torchrun --nproc-per-node {d * m})")
            mesh = mesh_lib.build(mesh_lib.MeshShape(mesh_lib.AXES, (d, m)), dev.type)
            if rank == 0:
                shared = (f" ranks_per_card={-(-local_world() // torch.cuda.device_count())}"
                          if dev.type == "cuda" else "")
                print(f"arch={cfg.name} layers={cfg.num_layers} batch={args.batch} "
                      f"seq={args.seq} device={dev} mesh={d}x{m} world={world} "
                      f"backend={backend} opts={sorted(opts)}{shared}", flush=True)
            state, rows = run(cfg, args.steps, args.batch, args.seq, dev, args.log_every,
                              mesh=mesh, opts=opts, verbose=rank == 0)
        finally:
            if started:
                dist.destroy_process_group()
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in rows):
        raise SystemExit("a step's loss or gradient norm is not finite")
    return state, rows


if __name__ == "__main__":
    main()
