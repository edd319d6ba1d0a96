"""Train an LLM of the zoo on one device: synthetic batches, the train step
timed.

Counterpart of ``launch/train.py``'s single-device part. The model is built
on the device (``cuda`` unless ``--device`` names another) from a seed; each
step is forward, backward and AdamW, timed with ``device.StageTimer`` (CUDA
events on the card).

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --smoke --steps 20 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --layers 8 --steps 10 \\
      --batch 4 --seq 2048

``--layers N`` cuts the depth to N layers. A mesh other than 1x1 and the
``--opt`` switches (zero, fsdp, seqshard) shard the train state: they come
with the sharding slice (ROADMAP queue 1, sharding), and are refused here.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

from repro_torch import device as _device
from repro_torch.data import pipeline
from repro_torch.models.common import ModelConfig
from repro_torch.training import loop

SHARDING = "it shards the train state, which comes with the sharding slice (ROADMAP queue 1)"


def run(cfg: ModelConfig, steps: int, batch: int, seq: int, device=None, log_every: int = 5,
        seed: int = 0) -> Tuple[loop.TrainState, List[dict]]:
    """``steps`` train steps of ``cfg`` on ``device`` on synthetic batches of
    ``batch`` x ``seq`` tokens -> (the state, one row per step: its metrics
    as floats, ``step`` and ``ms``). Prints every ``log_every``-th row and
    the last."""
    dev = _device.resolve(device)
    state = loop.init_state(cfg, seed, dev)
    step_fn = loop.make_train_step(cfg)
    dcfg = pipeline.DataConfig(batch=batch, seq_len=seq)
    rows = []
    for i in range(steps):
        b = pipeline.to_tensors(pipeline.synthetic_batch(cfg, dcfg, i), dev)
        with _device.StageTimer(dev) as timer:
            state, metrics = step_fn(state, b)
        row = {"step": i, "ms": timer.ms(), **{k: float(v) for k, v in metrics.items()}}
        rows.append(row)
        if i % log_every == 0 or i == steps - 1:
            print(f"step {i:4d} loss {row['loss']:.4f} gnorm {row['grad_norm']:.2f} "
                  f"lr {row['lr']:.2e} {row['ms']:.1f} ms", flush=True)
    return state, rows


def main(argv: Optional[Sequence[str]] = None) -> Tuple[loop.TrainState, List[dict]]:
    import repro_torch.configs as C

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=list(C.ARCH_IDS))
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--mesh", default=None, help="DxM data x model mesh: only 1x1 here")
    ap.add_argument("--opt", default="", help="zero,fsdp,seqshard: none here")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--layers", type=int, default=None, help="cut the depth to this many layers")
    args = ap.parse_args(argv)
    if args.mesh not in (None, "1x1"):
        raise SystemExit(f"--mesh {args.mesh}: {SHARDING}")
    if args.opt:
        raise SystemExit(f"--opt {args.opt}: {SHARDING}")
    cfg = C.get_smoke(args.arch) if args.smoke else C.get(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    print(f"arch={cfg.name} layers={cfg.num_layers} batch={args.batch} seq={args.seq} "
          f"device={_device.resolve(args.device)}", flush=True)
    state, rows = run(cfg, args.steps, args.batch, args.seq, args.device, args.log_every)
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in rows):
        raise SystemExit("a step's loss or gradient norm is not finite")
    return state, rows


if __name__ == "__main__":
    main()
