"""Train a small decoder LM for a few hundred steps, end to end.

Counterpart of ``examples/train_llm.py``. The default is a ~5M-parameter
model sized for a CPU; ``--preset 100m`` gives the ~100M configuration for
the card. The loss is logged every 10 steps and must fall; the train state
(parameters and AdamW moments) is written to a checkpoint at the end.

  PYTHONPATH=src python -m repro_torch.launch.train_llm --device cpu --steps 200
  PYTHONPATH=src python -m repro_torch.launch.train_llm --preset 100m --steps 200
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import Optional, Sequence

import torch

from repro_torch.data import pipeline
from repro_torch.models import transformer
from repro_torch.training import checkpoint, loop
from repro_torch.training.optimizer import AdamWConfig

PRESETS = {
    "tiny": dict(d_model=128, num_layers=4, num_heads=4, num_kv_heads=2,
                 head_dim=32, d_ff=512, vocab_size=2048),
    "100m": dict(d_model=768, num_layers=12, num_heads=12, num_kv_heads=4,
                 head_dim=64, d_ff=3072, vocab_size=32768),
}


def main(argv: Optional[Sequence[str]] = None):
    """-> (the train state, the history, the checkpoint's path)."""
    import repro_torch.configs as C

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="yi-9b", choices=list(C.ARCH_IDS))
    ap.add_argument("--preset", default="tiny", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "repro_torch_llm.pt"))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(C.get_smoke(args.arch), **PRESETS[args.preset],
                              dtype=torch.float32)
    n = sum(p.numel() for p in transformer.Transformer(cfg, "meta").parameters())
    print(f"arch={cfg.name} params={n / 1e6:.1f}M pattern={cfg.layer_pattern} "
          f"layers={cfg.num_layers}", flush=True)

    dcfg = pipeline.DataConfig(batch=args.batch, seq_len=args.seq)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    state, history = loop.train(cfg, pipeline.iterator(cfg, dcfg), args.steps, ocfg=ocfg,
                                log_every=10, device=args.device)
    for h in history:
        print(f"  step {h['step']:4d}  loss {h['loss']:.4f}  lr {h['lr']:.2e}  "
              f"wall {h['wall']:.1f}s", flush=True)
    if not history[-1]["loss"] < history[0]["loss"]:
        raise SystemExit(f"loss must decrease: {history[0]['loss']} -> {history[-1]['loss']}")
    checkpoint.save_state(args.ckpt, state)
    print(f"checkpoint written to {args.ckpt}", flush=True)
    return state, history, args.ckpt


if __name__ == "__main__":
    main()
