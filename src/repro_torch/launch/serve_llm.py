"""Serve an LLM with batched greedy requests through the ServeEngine
(prefill + cache decode).

Counterpart of ``examples/serve_llm.py``. The model is built on the device
from a seed; requests are grouped into left-padded batches of ``max_batch``.

  PYTHONPATH=src python -m repro_torch.launch.serve_llm --device cpu --smoke --arch rwkv6-3b
  PYTHONPATH=src python -m repro_torch.launch.serve_llm --device cpu --smoke --arch gemma2-9b \
      --lengths 17,40

``--lengths LO,HI`` draws prompt lengths from [LO, HI] (default 4,16 at
``--smoke``, 256,2048 otherwise), e.g. past a model's sliding window or
llama4's attention chunk; ``--layers N`` cuts the depth to N layers
(llama4-maverick's 48 layers do not fit one card; its 4-layer cut does).
The CLI serves text models; musicgen-medium has ``launch/serve_musicgen.py``
and internvl2-2b ``launch/serve_vlm.py``. ``serve`` itself also takes
musicgen's (K, L) codebook prompts.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.models import transformer
from repro_torch.models.common import ModelConfig
from repro_torch.serving.engine import GenRequest, ServeEngine


MAX_BATCH = 4     # requests per prefill/decode group


def serve(cfg: ModelConfig, requests: Sequence[GenRequest], device=None, seed: int = 0,
          model: Optional[transformer.Transformer] = None) -> List[Dict]:
    """Serve ``requests`` on one chip: ``device``, ``cuda`` by default.

    The requests are served in groups of ``MAX_BATCH``, in the order given,
    with caches for the longest prompt (and its vision prefix) plus the most
    new tokens asked for.
    Returns one record per request, in the same order: its generated tokens,
    its group's prefill ms and decode ms per token (CUDA events on the card)
    and the group's size. ``model`` may carry an already built model;
    otherwise one is built from ``seed``.
    """
    dev = _device.resolve(device)
    if model is None:
        model = transformer.build(cfg, dev, seed)
    max_len = max(r.prompt.shape[-1] + r.max_new for r in requests) + _prefix_len(requests)
    eng = ServeEngine(model, max_batch=MAX_BATCH, max_len=max_len)
    for r in requests:
        eng.submit(r)
    while eng.queue:
        eng.step()
    return [{"rid": r.rid, "prompt_len": int(r.prompt.shape[-1]), "tokens": r.output,
             "prefill_ms": r.prefill_ms, "decode_ms_per_token": r.decode_ms_per_token,
             "group_size": r.group_size} for r in requests]


def _prefix_len(requests: Sequence[GenRequest]) -> int:
    return 0 if requests[0].prefix is None else requests[0].prefix.shape[0]


@torch.no_grad()
def warm(model: transformer.Transformer, requests: Sequence[GenRequest]) -> None:
    """One prefill and one decode step, untimed, at each padded group shape
    ``serve`` will give ``requests`` (groups of ``MAX_BATCH`` in order, caches
    of the same length), so that the first calls at each shape fall outside
    the prefill and decode times it reports. Codebook prompts (K, L) are
    warmed as (B, K, L)."""
    dev = model.embed.device
    max_len = max(r.prompt.shape[-1] + r.max_new for r in requests) + _prefix_len(requests)
    for i in range(0, len(requests), MAX_BATCH):
        group = requests[i:i + MAX_BATCH]
        length = max(r.prompt.shape[-1] for r in group)
        shape = (len(group),) + group[0].prompt.shape[:-1] + (length,)
        tokens = torch.zeros(shape, dtype=torch.long, device=dev)
        prefix = (None if group[0].prefix is None else
                  torch.zeros((len(group),) + group[0].prefix.shape, device=dev))
        logits, caches, offset = model.prefill(tokens, max_len, prefix)
        model.decode_step(tokens[..., -1:], caches, offset)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def requests_from_seed(vocab_size: int, n: int, lengths: Sequence[int], max_new: int,
                       seed: int = 0) -> List[GenRequest]:
    """``n`` requests with prompt lengths uniform in [lengths[0], lengths[1]]
    and tokens uniform in [0, vocab_size), drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.integers(lengths[0], lengths[1] + 1))
        out.append(GenRequest(rid=i, prompt=rng.integers(0, vocab_size, size=plen),
                              max_new=max_new))
    return out


def _lengths(text: str) -> tuple:
    lo, hi = (int(x) for x in text.split(","))
    if not 1 <= lo <= hi:
        raise argparse.ArgumentTypeError(f"--lengths wants 1 <= LO <= HI, got {text!r}")
    return lo, hi


def main(argv: Optional[Sequence[str]] = None) -> None:
    import repro_torch.configs as C

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="rwkv6-3b", choices=list(C.ARCH_IDS))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true", help="the reduced same-family config")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--lengths", type=_lengths, default=None,
                    help="LO,HI: prompt lengths uniform in [LO, HI]")
    ap.add_argument("--layers", type=int, default=None, help="cut the depth to this many layers")
    args = ap.parse_args(argv)
    cfg = C.get_smoke(args.arch) if args.smoke else C.get(args.arch)
    if cfg.modality != "text":
        launcher = {"audio_codec": "serve_musicgen", "vision": "serve_vlm"}[cfg.modality]
        raise SystemExit(f"{args.arch}: a {cfg.modality} model; serve it with "
                         f"python -m repro_torch.launch.{launcher}")
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    lengths = args.lengths or ((4, 16) if args.smoke else (256, 2048))
    reqs = requests_from_seed(cfg.vocab_size, args.requests, lengths, args.max_new)
    model = transformer.build(cfg, args.device)
    warm(model, reqs)
    t0 = time.perf_counter()
    recs = serve(cfg, reqs, device=args.device, model=model)
    dt = time.perf_counter() - t0
    toks = sum(len(r["tokens"]) for r in recs)
    print(f"arch={cfg.name}: served {len(recs)} requests, {toks} tokens in {dt:.2f} s")
    for r in recs:
        print(f"  rid={r['rid']} prompt_len={r['prompt_len']} group={r['group_size']} "
              f"prefill_ms={r['prefill_ms']:.2f} decode_ms_per_token="
              f"{r['decode_ms_per_token']:.2f} tokens={r['tokens'].tolist()}")


if __name__ == "__main__":
    main()
