"""Serve internvl2-2b: text prompts behind a stub vision prefix, batched
through the ServeEngine (prefill of [prefix; text], then greedy decode).

The prefix is ``vlm.vision_stub_embeds``' 256 patch embeddings of 1024
dims (one 448 px tile), drawn from a seed, projected by the model's
``vision_proj``. The model is built on the device from a seed.

  PYTHONPATH=src python -m repro_torch.launch.serve_vlm --device cpu --smoke
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence

import torch

from repro_torch.launch import serve_llm
from repro_torch.models import transformer, vlm
from repro_torch.models.common import ModelConfig
from repro_torch.serving.engine import GenRequest


def requests_from_seed(cfg: ModelConfig, n: int, lengths: Sequence[int], max_new: int,
                       seed: int = 0) -> List[GenRequest]:
    """``serve_llm.requests_from_seed``'s text prompts, each behind its own
    stub patch embeddings (N(0, 1) x 0.02, drawn from ``seed`` on the CPU)."""
    reqs = serve_llm.requests_from_seed(cfg.vocab_size, n, lengths, max_new, seed)
    g = torch.Generator().manual_seed(seed)
    for r in reqs:
        r.prefix = vlm.vision_stub_embeds(cfg, 1, g)[0].numpy()
    return reqs


def main(argv: Optional[Sequence[str]] = None) -> None:
    import repro_torch.configs as C

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="internvl2-2b",
                    choices=[a for a in C.ARCH_IDS if C.get(a).modality == "vision"])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true", help="the reduced same-family config")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--lengths", type=serve_llm._lengths, default=None,
                    help="LO,HI: text prompt lengths uniform in [LO, HI]")
    args = ap.parse_args(argv)
    cfg = C.get_smoke(args.arch) if args.smoke else C.get(args.arch)
    lengths = args.lengths or ((4, 16) if args.smoke else (256, 2048))
    reqs = requests_from_seed(cfg, args.requests, lengths, args.max_new)
    model = transformer.build(cfg, args.device)
    serve_llm.warm(model, reqs)
    t0 = time.perf_counter()
    recs = serve_llm.serve(cfg, reqs, device=args.device, model=model)
    dt = time.perf_counter() - t0
    toks = sum(len(r["tokens"]) for r in recs)
    print(f"arch={cfg.name}: served {len(recs)} requests behind {cfg.vision_tokens} patch "
          f"embeddings, {toks} tokens in {dt:.2f} s")
    for r in recs:
        print(f"  rid={r['rid']} prompt_len={r['prompt_len']} group={r['group_size']} "
              f"prefill_ms={r['prefill_ms']:.2f} decode_ms_per_token="
              f"{r['decode_ms_per_token']:.2f} tokens={r['tokens'].tolist()}")


if __name__ == "__main__":
    main()
