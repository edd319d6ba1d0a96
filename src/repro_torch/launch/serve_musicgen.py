"""Audio-codec serving: MusicGen-style delayed-codebook generation behind
the EnCodec stub (one decode step predicts one frame across all four
codebooks).

Counterpart of ``examples/serve_musicgen.py``: a prefix of stub codec
frames, delayed, is prefilled; frames are decoded greedily one at a time;
the delay is undone. The model is built on the device from a seed.
``requests_from_seed`` makes delayed (K, L) prompts for
``serve_llm.serve``, which batches them through the ServeEngine.

  PYTHONPATH=src python -m repro_torch.launch.serve_musicgen --device cpu --smoke --frames 8
"""
from __future__ import annotations

import argparse
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.models import audio, transformer
from repro_torch.models.common import ModelConfig
from repro_torch.serving.engine import GenRequest

PREFIX_FRAMES = 4      # the conditioning prefix: stub codec frames


@torch.no_grad()
def generate(model: transformer.Transformer, prefix: torch.Tensor, frames: int
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy frames after ``prefix`` (B, K, T) codec tokens: (the delayed
    frames generated (B, K, frames), the same with the delay undone)."""
    delayed = audio.apply_delay_pattern(prefix)
    logits, cache, offset = audio.audio_prefill(model, delayed, prefix.shape[-1] + frames)
    out = []
    tok = torch.argmax(logits[:, -1], dim=-1)                    # (B, K)
    for _ in range(frames):
        out.append(tok.cpu().numpy())
        logits, cache = model.decode_step(tok[:, :, None], cache, offset)
        offset += 1
        tok = torch.argmax(logits[:, -1], dim=-1)
    gen = np.stack(out, axis=-1)                                 # (B, K, frames)
    return gen, audio.undo_delay_pattern(torch.from_numpy(gen)).numpy()


def requests_from_seed(cfg: ModelConfig, n: int, lengths: Sequence[int], max_new: int,
                       seed: int = 0) -> List[GenRequest]:
    """``n`` requests of delayed codec prompts (K, L), L uniform in
    [lengths[0], lengths[1]] frames and codes uniform in [0, vocab_size),
    drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        frames = int(rng.integers(lengths[0], lengths[1] + 1))
        codes = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, cfg.num_codebooks, frames)))
        out.append(GenRequest(rid=i, prompt=audio.apply_delay_pattern(codes)[0].numpy(),
                              max_new=max_new))
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    import repro_torch.configs as C

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true", help="the reduced same-family config")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    cfg = C.get_smoke("musicgen-medium") if args.smoke else C.get("musicgen-medium")
    dev = _device.resolve(args.device)
    model = transformer.build(cfg, dev, args.seed)
    prefix = audio.codec_stub_tokens(cfg, 1, PREFIX_FRAMES,
                                     _device.generator(dev, args.seed + 1))
    gen, undone = generate(model, prefix, args.frames)
    print(f"generated {args.frames} frames across {cfg.num_codebooks} codebooks: "
          f"shape {gen.shape}")
    print(undone[0])


if __name__ == "__main__":
    main()
