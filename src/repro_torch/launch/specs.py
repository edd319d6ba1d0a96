"""input_specs(): the arguments of one (architecture x input shape) on
``meta``, and the step function each shape runs.

Counterpart of ``repro/launch/specs.py``, whose ``ShapeDtypeStruct``
stand-ins are ``meta`` tensors here: a model, a train state or a cache on
``meta`` holds shapes and dtypes and allocates nothing.

Shapes (``configs.INPUT_SHAPES``):
  train_4k     seq 4096,   batch 256  -> train_step (fwd+bwd+AdamW)
  prefill_32k  seq 32768,  batch 32   -> prefill (last logits + caches)
  decode_32k   cache 32768, batch 128 -> decode_step (ONE token vs cache)
  long_500k    cache 524288, batch 1  -> decode_step (sub-quadratic archs)

The modality carve-out: VLM prompts are (text_tokens, patch_embeds) with
text = seq - vision_tokens so the total processed length matches; audio
tokens carry the codebook dim (B, K, L). Token ids are int64, as the
port's data pipeline gives them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

import repro_torch.configs as configs
from repro_torch.configs import INPUT_SHAPES, InputShape
from repro_torch.models import transformer
from repro_torch.models.common import ModelConfig
from repro_torch.training import loop as train_loop
from repro_torch.training import optimizer as opt_lib

META = torch.device("meta")


@dataclasses.dataclass
class LoweringSpec:
    """Everything needed to run one (arch, shape) combination."""
    kind: str                       # train | prefill | decode
    fn: Callable                    # the step function
    args: Tuple                     # its arguments, on meta
    arg_names: Tuple[str, ...]      # for sharding assignment
    batch: int
    seq_len: int
    skipped: Optional[str] = None   # reason, when the combo is skipped


def _tokens(cfg: ModelConfig, batch: int, seq: int) -> torch.Tensor:
    shape = (batch, cfg.num_codebooks, seq) if cfg.modality == "audio_codec" else (batch, seq)
    return torch.empty(shape, dtype=torch.int64, device=META)


def _patch_embeds(cfg: ModelConfig, batch: int) -> torch.Tensor:
    return torch.empty((batch, cfg.vision_tokens, cfg.vision_embed_dim), dtype=torch.float32,
                       device=META)


def supports_shape(cfg: ModelConfig, shape: InputShape) -> Optional[str]:
    """None when supported; otherwise the skip reason (recorded in docs)."""
    if shape.name == "long_500k" and not cfg.supports_long_context():
        return ("pure full-attention stack: a 500k-token KV cache has no "
                "sub-quadratic variant in the reference model (DESIGN.md)")
    return None


def meta_state(cfg: ModelConfig) -> train_loop.TrainState:
    """A train state on ``meta``: the model's parameters learnable, zero
    moments (``training.loop.init_state`` without the seeded draw)."""
    model = transformer.Transformer(cfg, META).requires_grad_(True)
    return train_loop.TrainState(model, opt_lib.init(dict(model.named_parameters())))


def input_specs(arch_id: str, shape_name: str,
                cfg: Optional[ModelConfig] = None) -> LoweringSpec:
    cfg = cfg if cfg is not None else configs.get(arch_id)
    shape = INPUT_SHAPES[shape_name]
    b, seq = shape.global_batch, shape.seq_len
    skip = supports_shape(cfg, shape)
    if skip:
        return LoweringSpec(shape.kind, lambda: None, (), (), b, seq, skipped=skip)

    if shape.kind == "train":
        text = seq - cfg.vision_tokens if cfg.modality == "vision" else seq
        batch = {"tokens": _tokens(cfg, b, text), "labels": _tokens(cfg, b, text)}
        if cfg.modality == "vision":
            batch["patch_embeds"] = _patch_embeds(cfg, b)
        return LoweringSpec("train", train_loop.make_train_step(cfg), (meta_state(cfg), batch),
                            ("state", "batch"), b, seq)

    model = transformer.Transformer(cfg, META)
    if shape.kind == "prefill":
        if cfg.modality == "vision":
            return LoweringSpec(
                "prefill", lambda m, t, pe: m.prefill(t, seq, prefix_embeds=pe),
                (model, _tokens(cfg, b, seq - cfg.vision_tokens), _patch_embeds(cfg, b)),
                ("params", "tokens", "patch_embeds"), b, seq)
        return LoweringSpec("prefill", lambda m, t: m.prefill(t, seq),
                            (model, _tokens(cfg, b, seq)), ("params", "tokens"), b, seq)

    # decode: ONE new token against a seq_len cache, the cache full up to it
    return LoweringSpec("decode", lambda m, t, c, o: m.decode_step(t, c, o),
                        (model, _tokens(cfg, b, 1), model.init_cache(b, seq), seq - 1),
                        ("params", "tokens", "cache", "offset"), b, seq)
