"""Config registry: the ported LLM architectures and diffusion pipelines.

``get(id)`` returns the full published config; ``get_smoke`` a reduced
same-family variant that runs on a CPU in seconds. Counterpart of
``repro/configs/__init__.py``, with the same ids: the four diffusion
pipelines (``sd3``, ``flux``, ``cogvideox``, ``hunyuanvideo``) and the ten
LLMs of the zoo; ``get`` also knows the port-only ``hunyuanvideo-t2v``
(HunyuanVideo's released DiT, which the reference does not have), in
neither tuple. ``INPUT_SHAPES`` are the dry-run's four input shapes, with
the reference's lengths, batches and kinds.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

ARCH_IDS = ("zamba2-1.2b", "rwkv6-3b", "yi-9b", "yi-34b", "starcoder2-15b", "gemma2-9b",
            "deepseek-moe-16b", "llama4-maverick-400b-a17b", "internvl2-2b", "musicgen-medium")

PIPELINE_IDS = ("sd3", "flux", "cogvideox", "hunyuanvideo")

_MODULES = {
    "zamba2-1.2b": "zamba2_1p2b",
    "rwkv6-3b": "rwkv6_3b",
    "yi-9b": "yi_9b",
    "yi-34b": "yi_34b",
    "starcoder2-15b": "starcoder2_15b",
    "gemma2-9b": "gemma2_9b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "internvl2-2b": "internvl2_2b",
    "musicgen-medium": "musicgen_medium",
    "sd3": "sd3",
    "flux": "flux",
    "cogvideox": "cogvideox",
    "hunyuanvideo": "hunyuanvideo",
    # port-only: HunyuanVideo T2V as released, not in PIPELINE_IDS (no JAX counterpart)
    "hunyuanvideo-t2v": "hunyuanvideo_t2v",
}


def _module(config_id: str):
    if config_id not in _MODULES:
        raise KeyError(f"unknown config {config_id!r}; ported: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[config_id]}")


def get(config_id: str):
    return _module(config_id).CONFIG


def get_smoke(config_id: str):
    return _module(config_id).SMOKE


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
