"""Config registry, pipeline half: the paper's diffusion pipelines.

``get(pipeline_id)`` returns the full published config; ``get_smoke`` a
reduced same-family variant that runs on a CPU in seconds. Counterpart of
``repro/configs/__init__.py``; only ``sd3`` is ported so far.
"""
from __future__ import annotations

import importlib

PIPELINE_IDS = ("sd3",)

_MODULES = {"sd3": "sd3"}


def _module(pipeline_id: str):
    if pipeline_id not in _MODULES:
        raise KeyError(f"unknown pipeline {pipeline_id!r}; ported: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[pipeline_id]}")


def get(pipeline_id: str):
    return _module(pipeline_id).CONFIG


def get_smoke(pipeline_id: str):
    return _module(pipeline_id).SMOKE
