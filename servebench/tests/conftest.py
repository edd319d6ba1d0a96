"""Shared pieces of the benchmark's CPU tests: the repository's ``src`` on
the path, and a cell at the port's SMOKE sizes, with the served number of
DDIM steps, that runs on the CPU."""
import dataclasses
import json
import os
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def config_file(pcfg, reference: str = "dit_pipeline", limit: float = 1e-3) -> dict:
    """A configuration file's content for the port's PipelineConfig ``pcfg``."""
    def section(dc, keys):
        d = {k: getattr(dc, k) for k in keys}
        d["dtype"] = str(dc.dtype).replace("torch.", "")
        if "layer_pattern" in d:
            d["layer_pattern"] = list(d["layer_pattern"])
        return d

    enc_keys = ("name", "family", "num_layers", "d_model", "num_heads", "num_kv_heads",
                "head_dim", "d_ff", "vocab_size", "layer_pattern", "rope_theta", "norm_eps",
                "source")
    dit_keys = ("name", "num_layers", "d_model", "num_heads", "d_ff", "latent_dim", "cond_dim",
                "time_embed_dim", "norm_eps", "source")
    dec_keys = ("name", "latent_channels", "base_channels", "num_upsamples", "res_blocks",
                "out_channels", "source")
    return {"name": pcfg.name, "source": "https://example.org/smoke", "reference": reference,
            "pipeline": {"num_steps": pcfg.num_steps, "max_cond_len": pcfg.max_cond_len,
                         "is_video": pcfg.is_video, "source": pcfg.source},
            "encoder": section(pcfg.encoder, enc_keys), "dit": section(pcfg.dit, dit_keys),
            "decoder": section(pcfg.decoder, dec_keys), "limits": {"pixel_gap": limit}}


def smoke_config(name: str, **kw) -> dict:
    """The configuration file of ``name`` at the port's SMOKE widths and
    depths, with the full configuration's number of DDIM steps."""
    import repro_torch.configs as C
    cfg = config_file(C.get_smoke(name), **kw)
    cfg["pipeline"]["num_steps"] = C.get(name).num_steps
    return cfg


def smoke_mix(name: str) -> dict:
    """The mix ``name`` at the SMOKE geometry (an eighth of the side), with
    standalone latencies and a rate a CPU keeps up with."""
    from servebench.traffic import generator
    mix = json.loads(json.dumps(generator.load(name)))
    for c in mix["classes"]:
        c["resolution"] //= 8
        c["standalone_s"] = 0.5
    if mix["kind"] == "open":
        mix["knee_per_s"], mix["load"] = 2.0, 1.0
    else:
        mix["clients"] = 2
    return mix


@pytest.fixture
def smoke_cell():
    """A function (config name, mix name) -> a cell at SMOKE sizes."""
    def make(config: str, mix: str) -> dict:
        return {"name": f"{config}.smoke", "chips": 1, "cfg": smoke_config(config),
                "mix": smoke_mix(mix), "end_to_end": [], "per_layer": []}
    return make


@pytest.fixture
def cpu():
    torch.manual_seed(0)
    os.environ.setdefault("OMP_NUM_THREADS", "2")
    return torch.device("cpu")


def replace(obj, **kw):
    return dataclasses.replace(obj, **kw)
