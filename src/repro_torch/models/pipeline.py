"""The three-stage Diffusion Pipeline: Encode -> Diffuse -> Decode.

Counterpart of ``repro/models/pipeline.py``. Each stage is its own module
(``Pipeline.encoder``, ``.dit``, ``.decoder``) and its own function, so a
dispatch plan can run a stage by itself — the paper's stage-level
abstraction. Resolution/duration -> latent token geometry follows the
8x-VAE, patch-2 convention (image: (res/16)^2 tokens).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch import device as _device
from repro_torch import trace
from repro_torch.kernels import ops as kops
from repro_torch.models import diffusion, graphs, mmdit, transformer
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    name: str
    encoder: ModelConfig              # bidirectional text encoder (stage E)
    dit: diffusion.DiTConfig          # denoiser (stage D)
    decoder: diffusion.DecoderConfig  # AE-KL latent decoder (stage C)
    num_steps: int                    # denoising steps (Table 5)
    max_cond_len: int = 128
    is_video: bool = False
    source: str = ""

    def latent_grid(self, resolution: int, seconds: float = 0.0) -> Tuple[int, int, int]:
        """(frames, h, w) latent geometry. 8x VAE + patch 2 -> /16 per side;
        video: 4x temporal compression at 16 fps."""
        side = max(2, resolution // 16)
        frames = max(1, int(seconds * 16) // 4) if self.is_video else 1
        return frames, side, side

    def latent_tokens(self, resolution: int, seconds: float = 0.0) -> int:
        f, h, w = self.latent_grid(resolution, seconds)
        return f * h * w


def dit_class(cfg: diffusion.DiTConfig) -> type:
    """The DiT a configuration runs: HunyuanVideo's dual- and single-stream
    blocks (``mmdit.MMDiT``) where it has dual-stream blocks, else the
    reference's uniform joint block (``diffusion.DiT``)."""
    return mmdit.MMDiT if cfg.double_layers else diffusion.DiT


class Pipeline(nn.Module):
    def __init__(self, cfg: PipelineConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = transformer.Transformer(cfg.encoder, device)
        self.dit = dit_class(cfg.dit)(cfg.dit, device)
        self.decoder = diffusion.Decoder(cfg.decoder, device)
        self.encode_graphs: Optional[EncodeGraphs] = None    # made by ``encode_graphs`` on a card


def build(cfg: PipelineConfig, device=None, seed: int = 0) -> Pipeline:
    """The pipeline on ``device`` (``cuda`` by default) with weights drawn
    from ``seed`` on that device."""
    dev = _device.resolve(device)
    gen = _device.generator(dev, seed)
    pipe = Pipeline(cfg, dev)
    pipe.encoder.init_(gen)
    pipe.dit.init_(gen)
    pipe.decoder.init_(gen)
    return pipe.eval()


# --- Stage apply functions (each independently dispatchable) ---------------

def _encode(enc: transformer.Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """The encoder's pass: the last layer's states, through the final norm
    unless the encoder's config has none (``final_norm``)."""
    x = enc.embed_tokens(tokens)
    x = enc.run_layers(x)
    return enc.apply_final_norm(x) if enc.cfg.final_norm else x


@dataclasses.dataclass
class _Encoded:
    """One prompt shape's captured Encode: the static tokens it reads, the
    static states it writes, its graph, and each kernel op's launches in
    one replay. It holds no reference to the encoder."""
    tokens: torch.Tensor
    out: torch.Tensor
    graph: torch.cuda.CUDAGraph
    launches: Dict[str, int]


class EncodeGraphs(graphs.Graphs):
    """Encode as one CUDA graph a prompt shape (the tokens' shape and
    dtype), captured the first time that shape is encoded, all in one
    memory pool. The graphs read the encoder's parameters where they were
    at capture (``ptrs``). Held by the pipeline (``Pipeline.encode_graphs``),
    not by the encoder, which LLM serving shares."""

    def get(self, enc: transformer.Transformer, tokens: torch.Tensor) -> _Encoded:
        key = (tuple(tokens.shape), tokens.dtype)
        cap = self.shapes.get(key)
        if cap is None:
            static = tokens.clone(memory_format=torch.contiguous_format)
            box = {}

            def run():
                box["out"] = _encode(enc, static)
            (graph,), launches = self.capture(tokens.device, [run])
            cap = self.shapes[key] = _Encoded(static, box["out"], graph, launches)
        return cap


def encode_graphs(pipe: Pipeline, tokens: torch.Tensor) -> Optional[EncodeGraphs]:
    """The pipeline's Encode graphs where ``tokens`` can replay them
    (``graphs.replay_ptrs`` of the encoder); graphs of parameters since
    moved are dropped. None elsewhere: Encode then runs eagerly."""
    ptrs = graphs.replay_ptrs(pipe.encoder, tokens)
    if ptrs is None:
        return None
    if pipe.encode_graphs is None or pipe.encode_graphs.ptrs != ptrs:
        pipe.encode_graphs = EncodeGraphs(ptrs)
    return pipe.encode_graphs


@torch.no_grad()
def encode(pipe: Pipeline, tokens: torch.Tensor) -> torch.Tensor:
    """Stage E: prompt tokens (B, Lc) -> condition embeddings (B, Lc, D_enc):
    the last layer's states, through the final norm unless the encoder's
    config has none (``final_norm``). On a CUDA device a replay of the
    prompt shape's graph (``encode_graphs``), elsewhere run eagerly. A
    traced run records the pass as an ``encoder`` span with ``graphed`` (1
    for a replay, 0 for an eager pass)."""
    held = encode_graphs(pipe, tokens)
    if held is None:
        with trace.span("encoder", graphed=0):
            return _encode(pipe.encoder, tokens)
    with torch.cuda.device(tokens.device):
        cap = held.get(pipe.encoder, tokens)
        with trace.span("encoder", graphed=1):
            cap.tokens.copy_(tokens)
            cap.graph.replay()
            for k, n in cap.launches.items():
                kops.LAUNCHES[k] += n
            # the static states are overwritten by the next prompt of this shape
            return cap.out.clone()


@torch.no_grad()
def diffuse(pipe: Pipeline, cond: torch.Tensor, latent_shape: Tuple[int, ...],
            generator: Optional[torch.Generator] = None,
            num_steps: Optional[int] = None, noise: Optional[torch.Tensor] = None,
            grid: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """Stage D: T-step denoising from Gaussian noise in latent space.

    The noise is drawn from ``generator`` on the condition's device, unless
    it is passed in. ``grid``: the latent grid (f, h, w) the tokens fill
    (``PipelineConfig.latent_grid``), which a DiT with 3D RoPE reads."""
    steps = num_steps or pipe.cfg.num_steps
    if noise is None:
        noise = torch.randn(tuple(latent_shape), dtype=torch.float32, device=cond.device,
                            generator=generator)
    return diffusion.ddim_denoise(pipe.dit, noise, cond, steps, grid)


@torch.no_grad()
def decode(pipe: Pipeline, latents: torch.Tensor, grid: Tuple[int, int, int]) -> torch.Tensor:
    """Stage C: latent tokens (B, L, C) -> pixel frames (B*F, 16h, 16w, 3).

    Tokens are un-patchified (patch 2 over an 8x-VAE grid) then decoded.
    """
    f, h, w = grid
    b, l, _ = latents.shape
    if l != f * h * w:
        raise ValueError(f"{l} latent tokens do not fill the grid {grid}")
    cl = pipe.cfg.decoder.latent_channels
    # (B, F, h, w, patch2*cl) -> (B*F, 2h, 2w, cl)
    z = latents.reshape(b * f, h, w, 2, 2, cl).permute(0, 1, 3, 2, 4, 5)
    z = z.reshape(b * f, 2 * h, 2 * w, cl)
    return pipe.decoder(z)


def generate(pipe: Pipeline, tokens: torch.Tensor, resolution: int, seconds: float = 0.0,
             generator: Optional[torch.Generator] = None,
             num_steps: Optional[int] = None) -> torch.Tensor:
    """End-to-end E->D->C (the co-located <EDC> execution path)."""
    cfg = pipe.cfg
    grid = cfg.latent_grid(resolution, seconds)
    cond = encode(pipe, tokens)
    shape = (tokens.shape[0], cfg.latent_tokens(resolution, seconds), cfg.dit.latent_dim)
    latents = diffuse(pipe, cond, shape, generator, num_steps, grid=grid)
    return decode(pipe, latents, grid)


# --- Workload geometry helpers (used by the profiler & dispatcher) ---------

def stage_proc_len(cfg: PipelineConfig, stage: str, resolution: int,
                   seconds: float, cond_len: int = 77) -> int:
    """The paper's l_proc per stage (Table 2 semantics)."""
    if stage == "E":
        return cond_len
    return cfg.latent_tokens(resolution, seconds) + (cond_len if stage == "D" else 0)
