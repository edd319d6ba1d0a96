"""DiT diffusion transformer with AdaLN-Zero conditioning (Diffuse stage),
its DDIM loop, and the AE-KL latent decoder (Decode stage).

Counterpart of ``repro/models/diffusion.py``. Latent patches and text
condition tokens form one joint stream; each block's shift/scale/gate
modulation comes from the timestep embedding. ``DiT.forward`` always goes
through the two kernel ops: ``flash_attention`` (non-causal) and
``adaln_rmsnorm``. The decoder keeps the reference's NHWC layout at its
public functions and runs its convolutions as plain ``F.conv2d``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import trace
from repro_torch.kernels import ops as kops
from repro_torch.models import common, graphs
from repro_torch.models.common import param
from repro_torch.sharding import spmd


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    d_ff: int
    latent_dim: int               # channels per latent token (after patchify)
    cond_dim: int                 # encoder hidden size
    time_embed_dim: int = 256
    dtype: Any = torch.bfloat16
    norm_eps: float = 1e-6
    source: str = ""
    # HunyuanVideo's block form (``models/mmdit.py``); the defaults keep the uniform DiT
    double_layers: int = 0        # of ``num_layers``, how many lead as dual-stream blocks
    rope_axes: Tuple[int, ...] = ()   # head-dim split of 3D RoPE over (t, h, w)
    rope_theta: float = 256.0
    refiner_layers: int = 0       # token-refiner blocks over the text states
    guidance: float = 0.0         # embedded guidance scale (0: no guidance input)

    def __post_init__(self):
        # a configuration file gives tuples as lists
        object.__setattr__(self, "rope_axes", tuple(self.rope_axes))


class DiTLayer(nn.Module):
    def __init__(self, cfg: DiTConfig, device=None):
        super().__init__()
        d, dt = cfg.d_model, cfg.dtype
        self.cfg = cfg
        self.wq = param((d, d), dt, device)
        self.wk = param((d, d), dt, device)
        self.wv = param((d, d), dt, device)
        self.wo = param((d, d), dt, device)
        self.w_up = param((d, cfg.d_ff), dt, device)
        self.w_down = param((cfg.d_ff, d), dt, device)
        self.mod = param((d, 6 * d), dt, device)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        scale_o = 1.0 / max(1, self.cfg.num_layers) ** 0.5
        for w in (self.wq, self.wk, self.wv, self.w_up):
            common.dense_init_(w, gen)
        common.dense_init_(self.wo, gen, scale=scale_o)
        common.dense_init_(self.w_down, gen, scale=scale_o)
        # AdaLN-Zero: modulation starts at zero, so every block starts as identity
        self.mod.zero_()

    def forward(self, x: torch.Tensor, tc: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, l, d = x.shape
        h = cfg.num_heads
        dh = d // h
        mod = spmd.reshape(tc @ self.mod, b, 6, d)
        s1, sh1, g1, s2, sh2, g2 = (mod[:, i] for i in range(6))
        hn = _adaln(x, s1, sh1, cfg.norm_eps)
        q = spmd.reshape(hn @ self.wq, b, l, h, dh)
        k = spmd.reshape(hn @ self.wk, b, l, h, dh)
        v = spmd.reshape(hn @ self.wv, b, l, h, dh)
        # on a mesh the kernel runs on each rank's batch rows and heads
        a = spmd.local(lambda q_, k_, v_: kops.flash_attention(q_, k_, v_, causal=False).flatten(2),
                       q, k, v, keep=(0, 2))
        a = a @ self.wo
        x = x + g1[:, None, :] * a
        hn = _adaln(x, s2, sh2, cfg.norm_eps)
        f = common.gelu_mlp(hn, self.w_up, self.w_down)
        return x + g2[:, None, :] * f


def _adaln(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, eps: float) -> torch.Tensor:
    """K2; on a mesh on each rank's batch rows, the sequence whole."""
    return spmd.local(lambda x_, s_, t_: kops.adaln_rmsnorm(x_, s_, t_, eps=eps), x, scale, shift)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding, cos then sin; t: (B,) float in [0, 1000]."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class DiT(nn.Module):
    reads_grid = False      # 1D positions: a step is the same on every grid of its L

    def __init__(self, cfg: DiTConfig, device=None):
        super().__init__()
        d, dt = cfg.d_model, cfg.dtype
        self.cfg = cfg
        self.x_in = param((cfg.latent_dim, d), dt, device)
        self.cond_in = param((cfg.cond_dim, d), dt, device)
        self.t_mlp1 = param((cfg.time_embed_dim, d), dt, device)
        self.t_mlp2 = param((d, d), dt, device)
        self.layers = nn.ModuleList(DiTLayer(cfg, device) for _ in range(cfg.num_layers))
        self.final_mod = param((d, 2 * d), dt, device)
        self.x_out = param((d, cfg.latent_dim), dt, device)
        self.pos_freq = param((2, d // 2), torch.float32, device)
        self.step_graphs: Optional[StepGraphs] = None    # made by ``step_graphs`` on a card

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        for w in (self.x_in, self.cond_in, self.t_mlp1, self.t_mlp2):
            common.dense_init_(w, gen)
        for layer in self.layers:
            layer.init_(gen)
        self.final_mod.zero_()
        common.dense_init_(self.x_out, gen, scale=0.02)
        common.dense_init_(self.pos_freq, gen, scale=1.0)

    def forward(self, latents: torch.Tensor, t: torch.Tensor, cond: torch.Tensor,
                cond_pooled: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One denoising network evaluation.

        latents: (B, Lx, latent_dim); t: (B,); cond: (B, Lc, cond_dim).
        Returns predicted noise (B, Lx, latent_dim) in float32.
        """
        cfg = self.cfg
        dt = cfg.dtype
        lc = cond.shape[1]
        x = latents.to(dt) @ self.x_in
        c = cond.to(dt) @ self.cond_in
        x = torch.cat([c, x], dim=1)                               # joint stream
        l = x.shape[1]

        # absolute 2-channel sin/cos positions (latent grid is 1D-flattened here)
        pos = torch.arange(l, dtype=torch.float32, device=x.device)
        pf = self.pos_freq.float()
        pe = torch.cat([torch.sin(pos[:, None] * pf[0][None]),
                        torch.cos(pos[:, None] * pf[1][None])], dim=-1)
        x = x + pe[None].to(dt)

        temb = timestep_embedding(t, cfg.time_embed_dim)
        tc = temb.to(dt) @ self.t_mlp1
        if cond_pooled is not None:
            tc = tc + cond_pooled.to(dt)
        tc = F.silu(tc.float()).to(dt) @ self.t_mlp2

        for layer in self.layers:
            x = layer(x, tc)
        fmod = (tc @ self.final_mod).reshape(x.shape[0], 2, cfg.d_model)
        x = _adaln(x, fmod[:, 0], fmod[:, 1], cfg.norm_eps)
        return (x[:, lc:, :] @ self.x_out).float()

    def grid_inputs(self, grid=None, device=None) -> tuple:
        """What a step reads besides its latents for the latent grid: nothing."""
        return ()

    def step_parts(self, x: torch.Tensor, tb: torch.Tensor, cond: torch.Tensor,
                   ab_t: torch.Tensor, ab_n: torch.Tensor, extra: tuple, carry: dict
                   ) -> List["Part"]:
        """A DDIM step (``ddim_step``) as one part with no span."""
        def whole():
            ddim_update(x, self(x, tb, cond), ab_t, ab_n)
        return [Part(None, {}, whole)]


def jax_linspace(start: float, stop: float, num: int) -> torch.Tensor:
    """float32 ``linspace`` with the reference's arithmetic,
    ``start * (1 - step) + stop * step`` with ``step = i * (1 / div)`` (its
    compiler turns the division by a constant into that product), then the
    endpoint. Truncated to integers it gives the reference's timesteps
    exactly; ``torch.linspace`` gives 666 where the reference gives 665 at
    n=4."""
    if num == 1:
        return torch.tensor([start], dtype=torch.float32)
    div = num - 1
    recip = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(div, dtype=torch.float32)
    step = torch.arange(div, dtype=torch.float32) * recip
    a = torch.tensor(start, dtype=torch.float32)
    z = torch.tensor(stop, dtype=torch.float32)
    out = a * (1 - step) + z * step
    return torch.cat([out, z[None]])


def ddim_timesteps(num_steps: int) -> list:
    """The integer timesteps of the DDIM loop, ``linspace(999, 0, n)`` truncated."""
    return jax_linspace(999, 0, num_steps).to(torch.int32).tolist()


class Part(NamedTuple):
    """One part of a DDIM step: the span a traced step records around it
    (None: none), the span's attributes, and the work."""
    span: Optional[str]
    attrs: Dict[str, Any]
    run: Callable[[], None]


def ddim_update(x: torch.Tensor, eps: torch.Tensor, ab_t: torch.Tensor,
                ab_n: torch.Tensor) -> None:
    """x at timestep t, in place, to the latents at the next timestep, given
    the predicted noise ``eps`` and the 0-dim alpha-bars of both."""
    x0 = (x - torch.sqrt(1 - ab_t) * eps) / torch.sqrt(ab_t)
    torch.add(torch.sqrt(ab_n) * x0, torch.sqrt(1 - ab_n) * eps, out=x)


def ddim_step(dit: nn.Module, x: torch.Tensor, tb: torch.Tensor, cond: torch.Tensor,
              ab_t: torch.Tensor, ab_n: torch.Tensor, extra: tuple = ()) -> None:
    """One DDIM step, in place: x (B, Lx, latent_dim) float32 at timestep
    ``tb`` (B,) becomes the latents at the next timestep. ``ab_t`` and
    ``ab_n`` are the 0-dim float32 alpha-bars of this timestep and the next;
    ``extra`` the DiT's ``grid_inputs``. The step runs in the DiT's
    ``step_parts``, each named part inside a span of its own (recorded only
    while tracing). A card replays the same parts as graphs."""
    for part in dit.step_parts(x, tb, cond, ab_t, ab_n, extra, {}):
        with _part_span(part.span, part.attrs, x.device):
            part.run()


def _part_span(span: Optional[str], attrs: Dict[str, Any], dev: torch.device):
    return (trace.span(span, device=dev, **attrs) if span is not None
            else contextlib.nullcontext())


@dataclasses.dataclass
class _Captured:
    """One shape's captured step: the static buffers the graphs read and
    write (``carry``: what one part hands the next), each part's span and
    attributes with its graph, and each kernel op's launches in one replay.
    It holds no reference to the DiT, which holds it."""
    x: torch.Tensor
    cond: torch.Tensor
    tb: torch.Tensor
    ab_t: torch.Tensor
    ab_n: torch.Tensor
    extra: tuple
    carry: dict
    spans: List[Tuple[Optional[str], Dict[str, Any]]]
    graphs: List[Any]
    launches: Dict[str, int]


def graph_key(dit: nn.Module, noise: torch.Tensor, cond: torch.Tensor, grid=None) -> tuple:
    """What a captured step depends on: the latents' and the condition's
    shapes, the condition's dtype, and the latent grid where the DiT reads
    it (``reads_grid``). The uniform DiT's key has no grid, so one graph
    serves a shape whether or not the caller names its grid."""
    return (tuple(noise.shape), tuple(cond.shape), cond.dtype,
            tuple(grid) if dit.reads_grid and grid is not None else None)


class StepGraphs(graphs.Graphs):
    """A DiT's DDIM step as CUDA graphs, one a part of the step
    (``step_parts``): captured the first time a ``graph_key`` is denoised,
    all in one memory pool (replays never overlap). The graphs read the
    parameters where they were at capture (``ptrs``). Held by the DiT
    (``DiT.step_graphs``), so they and their pool go with it."""

    def get(self, dit: nn.Module, noise: torch.Tensor, cond: torch.Tensor,
            grid=None) -> _Captured:
        key = graph_key(dit, noise, cond, grid)
        cap = self.shapes.get(key)
        if cap is None:
            cap = self.shapes[key] = self._capture(dit, noise, cond, grid)
        return cap

    def _capture(self, dit: nn.Module, noise: torch.Tensor, cond: torch.Tensor,
                 grid) -> _Captured:
        dev = noise.device
        f32 = dict(dtype=torch.float32, device=dev)
        x = noise.to(torch.float32, copy=True)
        tb = torch.full((noise.shape[0],), 999.0, **f32)
        ab_t, ab_n = torch.full((), 0.5, **f32), torch.full((), 0.5, **f32)
        cond = cond.clone(memory_format=torch.contiguous_format)
        # the grid's inputs are static buffers, made once outside the graphs
        extra = dit.grid_inputs(grid, dev)
        carry: dict = {}
        parts = dit.step_parts(x, tb, cond, ab_t, ab_n, extra, carry)
        made, launches = self.capture(dev, [p.run for p in parts])
        return _Captured(x, cond, tb, ab_t, ab_n, extra, carry,
                         [(p.span, p.attrs) for p in parts], made, launches)


def step_graphs(dit: nn.Module, x: torch.Tensor) -> Optional[StepGraphs]:
    """The DiT's step graphs where ``x``'s steps can replay them
    (``graphs.replay_ptrs``); graphs of parameters since moved are dropped.
    None elsewhere: the steps then run eagerly."""
    ptrs = graphs.replay_ptrs(dit, x)
    if ptrs is None:
        return None
    if dit.step_graphs is None or dit.step_graphs.ptrs != ptrs:
        dit.step_graphs = StepGraphs(ptrs)
    return dit.step_graphs


@torch.no_grad()
def ddim_denoise(dit: nn.Module, noise: torch.Tensor, cond: torch.Tensor,
                 num_steps: int, grid=None) -> torch.Tensor:
    """Multi-step denoising loop (the Diffuse stage's runtime body).

    DDIM with a linear alpha-bar schedule; deterministic (eta=0). ``grid``:
    the latent grid (f, h, w) of the noise's tokens, which a DiT that
    ``reads_grid`` reads (its RoPE). Each step is ``ddim_step``: on a CUDA
    device a replay of its graphs for the ``graph_key`` (``step_graphs``),
    elsewhere run eagerly. A traced run records each step as a ``step``
    span with its index, its timestep and ``graphed`` (1 for a replay, 0
    for an eager step), and inside it each named part of the step
    (``step_parts``) as a span of its own.
    """
    betas = jax_linspace(1e-4, 0.02, 1000)
    alpha_bar = torch.cumprod(1.0 - betas, dim=0)
    ts = ddim_timesteps(num_steps)
    nexts = ts[1:] + [-1]
    dev = noise.device
    held = step_graphs(dit, noise)
    if held is not None:
        ab = alpha_bar.tolist()
        with torch.cuda.device(dev):
            cap = held.get(dit, noise, cond, grid)
            cap.x.copy_(noise)
            cap.cond.copy_(cond)
            for i, (t, t_next) in enumerate(zip(ts, nexts)):
                with trace.span("step", device=dev, step=i, t=t, graphed=1):
                    cap.tb.fill_(float(t))
                    cap.ab_t.fill_(ab[t])
                    cap.ab_n.fill_(ab[t_next] if t_next >= 0 else 1.0)
                    for (span, attrs), graph in zip(cap.spans, cap.graphs):
                        with _part_span(span, attrs, dev):
                            graph.replay()
                for k, n in cap.launches.items():
                    kops.LAUNCHES[k] += n
            # the static latents are overwritten by the next call of this shape
            return cap.x.clone()
    alpha_bar = alpha_bar.to(dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    extra = dit.grid_inputs(grid, dev)
    x = noise.to(torch.float32, copy=True)
    for i, (t, t_next) in enumerate(zip(ts, nexts)):
        ab_t = alpha_bar[t]
        ab_n = alpha_bar[t_next] if t_next >= 0 else one
        with trace.span("step", device=dev, step=i, t=t, graphed=0):
            tb = torch.full((x.shape[0],), float(t), dtype=torch.float32, device=dev)
            ddim_step(dit, x, tb, cond, ab_t, ab_n, extra)
    return x


# ---------------------------------------------------------------------------
# AE-KL latent decoder (Decode stage) — conv upsampler, memory-bound
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    name: str
    latent_channels: int
    base_channels: int = 512
    num_upsamples: int = 3        # 8x spatial upscale
    res_blocks: int = 2           # residual conv blocks per level
    out_channels: int = 3
    dtype: Any = torch.bfloat16
    source: str = ""


class Decoder(nn.Module):
    """The reference's ``decode_latent`` as a module. Conv weights are OIHW
    here (HWIO in the reference); activations stay NHWC at its edges."""

    def __init__(self, cfg: DecoderConfig, device=None):
        super().__init__()
        self.cfg = cfg
        ch, dt = cfg.base_channels, cfg.dtype
        self.conv_in = param((ch, cfg.latent_channels, 3, 3), dt, device)
        for i in range(cfg.num_upsamples):
            cin = max(ch // (2 ** i), 32)
            cout = max(ch // (2 ** (i + 1)), 32)
            setattr(self, f"up{i}_in", param((cout, cin, 3, 3), dt, device))
            for r in range(cfg.res_blocks):
                setattr(self, f"up{i}_res{r}", param((cout, cout, 3, 3), dt, device))
        cfin = max(ch // (2 ** cfg.num_upsamples), 32)
        self.conv_out = param((cfg.out_channels, cfin, 3, 3), dt, device)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        for _, w in self.named_parameters():
            # the reference's fan-in rule reads shape[0] of its HWIO kernel: 3
            common.dense_init_(w, gen, fan_in=3)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """z: (B, h, w, latent_channels) NHWC -> pixels (B, 8h, 8w, 3) float32."""
        cfg = self.cfg
        dt = cfg.dtype

        def silu(t):
            return F.silu(t.float()).to(dt)

        x = F.conv2d(z.to(dt).permute(0, 3, 1, 2), self.conv_in, padding=1)
        for i in range(cfg.num_upsamples):
            x = F.interpolate(silu(x), scale_factor=2, mode="nearest")
            x = F.conv2d(x, getattr(self, f"up{i}_in"), padding=1)
            for r in range(cfg.res_blocks):
                x = x + F.conv2d(silu(x), getattr(self, f"up{i}_res{r}"), padding=1)
        x = F.conv2d(silu(x), self.conv_out, padding=1)
        return torch.tanh(x.float()).permute(0, 2, 3, 1)
