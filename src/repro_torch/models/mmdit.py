"""HunyuanVideo's DiT: dual-stream blocks, then single-stream blocks (Diffuse stage).

A port-only variant beside ``diffusion.DiT`` (which keeps the reference's
uniform joint block): Tencent's ``HYVideoDiffusionTransformer`` as
released, picked by ``Pipeline`` where ``DiTConfig.double_layers`` is set.
FLUX.1's 19 double + 38 single blocks are the same block form.

LN is LayerNorm without affine (eps ``norm_eps``), every Linear has a
bias, ``mod(v) = Linear(SiLU(v))`` and ``temb`` is the 256-d cos|sin
timestep embedding::

    vec   = MLP_t(temb(t)) + MLP_g(temb(1000 guidance))     # MLP: Linear, SiLU, Linear
    txt   = refiner(cond, t)   # Linear cond_dim -> d; c = MLP_t'(temb(t)) + MLP_c(mean_L cond);
                               # per block: x += g1 Attn(LN_affine(x));
                               #            x += g2 MLP_silu(LN_affine(x)); (g1, g2) = mod(c);
                               # no QK-norm
    img   = Linear(latent_dim -> d)(latents)
    dual  (double_layers blocks, separate weights per stream s in {img, txt}):
          (sh1, sc1, g1, sh2, sc2, g2)_s = mod_s(vec)
          q, k, v_s = split(Linear_s(LN(x_s) (1 + sc1) + sh1));
          q, k = RMSNorm_head(q), RMSNorm_head(k)
          q, k_img = RoPE3D(q, k_img)
          a = Attn([q_img; q_txt], [k_img; k_txt], [v_img; v_txt]) -> split -> a_s
          x_s += g1 Proj_s(a_s);  x_s += g2 MLP_gelu_tanh,s(LN(x_s) (1 + sc2) + sh2)
    single (the rest, x = [img; txt]):
          (sh, sc, g) = mod(vec); h = LN(x) (1 + sc) + sh
          q, k, v, m = split(Linear_{d -> 7d}(h), [d, d, d, 4d]); RMSNorm_head on q, k;
          RoPE3D on the img rows only
          x += g Linear_{5d -> d}([Attn(q, k, v); gelu_tanh(m)])
    out   = Linear(d -> latent_dim)(LN(x_img) (1 + sc) + sh),  (sh, sc) = mod(vec)

RMSNorm_head normalises each head's q or k and multiplies by a gain w.
RoPE3D: the latent grid (f, h, w) flattened t-major, head-dim split
``rope_axes`` (16/56/56) over (t, h, w), theta ``rope_theta``, positions
from 0; per axis frequencies 1/theta^(2i/dim), each rotating an ADJACENT
pair (x[2i], x[2i+1]): out = x cos + rot(x) sin with rot(x)[2i] = -x[2i+1],
rot(x)[2i+1] = x[2i]. Here the pairs are complex numbers and the table is
exp(i angle) (``rope_table``).

Every attention, the refiner's included, is K1 (non-causal). The norms,
QK-norm and RoPE are plain torch ops. A DDIM step runs in two parts
(``step_parts``): ``double`` (embeddings, refiner, dual-stream blocks) and
``single`` (single-stream blocks, final layer, the DDIM update), which a
traced step records as spans and a card replays as one graph each.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.models import common, diffusion
from repro_torch.models.common import param
from repro_torch.models.diffusion import DiTConfig

Grid = Tuple[int, int, int]


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` for a (d_in, d_out) weight, the bias in the product's epilogue."""
    return F.linear(x, w.t(), b)


def layer_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm without affine, in x's dtype (float32 inside)."""
    return F.layer_norm(x, (x.shape[-1],), eps=eps)


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x * (1 + scale) + shift`` per batch row."""
    return torch.addcmul(shift[:, None], x, (1 + scale)[:, None])


def gated(x: torch.Tensor, gate: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x + gate * y`` per batch row."""
    return torch.addcmul(x, gate[:, None], y)


def qk_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over each head's last dim with gain ``w``, in float32."""
    return F.rms_norm(x.float(), (x.shape[-1],), w, eps)


def rope_table(grid: Grid, axes: Tuple[int, ...], theta: float, device=None) -> torch.Tensor:
    """exp(i angle) of every latent token (t-major) and head-dim pair:
    complex64 (f*h*w, sum(axes)/2), each axis's pairs after the one before."""
    parts = []
    for n, dim in zip(grid, axes):
        freqs = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim)
        parts.append(torch.arange(n, dtype=torch.float32, device=device)[:, None] * freqs)
    f, h, w = grid
    ang = torch.cat([parts[0][:, None, None].expand(f, h, w, -1),
                     parts[1][None, :, None].expand(f, h, w, -1),
                     parts[2][None, None, :].expand(f, h, w, -1)], dim=-1).reshape(f * h * w, -1)
    return torch.polar(torch.ones_like(ang), ang)


def rope_rows(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """RoPE3D in place on the first ``len(table)`` rows of x (B, L, H, Dh)
    float32: the image rows of a joint [img; txt] sequence. Returns x."""
    n = table.shape[0]
    pairs = torch.view_as_complex(x.unflatten(-1, (-1, 2)))
    pairs[:, :n].mul_(table[:, None, :])
    return x


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K1, non-causal: (B, L, H, Dh) each -> (B, L, H * Dh)."""
    return kops.flash_attention(q, k, v, causal=False).flatten(2)


def _linear_params(d_in: int, d_out: int, dtype, device) -> Tuple[nn.Parameter, nn.Parameter]:
    """A (d_in, d_out) weight and its bias."""
    return param((d_in, d_out), dtype, device), param((d_out,), dtype, device)


class MLPEmbed(nn.Module):
    """Linear, SiLU, Linear."""

    def __init__(self, d_in: int, d: int, dtype, device=None):
        super().__init__()
        self.w1, self.b1 = _linear_params(d_in, d, dtype, device)
        self.w2, self.b2 = _linear_params(d, d, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(F.silu(linear(x, self.w1, self.b1)), self.w2, self.b2)


class RefinerBlock(nn.Module):
    """One token-refiner block: affine LayerNorms, gates from mod(c), a SiLU MLP."""

    def __init__(self, cfg: DiTConfig, device=None):
        super().__init__()
        d, dt, f32 = cfg.d_model, cfg.dtype, torch.float32
        self.cfg = cfg
        self.ln1, self.ln1_b = param((d,), f32, device), param((d,), f32, device)
        self.qkv, self.qkv_b = _linear_params(d, 3 * d, dt, device)
        self.proj, self.proj_b = _linear_params(d, d, dt, device)
        self.ln2, self.ln2_b = param((d,), f32, device), param((d,), f32, device)
        self.fc1, self.fc1_b = _linear_params(d, cfg.d_ff, dt, device)
        self.fc2, self.fc2_b = _linear_params(cfg.d_ff, d, dt, device)
        self.mod, self.mod_b = _linear_params(d, 2 * d, dt, device)

    def _ln(self, x, w, b):
        return F.layer_norm(x.float(), (x.shape[-1],), w, b, self.cfg.norm_eps).to(x.dtype)

    def forward(self, x: torch.Tensor, c_act: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, l, d = x.shape
        g1, g2 = linear(c_act, self.mod, self.mod_b).chunk(2, dim=-1)
        qkv = linear(self._ln(x, self.ln1, self.ln1_b), self.qkv, self.qkv_b)
        qkv = qkv.view(b, l, 3, cfg.num_heads, d // cfg.num_heads)
        a = _attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        x = gated(x, g1, linear(a, self.proj, self.proj_b))
        h = F.silu(linear(self._ln(x, self.ln2, self.ln2_b), self.fc1, self.fc1_b))
        return gated(x, g2, linear(h, self.fc2, self.fc2_b))


class Refiner(nn.Module):
    """HunyuanVideo's ``SingleTokenRefiner``: the text states into the DiT's width."""

    def __init__(self, cfg: DiTConfig, device=None):
        super().__init__()
        d, dt = cfg.d_model, cfg.dtype
        self.cfg = cfg
        self.x_in, self.x_in_b = _linear_params(cfg.cond_dim, d, dt, device)
        self.t_embed = MLPEmbed(cfg.time_embed_dim, d, dt, device)
        self.c_embed = MLPEmbed(cfg.cond_dim, d, dt, device)
        self.blocks = nn.ModuleList(RefinerBlock(cfg, device) for _ in range(cfg.refiner_layers))

    def forward(self, cond: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        c = self.t_embed(temb) + self.c_embed(cond.float().mean(dim=1).to(dt))
        c_act = F.silu(c)
        x = linear(cond, self.x_in, self.x_in_b)
        for blk in self.blocks:
            x = blk(x, c_act)
        return x


class Stream(nn.Module):
    """One stream's weights in a dual-stream block."""

    def __init__(self, cfg: DiTConfig, device=None):
        super().__init__()
        d, dt, f32 = cfg.d_model, cfg.dtype, torch.float32
        dh = d // cfg.num_heads
        self.mod, self.mod_b = _linear_params(d, 6 * d, dt, device)
        self.qkv, self.qkv_b = _linear_params(d, 3 * d, dt, device)
        self.q_norm, self.k_norm = param((dh,), f32, device), param((dh,), f32, device)
        self.proj, self.proj_b = _linear_params(d, d, dt, device)
        self.fc1, self.fc1_b = _linear_params(d, cfg.d_ff, dt, device)
        self.fc2, self.fc2_b = _linear_params(cfg.d_ff, d, dt, device)


class DoubleBlock(nn.Module):
    def __init__(self, cfg: DiTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.img = Stream(cfg, device)
        self.txt = Stream(cfg, device)

    def forward(self, img: torch.Tensor, txt: torch.Tensor, vec_act: torch.Tensor,
                table: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        eps, h = cfg.norm_eps, cfg.num_heads
        b, n, d = img.shape
        mods, qs, ks, vs = [], [], [], []
        for s, x in ((self.img, img), (self.txt, txt)):
            mod = linear(vec_act, s.mod, s.mod_b).chunk(6, dim=-1)
            qkv = linear(modulate(layer_norm(x, eps), mod[0], mod[1]), s.qkv, s.qkv_b)
            qkv = qkv.view(b, x.shape[1], 3, h, d // h)
            mods.append(mod)
            qs.append(qk_norm(qkv[:, :, 0], s.q_norm, eps))
            ks.append(qk_norm(qkv[:, :, 1], s.k_norm, eps))
            vs.append(qkv[:, :, 2])
        q = rope_rows(torch.cat(qs, dim=1), table).to(cfg.dtype)
        k = rope_rows(torch.cat(ks, dim=1), table).to(cfg.dtype)
        a = _attention(q, k, torch.cat(vs, dim=1))
        out = []
        for s, x, mod, a_s in ((self.img, img, mods[0], a[:, :n]),
                               (self.txt, txt, mods[1], a[:, n:])):
            x = gated(x, mod[2], linear(a_s, s.proj, s.proj_b))
            f = F.gelu(linear(modulate(layer_norm(x, eps), mod[3], mod[4]), s.fc1, s.fc1_b),
                       approximate="tanh")
            out.append(gated(x, mod[5], linear(f, s.fc2, s.fc2_b)))
        return out[0], out[1]


class SingleBlock(nn.Module):
    def __init__(self, cfg: DiTConfig, device=None):
        super().__init__()
        d, dt, f32 = cfg.d_model, cfg.dtype, torch.float32
        self.cfg = cfg
        self.mod, self.mod_b = _linear_params(d, 3 * d, dt, device)
        dh = d // cfg.num_heads
        self.lin1, self.lin1_b = _linear_params(d, 3 * d + cfg.d_ff, dt, device)
        self.q_norm, self.k_norm = param((dh,), f32, device), param((dh,), f32, device)
        self.lin2, self.lin2_b = _linear_params(d + cfg.d_ff, d, dt, device)

    def forward(self, x: torch.Tensor, vec_act: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        eps, h = cfg.norm_eps, cfg.num_heads
        b, l, d = x.shape
        sh, sc, g = linear(vec_act, self.mod, self.mod_b).chunk(3, dim=-1)
        y = linear(modulate(layer_norm(x, eps), sh, sc), self.lin1, self.lin1_b)
        qkv = y[..., :3 * d].view(b, l, 3, h, d // h)
        q = rope_rows(qk_norm(qkv[:, :, 0], self.q_norm, eps), table).to(cfg.dtype)
        k = rope_rows(qk_norm(qkv[:, :, 1], self.k_norm, eps), table).to(cfg.dtype)
        a = _attention(q, k, qkv[:, :, 2])
        m = F.gelu(y[..., 3 * d:], approximate="tanh")
        return gated(x, g, linear(torch.cat([a, m], dim=-1), self.lin2, self.lin2_b))


class MMDiT(nn.Module):
    """The DiT of ``cfg``: ``double_layers`` dual-stream blocks, then
    ``num_layers - double_layers`` single-stream blocks."""

    reads_grid = True       # its 3D RoPE: each grid of a shape is a step of its own

    def __init__(self, cfg: DiTConfig, device=None):
        super().__init__()
        d, dt = cfg.d_model, cfg.dtype
        if not 0 < cfg.double_layers <= cfg.num_layers:
            raise ValueError(f"{cfg.name}: double_layers {cfg.double_layers} of {cfg.num_layers}")
        if len(cfg.rope_axes) != 3 or sum(cfg.rope_axes) != d // cfg.num_heads:
            raise ValueError(f"{cfg.name}: rope_axes {cfg.rope_axes} must split the head dim "
                             f"{d // cfg.num_heads} over (t, h, w)")
        self.cfg = cfg
        self.img_in, self.img_in_b = _linear_params(cfg.latent_dim, d, dt, device)
        self.time_in = MLPEmbed(cfg.time_embed_dim, d, dt, device)
        if cfg.guidance:
            self.guidance_in = MLPEmbed(cfg.time_embed_dim, d, dt, device)
        self.txt_in = Refiner(cfg, device)
        self.dual = nn.ModuleList(DoubleBlock(cfg, device) for _ in range(cfg.double_layers))
        self.single = nn.ModuleList(SingleBlock(cfg, device)
                                    for _ in range(cfg.num_layers - cfg.double_layers))
        self.final_mod, self.final_mod_b = _linear_params(d, 2 * d, dt, device)
        self.x_out, self.x_out_b = _linear_params(d, cfg.latent_dim, dt, device)
        self.step_graphs: Optional[diffusion.StepGraphs] = None

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        """Fan-in init of the matrices, norm gains at one, biases at zero;
        AdaLN-Zero: every modulation at zero, so each block starts as the identity."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("ln1", "ln2", "q_norm", "k_norm"):
                p.fill_(1.0)
            elif p.dim() == 1 or leaf in ("mod", "final_mod"):
                p.zero_()
            else:
                common.dense_init_(p, gen)

    def rope_table(self, grid: Optional[Grid], device=None) -> torch.Tensor:
        if grid is None:
            raise ValueError(f"{self.cfg.name} needs the latent grid (f, h, w) for its RoPE")
        return rope_table(tuple(grid), self.cfg.rope_axes, self.cfg.rope_theta, device)

    def grid_inputs(self, grid: Optional[Grid], device=None) -> Tuple[torch.Tensor]:
        """What a step reads besides its latents: the grid's RoPE table."""
        return (self.rope_table(grid, device),)

    def double_part(self, latents: torch.Tensor, t: torch.Tensor, cond: torch.Tensor,
                    table: torch.Tensor):
        """Embeddings, refiner and dual-stream blocks -> (img, txt, SiLU(vec))."""
        cfg = self.cfg
        dt = cfg.dtype
        temb = diffusion.timestep_embedding(t, cfg.time_embed_dim).to(dt)
        vec = self.time_in(temb)
        if cfg.guidance:
            g = torch.full_like(t, 1000.0 * cfg.guidance)
            vec = vec + self.guidance_in(diffusion.timestep_embedding(g, cfg.time_embed_dim).to(dt))
        txt = self.txt_in(cond.to(dt), temb)
        img = linear(latents.to(dt), self.img_in, self.img_in_b)
        vec_act = F.silu(vec)
        for blk in self.dual:
            img, txt = blk(img, txt, vec_act, table)
        return img, txt, vec_act

    def single_part(self, img: torch.Tensor, txt: torch.Tensor, vec_act: torch.Tensor,
                    table: torch.Tensor) -> torch.Tensor:
        """Single-stream blocks and the final layer -> predicted noise, float32."""
        n = img.shape[1]
        x = torch.cat([img, txt], dim=1)
        for blk in self.single:
            x = blk(x, vec_act, table)
        sh, sc = linear(vec_act, self.final_mod, self.final_mod_b).chunk(2, dim=-1)
        x = modulate(layer_norm(x[:, :n], self.cfg.norm_eps), sh, sc)
        return linear(x, self.x_out, self.x_out_b).float()

    def forward(self, latents: torch.Tensor, t: torch.Tensor, cond: torch.Tensor,
                grid: Optional[Grid] = None) -> torch.Tensor:
        """Predicted noise (B, Lx, latent_dim) float32 for latents (B, Lx,
        latent_dim) on the latent grid (f, h, w) at timesteps t (B,)."""
        table = self.rope_table(grid, latents.device)
        return self.single_part(*self.double_part(latents, t, cond, table), table)

    def step_parts(self, x: torch.Tensor, tb: torch.Tensor, cond: torch.Tensor,
                   ab_t: torch.Tensor, ab_n: torch.Tensor, extra: tuple, carry: dict
                   ) -> List[diffusion.Part]:
        """A DDIM step (``diffusion.ddim_step``) in two parts, ``double``
        then ``single``, the first's outputs handed on in ``carry``."""
        (table,) = extra
        attrs = {"tokens": x.shape[1] + cond.shape[1]}

        def double():
            carry["h"] = self.double_part(x, tb, cond, table)

        def single():
            diffusion.ddim_update(x, self.single_part(*carry["h"], table), ab_t, ab_n)

        return [diffusion.Part("double", dict(attrs, blocks=len(self.dual)), double),
                diffusion.Part("single", dict(attrs, blocks=len(self.single)), single)]
