"""Plain PyTorch reference of a text-to-image diffusion pipeline.

Encode: a T5-style bidirectional encoder (RMSNorm with a ``1 + w`` gain,
rotary positions on q and k, full softmax attention, a SwiGLU feed-forward).
Diffuse: a single-stream DiT over the joint [condition; latent] sequence,
AdaLN-modulated RMSNorm before attention and before a tanh-GELU MLP, gated
residuals, sin/cos absolute positions, a sinusoidal timestep embedding,
looped by deterministic DDIM (eta = 0) on a linear beta schedule. Decode: an
AE-KL-style conv decoder (nearest 2x upsampling, SiLU, residual 3x3 convs,
tanh). The equations follow the configuration files beside this folder; the
departures from the published models are listed there under ``assumed``.

Everything runs in float32 with TF32 off (``plain_math``): weights are read
as given (bfloat16 for the served matrices) and widened one layer at a time,
so nothing but the given tensors stays resident. Attention is computed in
blocks of heads and queries so that the scores fit beside the weights.

``fp8=True`` rounds both operands of every product (linear layers, the two
attention products, convolutions) to float8 e4m3 with one scale a tensor,
and accumulates in float32: the control, one precision below the served
bfloat16.

Weights are a dict from the served pipeline's parameter names to tensors;
``param_specs`` lists them, with the seeded initialisation's scale of each.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]
FP8_MAX = 448.0                     # largest finite float8 e4m3fn
ATTN_BLOCK_ELEMENTS = 2 ** 28       # scores held at once: 1 GiB in float32
QK_GAIN = 1.6                       # DiT attention logits of std ~ QK_GAIN ** 2
MOD_GAIN = 1.0
X_GAIN = 0.3                        # latents' share of the DiT's input stream
FINAL_MOD_GAIN = 0.1
POS_FREQ_STD = 1e-5                 # pos * freq stays under ~0.2 at 16k tokens
LATENT_SCALE = 0.5                  # DDIM's latents end near 2 (see ``finish``)


@contextlib.contextmanager
def plain_math():
    """float32 products in full float32: TF32 off for matmuls and convs."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ---------------------------------------------------------------------------
# Parameters: names, shapes, dtypes and the scale of each one's seeded draw
# ---------------------------------------------------------------------------

def param_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(name, shape, dtype, std) of every served parameter, the matrices in
    their stage's dtype and the gains and frequencies in float32. Each is
    drawn from N(0, 1) times its std: 1/sqrt(fan-in) for products, residual
    outputs scaled by 1/sqrt(layers), gains of ``1 + w`` at 0.1, the
    modulations at MOD_GAIN/sqrt(d) and the DiT's queries and keys at
    QK_GAIN/sqrt(d) (attention about as peaked as a trained model's).
    ``finish`` then sets the few that make the DiT a rough noise predictor."""
    enc, dit, dec = cfg["encoder"], cfg["dit"], cfg["decoder"]
    f32 = "float32"
    out = []
    bf = enc["dtype"]
    d, v = enc["d_model"], enc["vocab_size"]
    dh = enc["head_dim"] or d // enc["num_heads"]
    hq, hkv, ff, n = enc["num_heads"] * dh, enc["num_kv_heads"] * dh, enc["d_ff"], enc["num_layers"]
    out += [("encoder.embed", (v, d), bf, 1.0), ("encoder.final_norm", (d,), f32, 0.1),
            ("encoder.lm_head", (d, v), bf, d ** -0.5)]
    for i in range(n):
        p = f"encoder.layers.{i}."
        out += [(p + "ln1", (d,), f32, 0.1), (p + "wq", (d, hq), bf, d ** -0.5),
                (p + "wk", (d, hkv), bf, d ** -0.5), (p + "wv", (d, hkv), bf, d ** -0.5),
                (p + "wo", (hq, d), bf, (hq * n) ** -0.5), (p + "ln2", (d,), f32, 0.1),
                (p + "w_gate", (d, ff), bf, d ** -0.5), (p + "w_up", (d, ff), bf, d ** -0.5),
                (p + "w_down", (ff, d), bf, (ff * n) ** -0.5)]
    bf = dit["dtype"]
    d, ff, n = dit["d_model"], dit["d_ff"], dit["num_layers"]
    te, lat, cd = dit["time_embed_dim"], dit["latent_dim"], dit["cond_dim"]
    out += [("dit.x_in", (lat, d), bf, X_GAIN * lat ** -0.5),
            ("dit.cond_in", (cd, d), bf, cd ** -0.5),
            ("dit.t_mlp1", (te, d), bf, te ** -0.5), ("dit.t_mlp2", (d, d), bf, d ** -0.5)]
    for i in range(n):
        p = f"dit.layers.{i}."
        out += [(p + "wq", (d, d), bf, QK_GAIN * d ** -0.5),
                (p + "wk", (d, d), bf, QK_GAIN * d ** -0.5),
                (p + "wv", (d, d), bf, d ** -0.5), (p + "wo", (d, d), bf, (d * n) ** -0.5),
                (p + "w_up", (d, ff), bf, d ** -0.5), (p + "w_down", (ff, d), bf, (ff * n) ** -0.5),
                (p + "mod", (d, 6 * d), bf, MOD_GAIN * d ** -0.5)]
    out += [("dit.final_mod", (d, 2 * d), bf, FINAL_MOD_GAIN * d ** -0.5),
            ("dit.x_out", (d, lat), bf, d ** -0.5),
            ("dit.pos_freq", (2, d // 2), f32, POS_FREQ_STD)]
    bf = dec["dtype"]
    ch, lc = dec["base_channels"], dec["latent_channels"]
    out.append(("decoder.conv_in", (ch, lc, 3, 3), bf, LATENT_SCALE * (9 * lc) ** -0.5))
    for i in range(dec["num_upsamples"]):
        cin, cout = max(ch // 2 ** i, 32), max(ch // 2 ** (i + 1), 32)
        out.append((f"decoder.up{i}_in", (cout, cin, 3, 3), bf, (9 * cin) ** -0.5))
        for r in range(dec["res_blocks"]):
            out.append((f"decoder.up{i}_res{r}", (cout, cout, 3, 3), bf, 0.5 * (9 * cout) ** -0.5))
    cfin = max(ch // 2 ** dec["num_upsamples"], 32)
    out.append(("decoder.conv_out", (dec["out_channels"], cfin, 3, 3), bf,
                2.0 * (9 * cfin) ** -0.5))
    return out


def timestep_row(time_embed_dim: int) -> int:
    """The timestep embedding's entry cos(t f) whose frequency f takes t
    from 999 to 0 over a quarter turn: about 0 at t = 999, 1 at t = 0."""
    half = time_embed_dim // 2
    return round(half * math.log(2 * 999 / math.pi) / math.log(10000.0))


@torch.no_grad()
def finish(W: Weights, cfg: dict) -> None:
    """Make the seeded DiT a rough noise predictor, in place, so that DDIM
    keeps its latents near unit size and every step weighs in the output.

    A DiT with nothing but random weights does not predict the noise it is
    given, and deterministic DDIM then grows its latents about
    1/sqrt(alpha_bar[999]) ~ 160 times: an error in the first step moves the
    pixels some hundreds of times more than one in the last. Here:

    - ``x_out`` is sqrt(X_GAIN^2 + 1/2) times the pseudo-inverse of ``x_in``,
      less its response to the positions' constant half (cos(p f) ~ 1 at
      POS_FREQ_STD), so the final RMSNorm of [X_GAIN x; ~1; layers' output]
      hands about x back: a noise estimate of x itself, on which the DDIM
      update changes x's size little;
    - the timestep reaches the modulations through one frequency
      (``timestep_row``), so every gate, scale and shift is about 0 at
      t = 999 and grows as t falls: the layers, the prompt with them, add
      little where an error weighs most and more towards the end, as a
      trained model's content does."""
    dit = cfg["dit"]
    d = dit["d_model"]
    x_in = W["dit.x_in"].float()
    pos_const = torch.cat([torch.zeros(d // 2), torch.ones(d // 2)]).to(x_in.device)
    pos_const /= (d / 2) ** 0.5
    x_out = torch.linalg.pinv(x_in) * (X_GAIN ** 2 + 0.5) ** 0.5
    x_out -= pos_const[:, None] * (pos_const[None] @ x_out)
    W["dit.x_out"].copy_(x_out)
    t1 = W["dit.t_mlp1"]
    t1.zero_()
    t1[timestep_row(dit["time_embed_dim"])] = 1.0


# ---------------------------------------------------------------------------
# Products, in float32 or through float8
# ---------------------------------------------------------------------------

def _q8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under one scale (its largest magnitude at
    the format's largest value), back in float32."""
    t = t.float()
    amax = t.abs().amax().clamp_min(1e-30)
    s = amax / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


def _w(W: Weights, name: str, fp8: bool) -> torch.Tensor:
    w = W[name].float()
    return _q8(w) if fp8 else w


def _mm(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    return (_q8(x) if fp8 else x) @ w


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, fp8: bool) -> torch.Tensor:
    """Full softmax attention, q/k/v (B, L, H, Dh) float32 -> (B, L, H, Dh),
    in blocks of heads and queries of at most ATTN_BLOCK_ELEMENTS scores."""
    b, lq, h, dh = q.shape
    lk = k.shape[1]
    scale = 1.0 / math.sqrt(dh)
    out = torch.empty_like(q)
    heads = max(1, min(h, ATTN_BLOCK_ELEMENTS // (lq * lk)))
    rows = max(1, min(lq, ATTN_BLOCK_ELEMENTS // (heads * lk)))
    for bi in range(b):
        for h0 in range(0, h, heads):
            kh = k[bi, :, h0:h0 + heads].transpose(0, 1)          # (h, Lk, Dh)
            vh = v[bi, :, h0:h0 + heads].transpose(0, 1)
            if fp8:
                kh, vh = _q8(kh), _q8(vh)
            for r0 in range(0, lq, rows):
                qh = q[bi, r0:r0 + rows, h0:h0 + heads].transpose(0, 1)
                if fp8:
                    qh = _q8(qh)
                p = torch.softmax((qh @ kh.transpose(1, 2)) * scale, dim=-1)
                if fp8:
                    p = _q8(p)
                out[bi, r0:r0 + rows, h0:h0 + heads] = (p @ vh).transpose(0, 1)
    return out


def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + gain.float())


def adaln(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm without a gain, then ``* (1 + scale) + shift`` per batch row."""
    xn = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return xn * (1.0 + scale[:, None, :]) + shift[:, None, :]


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary positions 0..L-1 on (B, L, H, Dh), the two halves rotated."""
    l, dh = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32, device=x.device) / dh)
    ang = (torch.arange(l, dtype=torch.float32, device=x.device)[:, None] * freqs)[:, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

def encode(W: Weights, cfg: dict, tokens: torch.Tensor, fp8: bool = False) -> torch.Tensor:
    """Token ids (B, Lc) -> condition (B, Lc, d) float32."""
    enc = cfg["encoder"]
    eps, h, hkv = enc["norm_eps"], enc["num_heads"], enc["num_kv_heads"]
    dh = enc["head_dim"] or enc["d_model"] // h
    x = W["encoder.embed"][tokens].float()
    b, l, _ = x.shape
    for i in range(enc["num_layers"]):
        p = f"encoder.layers.{i}."
        hn = rms_norm(x, W[p + "ln1"], eps)
        q = rope(_mm(hn, _w(W, p + "wq", fp8), fp8).reshape(b, l, h, dh), enc["rope_theta"])
        k = rope(_mm(hn, _w(W, p + "wk", fp8), fp8).reshape(b, l, hkv, dh), enc["rope_theta"])
        v = _mm(hn, _w(W, p + "wv", fp8), fp8).reshape(b, l, hkv, dh)
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
        a = attention(q, k, v, fp8).reshape(b, l, h * dh)
        x = x + _mm(a, _w(W, p + "wo", fp8), fp8)
        hn = rms_norm(x, W[p + "ln2"], eps)
        g = F.silu(_mm(hn, _w(W, p + "w_gate", fp8), fp8)) * _mm(hn, _w(W, p + "w_up", fp8), fp8)
        x = x + _mm(g, _w(W, p + "w_down", fp8), fp8)
    return rms_norm(x, W["encoder.final_norm"], eps)


# ---------------------------------------------------------------------------
# Diffuse
# ---------------------------------------------------------------------------

def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def dit_forward(W: Weights, cfg: dict, latents: torch.Tensor, t: torch.Tensor,
                cond: torch.Tensor, fp8: bool = False) -> torch.Tensor:
    """Predicted noise (B, Lx, latent_dim) for latents (B, Lx, latent_dim)
    at timesteps t (B,) under condition (B, Lc, cond_dim)."""
    dit = cfg["dit"]
    d, h, eps = dit["d_model"], dit["num_heads"], dit["norm_eps"]
    dh = d // h
    lc = cond.shape[1]
    x = torch.cat([_mm(cond, _w(W, "dit.cond_in", fp8), fp8),
                   _mm(latents, _w(W, "dit.x_in", fp8), fp8)], dim=1)
    b, l, _ = x.shape
    pos = torch.arange(l, dtype=torch.float32, device=x.device)[:, None]
    pf = W["dit.pos_freq"].float()
    x = x + torch.cat([torch.sin(pos * pf[0][None]), torch.cos(pos * pf[1][None])], dim=-1)[None]
    tc = _mm(timestep_embedding(t, dit["time_embed_dim"]), _w(W, "dit.t_mlp1", fp8), fp8)
    tc = _mm(F.silu(tc), _w(W, "dit.t_mlp2", fp8), fp8)
    for i in range(dit["num_layers"]):
        p = f"dit.layers.{i}."
        mod = _mm(tc, _w(W, p + "mod", fp8), fp8).reshape(b, 6, d)
        s1, sh1, g1, s2, sh2, g2 = mod.unbind(1)
        hn = adaln(x, s1, sh1, eps)
        q = _mm(hn, _w(W, p + "wq", fp8), fp8).reshape(b, l, h, dh)
        k = _mm(hn, _w(W, p + "wk", fp8), fp8).reshape(b, l, h, dh)
        v = _mm(hn, _w(W, p + "wv", fp8), fp8).reshape(b, l, h, dh)
        a = attention(q, k, v, fp8).reshape(b, l, d)
        x = x + g1[:, None, :] * _mm(a, _w(W, p + "wo", fp8), fp8)
        hn = adaln(x, s2, sh2, eps)
        f = F.gelu(_mm(hn, _w(W, p + "w_up", fp8), fp8), approximate="tanh")
        x = x + g2[:, None, :] * _mm(f, _w(W, p + "w_down", fp8), fp8)
    fmod = _mm(tc, _w(W, "dit.final_mod", fp8), fp8).reshape(b, 2, d)
    x = adaln(x, fmod[:, 0], fmod[:, 1], eps)
    return _mm(x[:, lc:], _w(W, "dit.x_out", fp8), fp8)


def linspace32(start: float, stop: float, num: int) -> torch.Tensor:
    """float32 ``start * (1 - s) + stop * s`` with ``s = i * (1 / (num - 1))``,
    then the endpoint: the schedule's arithmetic, whose truncation to
    integers gives the DDIM timesteps."""
    if num == 1:
        return torch.tensor([start], dtype=torch.float32)
    recip = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(num - 1, dtype=torch.float32)
    s = torch.arange(num - 1, dtype=torch.float32) * recip
    a = torch.tensor(start, dtype=torch.float32)
    z = torch.tensor(stop, dtype=torch.float32)
    return torch.cat([a * (1 - s) + z * s, z[None]])


def ddim(W: Weights, cfg: dict, noise: torch.Tensor, cond: torch.Tensor, num_steps: int,
         fp8: bool = False) -> torch.Tensor:
    """Deterministic DDIM from ``noise`` over ``num_steps`` of 1000 linear-beta steps."""
    alpha_bar = torch.cumprod(1.0 - linspace32(1e-4, 0.02, 1000), dim=0).to(noise.device)
    ts = linspace32(999, 0, num_steps).to(torch.int32).tolist()
    x = noise.float()
    for i, t in enumerate(ts):
        ab_t = alpha_bar[t]
        ab_n = alpha_bar[ts[i + 1]] if i + 1 < num_steps else torch.ones_like(ab_t)
        tb = torch.full((x.shape[0],), float(t), dtype=torch.float32, device=x.device)
        e = dit_forward(W, cfg, x, tb, cond, fp8)
        x0 = (x - torch.sqrt(1 - ab_t) * e) / torch.sqrt(ab_t)
        x = torch.sqrt(ab_n) * x0 + torch.sqrt(1 - ab_n) * e
    return x


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _conv(x: torch.Tensor, W: Weights, name: str, fp8: bool) -> torch.Tensor:
    return F.conv2d(_q8(x) if fp8 else x, _w(W, name, fp8), padding=1)


def decode(W: Weights, cfg: dict, latents: torch.Tensor, grid: Tuple[int, int, int],
           fp8: bool = False) -> torch.Tensor:
    """Latent tokens (B, F*h*w, 4*latent_channels) -> pixels (B*F, 16h, 16w, 3)."""
    dec = cfg["decoder"]
    f, h, w = grid
    b = latents.shape[0]
    cl = dec["latent_channels"]
    z = latents.reshape(b * f, h, w, 2, 2, cl).permute(0, 1, 3, 2, 4, 5)
    x = z.reshape(b * f, 2 * h, 2 * w, cl).permute(0, 3, 1, 2)
    x = _conv(x, W, "decoder.conv_in", fp8)
    for i in range(dec["num_upsamples"]):
        x = F.interpolate(F.silu(x), scale_factor=2, mode="nearest")
        x = _conv(x, W, f"decoder.up{i}_in", fp8)
        for r in range(dec["res_blocks"]):
            x = x + _conv(F.silu(x), W, f"decoder.up{i}_res{r}", fp8)
    x = _conv(F.silu(x), W, "decoder.conv_out", fp8)
    return torch.tanh(x).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# The whole request
# ---------------------------------------------------------------------------

def latent_grid(cfg: dict, resolution: int, seconds: float = 0.0) -> Tuple[int, int, int]:
    """(frames, h, w): 8x VAE and 2x2 patches, so 1/16 of the side; video at
    16 fps with 4x temporal compression."""
    side = max(2, resolution // 16)
    frames = max(1, int(seconds * 16) // 4) if cfg["pipeline"]["is_video"] else 1
    return frames, side, side


@torch.no_grad()
def generate(W: Weights, cfg: dict, tokens: torch.Tensor, noise: torch.Tensor, resolution: int,
             seconds: float = 0.0, num_steps: int = 0, fp8: bool = False) -> torch.Tensor:
    """Pixels of the requests whose prompt ids are ``tokens`` (B, Lc) and
    whose starting latents are ``noise`` (B, L, latent_dim)."""
    with plain_math():
        cond = encode(W, cfg, tokens, fp8)
        lat = ddim(W, cfg, noise, cond, num_steps or cfg["pipeline"]["num_steps"], fp8)
        return decode(W, cfg, lat, latent_grid(cfg, resolution, seconds), fp8)


def pixel_gap(out: torch.Tensor, ref: torch.Tensor) -> float:
    """||out - ref|| / ||ref|| over every pixel of one request."""
    out, ref = out.float(), ref.float()
    return float(torch.linalg.vector_norm(out - ref) / torch.linalg.vector_norm(ref))

