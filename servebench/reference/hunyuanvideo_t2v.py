"""Plain PyTorch reference of HunyuanVideo T2V as the port serves it.

Encode: a Llama-style causal encoder with grouped KV heads (RMSNorm with a
``1 + w`` gain, rotary positions on q and k with the two halves rotated,
causal softmax attention, a SwiGLU feed-forward), handing on its last
layer's states with no final norm. Diffuse: Tencent's
``HYVideoDiffusionTransformer`` (LN is LayerNorm without affine, every
Linear has a bias, ``mod(v) = Linear(SiLU(v))``)::

    vec   = MLP_t(temb(t)) + MLP_g(temb(1000 guidance))
    txt   = refiner(cond, t)   # Linear cond_dim -> d; c = MLP_t'(temb(t)) + MLP_c(mean_L cond);
                               # per block: x += g1 Attn(LN_affine(x));
                               #            x += g2 MLP_silu(LN_affine(x))
    img   = Linear(latent_dim -> d)(latents)
    dual  (double_layers, a weight set per stream): q, k, v_s from LN(x_s) (1 + sc1) + sh1,
          RMSNorm per head on q and k (gain w), RoPE3D on the image rows, one attention
          over [img; txt], gated projection and gated tanh-GELU MLP per stream
    single (the rest, x = [img; txt]): q, k, v, m from one Linear d -> 3d + d_ff,
          x += g Linear([Attn(q, k, v); gelu_tanh(m)])
    out   = Linear(d -> latent_dim)(LN(x_img) (1 + sc) + sh), (sh, sc) = mod(vec)

RoPE3D: the latent grid (f, h, w) flattened t-major, head-dim axes
``rope_axes`` over (t, h, w), frequencies 1/theta^(2i/dim), cos and sin
repeated for each ADJACENT pair: out = x cos + rot(x) sin with
rot(x)[2i] = -x[2i+1], rot(x)[2i+1] = x[2i]. Looped by deterministic DDIM
on the linear beta schedule; decoded by ``dit_pipeline``'s AE-KL decoder.
The DiT's latents here are (B, F, h, w, latent_dim): the grid is their shape.

Float32 with TF32 off, weights widened as read; ``fp8=True`` rounds both
operands of every product to float8 e4m3 (``dit_pipeline``'s control).
``param_specs`` lists the served parameters with their seeded scales;
``finish`` makes the seeded DiT a rough noise predictor.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F

from . import dit_pipeline as dp
from .dit_pipeline import (Weights, _mm, _q8, _w, attention, decode, latent_grid, linspace32,
                           pixel_gap, plain_math, rms_norm, rope, timestep_embedding,
                           timestep_row)

__all__ = ["param_specs", "finish", "encode", "dit_forward", "ddim", "generate", "pixel_gap",
           "linspace32", "latent_grid", "decode"]

QK_GAIN = 1.6                       # QK-norm gains: attention logits of std ~ QK_GAIN ** 2
MOD_GAIN = 1.0
X_GAIN = 0.3                        # the latents' share of the image stream
IMG_BIAS = 0.7                      # rms of img_in's bias: the stream's constant part
FINAL_MOD_GAIN = 0.1
GUIDANCE_GAIN = 0.05                # the guidance embedding's share of vec
BIAS_STD = 0.02
MOD_BIAS_STD = 0.002                # modulations near 0 where vec is (t = 999)
GAIN_STD = 0.1                      # norm gains of 1 + w


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _lin(name: str, d_in: int, d_out: int, dt: str, std: float,
         bias_std: float = BIAS_STD) -> list:
    return [(name, (d_in, d_out), dt, std), (name + "_b", (d_out,), dt, bias_std)]


def _embed(prefix: str, d_in: int, d: int, dt: str, gain: float = 1.0) -> list:
    return [(prefix + ".w1", (d_in, d), dt, d_in ** -0.5), (prefix + ".b1", (d,), dt, BIAS_STD),
            (prefix + ".w2", (d, d), dt, gain * d ** -0.5), (prefix + ".b2", (d,), dt, BIAS_STD)]


def param_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(name, shape, dtype, std) of every served parameter: the encoder and
    decoder as ``dit_pipeline`` draws them (no LM head where the encoder
    ties its embeddings), then the DiT. Products at 1/sqrt(fan-in),
    residual outputs also by 1/sqrt(layers), biases at BIAS_STD,
    modulations at MOD_GAIN/sqrt(d) with biases at MOD_BIAS_STD, norm gains
    drawn as w of ``1 + w`` (``finish`` adds the 1)."""
    enc, dit = cfg["encoder"], cfg["dit"]
    tied = enc.get("tie_embeddings", False)
    out = [s for s in dp.param_specs(cfg) if s[0].startswith("encoder.")
           and not (tied and s[0] == "encoder.lm_head")]
    bf, f32 = dit["dtype"], "float32"
    d, ff, n = dit["d_model"], dit["d_ff"], dit["num_layers"]
    te, lat, cd = dit["time_embed_dim"], dit["latent_dim"], dit["cond_dim"]
    nr = dit["refiner_layers"]
    dh = d // dit["num_heads"]
    out += _lin("dit.img_in", lat, d, bf, X_GAIN * lat ** -0.5)
    out += _embed("dit.time_in", te, d, bf)
    if dit["guidance"]:
        out += _embed("dit.guidance_in", te, d, bf, GUIDANCE_GAIN)
    out += _lin("dit.txt_in.x_in", cd, d, bf, cd ** -0.5)
    out += _embed("dit.txt_in.t_embed", te, d, bf) + _embed("dit.txt_in.c_embed", cd, d, bf)
    for i in range(nr):
        p = f"dit.txt_in.blocks.{i}."
        out += [(p + "ln1", (d,), f32, GAIN_STD), (p + "ln1_b", (d,), f32, GAIN_STD)]
        out += _lin(p + "qkv", d, 3 * d, bf, d ** -0.5)
        out += _lin(p + "proj", d, d, bf, (d * nr) ** -0.5)
        out += [(p + "ln2", (d,), f32, GAIN_STD), (p + "ln2_b", (d,), f32, GAIN_STD)]
        out += _lin(p + "fc1", d, ff, bf, d ** -0.5) + _lin(p + "fc2", ff, d, bf, (ff * nr) ** -0.5)
        out += _lin(p + "mod", d, 2 * d, bf, MOD_GAIN * d ** -0.5, MOD_BIAS_STD)
    for i in range(dit["double_layers"]):
        for s in ("img", "txt"):
            p = f"dit.dual.{i}.{s}."
            out += _lin(p + "mod", d, 6 * d, bf, MOD_GAIN * d ** -0.5, MOD_BIAS_STD)
            out += _lin(p + "qkv", d, 3 * d, bf, d ** -0.5)
            out += [(p + "q_norm", (dh,), f32, GAIN_STD), (p + "k_norm", (dh,), f32, GAIN_STD)]
            out += _lin(p + "proj", d, d, bf, (d * n) ** -0.5)
            out += _lin(p + "fc1", d, ff, bf, d ** -0.5)
            out += _lin(p + "fc2", ff, d, bf, (ff * n) ** -0.5)
    for i in range(n - dit["double_layers"]):
        p = f"dit.single.{i}."
        out += _lin(p + "mod", d, 3 * d, bf, MOD_GAIN * d ** -0.5, MOD_BIAS_STD)
        out += _lin(p + "lin1", d, 3 * d + ff, bf, d ** -0.5)
        out += [(p + "q_norm", (dh,), f32, GAIN_STD), (p + "k_norm", (dh,), f32, GAIN_STD)]
        out += _lin(p + "lin2", d + ff, d, bf, ((d + ff) * n) ** -0.5)
    out += _lin("dit.final_mod", d, 2 * d, bf, FINAL_MOD_GAIN * d ** -0.5, MOD_BIAS_STD)
    out += _lin("dit.x_out", d, lat, bf, d ** -0.5)
    out += [s for s in dp.param_specs(cfg) if s[0].startswith("decoder.")]
    return out


@torch.no_grad()
def finish(W: Weights, cfg: dict) -> None:
    """Make the seeded DiT a rough noise predictor, in place, so that DDIM
    keeps its latents near unit size and every step weighs in the output
    (``dit_pipeline.finish``'s reasoning):

    - ``img_in``'s rows are made zero-mean and its bias a zero-mean
      vector of rms IMG_BIAS orthogonal to them, the constant part of the
      image stream (``dit_pipeline``'s positions' cos half): the final
      LayerNorm then divides a token by sqrt(its latents' part^2 +
      IMG_BIAS^2), which a token's own size moves little. ``x_out`` is the
      pseudo-inverse of ``img_in`` times sqrt(trace(img_in img_in^T) / d +
      IMG_BIAS^2), less its response to the bias: at small gates the DiT
      hands back about x, a noise estimate of x itself;
    - the timestep reaches ``vec`` through one frequency of ``time_in``
      (``timestep_row``, no bias before the SiLU), so vec is about 0 at
      t = 999, where only the small guidance term and the modulations'
      biases are left, and grows as t falls;
    - norm gains are 1 + w; the QK-norm gains QK_GAIN (1 + w)."""
    dit = cfg["dit"]
    d = dit["d_model"]
    x_in = W["dit.img_in"].float()
    W["dit.img_in"].copy_(x_in - x_in.mean(dim=1, keepdim=True))
    x_in = W["dit.img_in"].float()
    basis = torch.linalg.qr(torch.cat([x_in, torch.ones_like(x_in[:1])]).T).Q
    bias = W["dit.img_in_b"].float()
    bias -= basis @ (basis.T @ bias)
    W["dit.img_in_b"].copy_(bias * IMG_BIAS / bias.square().mean().sqrt())
    bias = W["dit.img_in_b"].float()
    scale = (torch.trace(x_in @ x_in.T) / d + bias.square().mean()) ** 0.5
    x_out = torch.linalg.pinv(x_in) * scale
    unit = bias / torch.linalg.vector_norm(bias)
    W["dit.x_out"].copy_(x_out - unit[:, None] * (unit[None] @ x_out))
    for name in ("dit.x_out_b", "dit.time_in.b1", "dit.time_in.b2"):
        W[name].zero_()
    t1 = W["dit.time_in.w1"]
    t1.zero_()
    t1[timestep_row(dit["time_embed_dim"])] = 1.0
    if dit["guidance"]:
        W["dit.guidance_in.b2"].zero_()
    for name, w in W.items():
        if not name.startswith("dit."):
            continue
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("q_norm", "k_norm"):
            w.add_(1.0).mul_(QK_GAIN)
        elif leaf in ("ln1", "ln2"):
            w.add_(1.0)


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, fp8: bool) -> torch.Tensor:
    """Causal softmax attention, (B, L, H, Dh) float32 each."""
    l, dh = q.shape[1], q.shape[-1]
    if fp8:
        q, k, v = _q8(q), _q8(k), _q8(v)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
    mask = torch.ones((l, l), dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    if fp8:
        p = _q8(p)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def encode(W: Weights, cfg: dict, tokens: torch.Tensor, fp8: bool = False) -> torch.Tensor:
    """Token ids (B, Lc) -> the last layer's states (B, Lc, d) float32
    (through the final norm only where the configuration has one)."""
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
        a = causal_attention(q, k, v, fp8).reshape(b, l, h * dh)
        x = x + _mm(a, _w(W, p + "wo", fp8), fp8)
        hn = rms_norm(x, W[p + "ln2"], eps)
        g = F.silu(_mm(hn, _w(W, p + "w_gate", fp8), fp8)) * _mm(hn, _w(W, p + "w_up", fp8), fp8)
        x = x + _mm(g, _w(W, p + "w_down", fp8), fp8)
    return rms_norm(x, W["encoder.final_norm"], eps) if enc.get("final_norm", True) else x


# ---------------------------------------------------------------------------
# Diffuse
# ---------------------------------------------------------------------------

def _linear(W: Weights, name: str, x: torch.Tensor, fp8: bool) -> torch.Tensor:
    return _mm(x, _w(W, name, fp8), fp8) + W[name + "_b"].float()


def _mlp_embed(W: Weights, prefix: str, x: torch.Tensor, fp8: bool) -> torch.Tensor:
    h = _mm(x, _w(W, prefix + ".w1", fp8), fp8) + W[prefix + ".b1"].float()
    return _mm(F.silu(h), _w(W, prefix + ".w2", fp8), fp8) + W[prefix + ".b2"].float()


def layer_norm(x: torch.Tensor, eps: float, w=None, b=None) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    return out if w is None else out * w.float() + b.float()


def _modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * (1.0 + scale[:, None]) + shift[:, None]


def head_rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def rope3d_cos_sin(grid: Tuple[int, int, int], axes, theta: float, device
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (f*h*w, sum(axes)): per axis the angles of the
    token's position, each repeated for its pair, the axes concatenated."""
    mesh = torch.meshgrid(*[torch.arange(n, dtype=torch.float32, device=device) for n in grid],
                          indexing="ij")
    cos, sin = [], []
    for pos, dim in zip(mesh, axes):
        freqs = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim)
        ang = pos.reshape(-1)[:, None] * freqs[None]
        cos.append(torch.cos(ang).repeat_interleave(2, dim=1))
        sin.append(torch.sin(ang).repeat_interleave(2, dim=1))
    return torch.cat(cos, dim=1), torch.cat(sin, dim=1)


def apply_rope3d(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, n, H, Dh) with adjacent pairs rotated."""
    pairs = x.reshape(*x.shape[:-1], -1, 2)
    rot = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)
    return x * cos[None, :, None] + rot * sin[None, :, None]


def _rope_img(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """RoPE3D on the image rows (the first len(cos)) of a joint [img; txt] sequence."""
    n = cos.shape[0]
    return torch.cat([apply_rope3d(x[:, :n], cos, sin), x[:, n:]], dim=1)


def refiner(W: Weights, cfg: dict, cond: torch.Tensor, temb: torch.Tensor,
            fp8: bool) -> torch.Tensor:
    dit = cfg["dit"]
    d, h, eps = dit["d_model"], dit["num_heads"], dit["norm_eps"]
    c = (_mlp_embed(W, "dit.txt_in.t_embed", temb, fp8)
         + _mlp_embed(W, "dit.txt_in.c_embed", cond.mean(dim=1), fp8))
    ca = F.silu(c)
    x = _linear(W, "dit.txt_in.x_in", cond, fp8)
    b, l, _ = x.shape
    for i in range(dit["refiner_layers"]):
        p = f"dit.txt_in.blocks.{i}."
        g1, g2 = _linear(W, p + "mod", ca, fp8).chunk(2, dim=-1)
        qkv = _linear(W, p + "qkv", layer_norm(x, eps, W[p + "ln1"], W[p + "ln1_b"]), fp8)
        q, k, v = qkv.reshape(b, l, 3, h, d // h).unbind(2)
        a = attention(q, k, v, fp8).reshape(b, l, d)
        x = x + g1[:, None] * _linear(W, p + "proj", a, fp8)
        f = F.silu(_linear(W, p + "fc1", layer_norm(x, eps, W[p + "ln2"], W[p + "ln2_b"]), fp8))
        x = x + g2[:, None] * _linear(W, p + "fc2", f, fp8)
    return x


def dual_block(W: Weights, cfg: dict, i: int, img: torch.Tensor, txt: torch.Tensor,
               va: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               fp8: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dual-stream block ``i``: (img, txt) -> (img, txt); ``va`` = SiLU(vec)."""
    dit = cfg["dit"]
    d, h, eps = dit["d_model"], dit["num_heads"], dit["norm_eps"]
    b, n, _ = img.shape
    mods, qs, ks, vs = [], [], [], []
    for s, x in (("img", img), ("txt", txt)):
        p = f"dit.dual.{i}.{s}."
        mod = _linear(W, p + "mod", va, fp8).chunk(6, dim=-1)
        qkv = _linear(W, p + "qkv", _modulate(layer_norm(x, eps), mod[0], mod[1]), fp8)
        q, k, v = qkv.reshape(b, x.shape[1], 3, h, d // h).unbind(2)
        mods.append(mod)
        qs.append(head_rms_norm(q, W[p + "q_norm"], eps))
        ks.append(head_rms_norm(k, W[p + "k_norm"], eps))
        vs.append(v)
    q = _rope_img(torch.cat(qs, dim=1), cos, sin)
    k = _rope_img(torch.cat(ks, dim=1), cos, sin)
    a = attention(q, k, torch.cat(vs, dim=1), fp8).reshape(b, -1, d)
    out = []
    for s, x, mod, a_s in (("img", img, mods[0], a[:, :n]), ("txt", txt, mods[1], a[:, n:])):
        p = f"dit.dual.{i}.{s}."
        x = x + mod[2][:, None] * _linear(W, p + "proj", a_s, fp8)
        y = _linear(W, p + "fc1", _modulate(layer_norm(x, eps), mod[3], mod[4]), fp8)
        out.append(x + mod[5][:, None] * _linear(W, p + "fc2", F.gelu(y, approximate="tanh"), fp8))
    return out[0], out[1]


def single_block(W: Weights, cfg: dict, i: int, x: torch.Tensor, va: torch.Tensor,
                 cos: torch.Tensor, sin: torch.Tensor, fp8: bool = False) -> torch.Tensor:
    """Single-stream block ``i`` on the joint [img; txt] stream x (B, L, d)."""
    dit = cfg["dit"]
    d, h, eps = dit["d_model"], dit["num_heads"], dit["norm_eps"]
    b, l, _ = x.shape
    p = f"dit.single.{i}."
    sh, sc, g = _linear(W, p + "mod", va, fp8).chunk(3, dim=-1)
    y = _linear(W, p + "lin1", _modulate(layer_norm(x, eps), sh, sc), fp8)
    q, k, v = y[..., :3 * d].reshape(b, l, 3, h, d // h).unbind(2)
    q = _rope_img(head_rms_norm(q, W[p + "q_norm"], eps), cos, sin)
    k = _rope_img(head_rms_norm(k, W[p + "k_norm"], eps), cos, sin)
    a = attention(q, k, v, fp8).reshape(b, l, d)
    m = F.gelu(y[..., 3 * d:], approximate="tanh")
    return x + g[:, None] * _linear(W, p + "lin2", torch.cat([a, m], dim=-1), fp8)


def vec_act(W: Weights, cfg: dict, t: torch.Tensor, fp8: bool = False) -> torch.Tensor:
    """SiLU(vec): the timestep's and the embedded guidance's MLPs, summed."""
    dit = cfg["dit"]
    te = dit["time_embed_dim"]
    vec = _mlp_embed(W, "dit.time_in", timestep_embedding(t, te), fp8)
    if dit["guidance"]:
        g = torch.full_like(t, 1000.0 * dit["guidance"], dtype=torch.float32)
        vec = vec + _mlp_embed(W, "dit.guidance_in", timestep_embedding(g, te), fp8)
    return F.silu(vec)


def dit_forward(W: Weights, cfg: dict, latents: torch.Tensor, t: torch.Tensor,
                cond: torch.Tensor, fp8: bool = False) -> torch.Tensor:
    """Predicted noise (B, F, h, w, latent_dim) for latents of that shape at
    timesteps t (B,) under the encoder's states ``cond`` (B, Lc, cond_dim)."""
    dit = cfg["dit"]
    b, f, gh, gw, lat = latents.shape
    n = f * gh * gw
    cos, sin = rope3d_cos_sin((f, gh, gw), dit["rope_axes"], dit["rope_theta"], latents.device)
    va = vec_act(W, cfg, t, fp8)
    txt = refiner(W, cfg, cond, timestep_embedding(t, dit["time_embed_dim"]), fp8)
    img = _linear(W, "dit.img_in", latents.reshape(b, n, lat), fp8)
    for i in range(dit["double_layers"]):
        img, txt = dual_block(W, cfg, i, img, txt, va, cos, sin, fp8)
    x = torch.cat([img, txt], dim=1)
    for i in range(dit["num_layers"] - dit["double_layers"]):
        x = single_block(W, cfg, i, x, va, cos, sin, fp8)
    sh, sc = _linear(W, "dit.final_mod", va, fp8).chunk(2, dim=-1)
    out = _linear(W, "dit.x_out", _modulate(layer_norm(x[:, :n], dit["norm_eps"]), sh, sc), fp8)
    return out.reshape(latents.shape)


def ddim(W: Weights, cfg: dict, noise: torch.Tensor, cond: torch.Tensor, num_steps: int,
         grid: Tuple[int, int, int], fp8: bool = False) -> torch.Tensor:
    """Deterministic DDIM from ``noise`` (B, f*h*w, latent_dim) over
    ``num_steps`` of 1000 linear-beta steps, on the latent grid ``grid``."""
    alpha_bar = torch.cumprod(1.0 - linspace32(1e-4, 0.02, 1000), dim=0).to(noise.device)
    ts = linspace32(999, 0, num_steps).to(torch.int32).tolist()
    b, _, lat = noise.shape
    x = noise.float().reshape(b, *grid, lat)
    for i, t in enumerate(ts):
        ab_t = alpha_bar[t]
        ab_n = alpha_bar[ts[i + 1]] if i + 1 < num_steps else torch.ones_like(ab_t)
        tb = torch.full((b,), float(t), dtype=torch.float32, device=x.device)
        e = dit_forward(W, cfg, x, tb, cond, fp8)
        x0 = (x - torch.sqrt(1 - ab_t) * e) / torch.sqrt(ab_t)
        x = torch.sqrt(ab_n) * x0 + torch.sqrt(1 - ab_n) * e
    return x.reshape(noise.shape)


# ---------------------------------------------------------------------------
# The whole request
# ---------------------------------------------------------------------------

@torch.no_grad()
def generate(W: Weights, cfg: dict, tokens: torch.Tensor, noise: torch.Tensor, resolution: int,
             seconds: float = 0.0, num_steps: int = 0, fp8: bool = False) -> torch.Tensor:
    """Pixels (B*F, 16h, 16w, 3) of the requests whose prompt ids are
    ``tokens`` (B, Lc) and whose starting latents are ``noise`` (B, L, latent_dim)."""
    with plain_math():
        grid = latent_grid(cfg, resolution, seconds)
        cond = encode(W, cfg, tokens, fp8)
        lat = ddim(W, cfg, noise, cond, num_steps or cfg["pipeline"]["num_steps"], grid, fp8)
        return decode(W, cfg, lat, grid, fp8)
