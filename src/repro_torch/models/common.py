"""Shared building blocks: config, init, norms, RoPE, attention math, MLPs.

Counterpart of ``repro/models/common.py``, holding only what the ported
slice uses. Weight matrices keep the reference's ``(d_in, d_out)`` layout,
so a layer is ``x @ w`` and weights carry over without a transpose.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

# mixer kinds
ATTN = "attn"                # full causal attention
ATTN_LOCAL = "attn_local"    # sliding-window causal attention
ATTN_CHUNKED = "attn_chunked"  # chunked local attention (llama4 iRoPE)
ATTN_BIDIR = "attn_bidir"    # bidirectional (encoder)
MAMBA2 = "mamba2"
RWKV6 = "rwkv6"

# ffn kinds
FFN_DENSE = "dense"
FFN_MOE = "moe"

ATTN_KINDS = (ATTN, ATTN_LOCAL, ATTN_CHUNKED, ATTN_BIDIR)
SSM_KINDS = (MAMBA2, RWKV6)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The transformer config, with the fields the ported slices read.

    ``layer_pattern`` is a cycle of ``"<mixer>:<ffn>"`` entries tiled to
    ``num_layers``.
    """

    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    layer_pattern: Tuple[str, ...] = ("attn:dense",)

    # attention details
    window_size: int = 4096          # for attn_local
    chunk_size: int = 8192           # for attn_chunked
    logit_softcap: float = 0.0       # final-logit softcap (gemma2: 30)
    attn_softcap: float = 0.0        # attention-score softcap (gemma2: 50)
    rope_theta: float = 10000.0
    qk_norm: bool = False

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # SSM (mamba2 / rwkv6)
    ssm_state_dim: int = 64
    ssm_heads: int = 0               # 0 -> num_heads
    ssm_expand: int = 2
    ssm_conv: int = 4

    # modality front ends (stubs, as in the reference)
    modality: str = "text"           # text | vision | audio_codec
    num_codebooks: int = 0           # musicgen
    vision_tokens: int = 0           # number of prefix embedding tokens
    vision_embed_dim: int = 0

    # numerics
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    tie_embeddings: bool = False
    final_norm: bool = True          # False: an encoder hands on its last layer's states
    embed_scale: bool = False        # multiply embeddings by sqrt(d_model) (gemma)
    remat: bool = True               # recompute each layer in the training pass's backward
    attn_block_threshold: int = 4096  # CPU prefill, training: online-softmax blocked attention
    attn_block_size: int = 512        # ... with this KV block size
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def resolved_ssm_heads(self) -> int:
        return self.ssm_heads or self.num_heads

    def layer_kinds(self) -> Tuple[Tuple[str, str], ...]:
        """Tile layer_pattern to num_layers -> ((mixer, ffn), ...)."""
        out = []
        for i in range(self.num_layers):
            entry = self.layer_pattern[i % len(self.layer_pattern)]
            mixer, _, ffn = entry.partition(":")
            out.append((mixer, ffn or FFN_DENSE))
        return tuple(out)

    def scan_plan(self) -> Tuple[Tuple[Tuple[Tuple[str, str], ...], int], ...]:
        """Blocks of (pattern_cycle, repeat), as the reference stacks its
        parameters: a cycling pattern repeated at least twice is one block
        (the whole cycle per repeat), then the remaining layers merge into
        homogeneous runs. The layers execute block by block, repeat by
        repeat, cycle position by cycle position."""
        kinds = self.layer_kinds()
        p = len(self.layer_pattern)
        n = self.num_layers
        blocks = []
        if p > 1 and n // p >= 2:
            g = n // p
            blocks.append((tuple(kinds[:p]), g))
            rest = kinds[g * p:]
        else:
            rest = kinds
        runs = []
        for k in rest:
            if runs and runs[-1][0] == k:
                runs[-1][1] += 1
            else:
                runs.append([k, 1])
        for k, c in runs:
            blocks.append(((k,), c))
        return tuple(blocks)

    def plan_kinds(self) -> Tuple[Tuple[str, str], ...]:
        """Every layer's kind in execution (scan-plan) order."""
        return tuple(kind for cycle, repeat in self.scan_plan()
                     for _ in range(repeat) for kind in cycle)

    def is_subquadratic(self) -> bool:
        """True when no layer needs an unbounded full-attention KV cache."""
        return all(m not in (ATTN, ATTN_BIDIR) for m, _ in self.layer_kinds())

    def supports_long_context(self) -> bool:
        """long_500k eligibility: every layer either SSM or windowed/chunked,
        or the architecture natively mixes bounded-local with (rare) global
        layers (gemma2, llama4). Pure full-attention stacks return False."""
        kinds = [m for m, _ in self.layer_kinds()]
        n_full = sum(1 for m in kinds if m == ATTN)
        n_bounded = sum(1 for m in kinds if m in (ATTN_LOCAL, ATTN_CHUNKED) or m in SSM_KINDS)
        if n_full == 0:
            return True
        # native local/global alternation: at most half the layers global
        return n_bounded > 0 and n_full <= len(kinds) // 2


# ---------------------------------------------------------------------------
# Parameters and their seeded init
# ---------------------------------------------------------------------------

def param(shape: Sequence[int], dtype, device) -> torch.nn.Parameter:
    """An uninitialised, frozen parameter: serving models stay frozen, and
    the trainer (``training/loop.init_state``) turns gradients on for its
    own model."""
    return torch.nn.Parameter(torch.empty(tuple(shape), dtype=dtype, device=device),
                              requires_grad=False)


DRAW_SLICE_ELEMENTS = 2 ** 30   # a larger tensor is drawn in slices along dim 0


@torch.no_grad()
def dense_init_(w: torch.Tensor, gen: torch.Generator, scale: float = 1.0,
                fan_in: Optional[int] = None) -> None:
    """Truncated-normal fan-in init in place; fan_in defaults to shape[0]
    (the reference's rule, which for an HWIO kernel is its height). A
    tensor of more than DRAW_SLICE_ELEMENTS elements (llama4's expert
    stacks) is drawn in slices along dim 0, each through one float32
    buffer of at most that many elements; fan_in stays the whole tensor's."""
    fan = w.shape[0] if fan_in is None else fan_in
    std = scale / math.sqrt(max(1, fan))
    if w.numel() <= DRAW_SLICE_ELEMENTS:
        t = torch.empty(w.shape, dtype=torch.float32, device=w.device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        w.copy_(t.mul_(std))
        return
    rows = max(1, DRAW_SLICE_ELEMENTS // (w.numel() // w.shape[0]))
    for i in range(0, w.shape[0], rows):
        part = w[i:i + rows]
        t = torch.empty(part.shape, dtype=torch.float32, device=w.device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        part.copy_(t.mul_(std))


@torch.no_grad()
def embed_init_(w: torch.Tensor, gen: torch.Generator) -> None:
    t = torch.randn(w.shape, dtype=torch.float32, device=w.device, generator=gen)
    w.copy_(t.mul_(0.02))


# ---------------------------------------------------------------------------
# Norms and RoPE
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * weight.float() + bias.float()).to(dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap) if cap > 0 else x


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., L, H, Dh); positions: broadcastable to (..., L). Split halves."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # (Dh/2,)
    angles = positions[..., None].float() * freqs               # (..., L, Dh/2)
    angles = angles[..., None, :]                               # (..., L, 1, Dh/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention math (plain path; the DiT's attention goes through kernels.ops)
# ---------------------------------------------------------------------------

def make_attention_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, kind: str,
                        window: int = 0, chunk: int = 0) -> torch.Tensor:
    """(Lq, Lkv) boolean mask; True = attend."""
    q = q_pos[:, None]
    k = kv_pos[None, :]
    if kind == ATTN_BIDIR:
        return torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                          device=q_pos.device)
    causal = k <= q
    if kind == ATTN:
        return causal
    if kind == ATTN_LOCAL:
        return causal & (k > q - window)
    if kind == ATTN_CHUNKED:
        return causal & (k // chunk == q // chunk)
    raise ValueError(f"unknown attention kind {kind!r}")


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, L, Hkv, Dh) -> (B, L, Hkv*n_rep, Dh)."""
    if n_rep == 1:
        return x
    b, l, h, d = x.shape
    return x[:, :, :, None, :].expand(b, l, h, n_rep, d).reshape(b, l, h * n_rep, d)


def _block_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, kind: str, window: int,
                chunk: int) -> Optional[torch.Tensor]:
    if kind == ATTN_BIDIR:
        return None
    q = q_pos[:, None]
    k = k_pos[None, :]
    m = k <= q
    if kind == ATTN_LOCAL:
        m &= k > q - window
    elif kind == ATTN_CHUNKED:
        m &= (k // chunk) == (q // chunk)
    return m


def attention_blocked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_pos: torch.Tensor,
                      kv_pos: torch.Tensor, kind: str, window: int = 0, chunk: int = 0,
                      attn_softcap_val: float = 0.0, block: int = 512) -> torch.Tensor:
    """Online-softmax attention over blocks of ``block`` keys, in f32: never
    builds the (Lq, Lkv) scores. The reference's CPU prefill at long L; the
    port's prefill on the card goes through K1 instead."""
    b, lq, h, d = q.shape
    lkv = k.shape[1]
    assert lkv % block == 0, (lkv, block)
    scale = 1.0 / math.sqrt(d)
    qf = q.float()
    m = torch.full((b, h, lq), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, lq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, lq, d), dtype=torch.float32, device=q.device)
    for j in range(0, lkv, block):
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k[:, j:j + block].float()) * scale
        s = softcap(s, attn_softcap_val)
        mask = _block_mask(q_pos, kv_pos[j:j + block], kind, window, chunk)
        if mask is not None:
            s = torch.where(mask[None, None], s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                    v[:, j:j + block].float())
        m = m_new
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l[..., None]).transpose(1, 2).to(v.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor],
              attn_softcap_val: float = 0.0) -> torch.Tensor:
    """q: (B, Lq, H, Dh); k/v: (B, Lkv, H, Dh); mask: (Lq, Lkv) or None.

    Scores and softmax in f32; probabilities rounded to v's dtype for PV."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if attn_softcap_val > 0:
        scores = attn_softcap_val * torch.tanh(scores / attn_softcap_val)
    if mask is not None:
        scores = scores.masked_fill(~mask[None, None], -1e30)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    return (F.silu(g.float()).to(x.dtype) * u) @ w_down


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    h = F.gelu((x @ w_up).float(), approximate="tanh")
    return h.to(x.dtype) @ w_down
