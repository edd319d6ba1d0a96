"""The transformer: the text encoder of stage E and the LLM decoder.

Counterpart of ``repro/models/transformer.py``. One ``nn.Module`` per layer,
in the order the reference executes them (``ModelConfig.plan_kinds``: scan
block by block, repeat by repeat, cycle position by cycle position), where
the reference stacks each cycle position's layers under
``params["blocks"][bi][pi]`` with a leading repeat dimension. Four modes
share the layer code, as in the reference:

  * ``run_layers``  — the encoder pass, no cache;
  * ``forward``     — the reference's cache-less pass: logits at every
                      position and the MoE layers' aux loss;
  * ``train_forward`` — the same pass for training, under autograd: the
                      reference's training math (``use_flash=False``) on
                      every device, each layer recomputed in the backward
                      under ``cfg.remat``;
  * ``prefill``     — the full prompt, filling one cache entry per layer;
  * ``decode_step`` — ONE token per sequence against the caches.

Layer kinds: ``attn_bidir:dense`` (encoder), ``attn:dense`` (causal, with a
ring KV cache), ``attn_local:dense`` (sliding window, its ring cache
``min(window, max_len)`` long), ``attn_chunked`` (llama4's chunked-local
attention: prefill runs K1 once per chunk, the ring cache is
``min(chunk, max_len)`` long and decode attends within the new token's
chunk), each with a dense or an MoE FFN (``models/moe.py``), ``qk_norm``,
``mamba2:none`` and ``rwkv6:none``. The front ends: text tokens (B, L),
musicgen's codebook tokens (B, K, L) and a vision prefix of patch
embeddings projected by ``vision_proj``. The port runs eagerly and updates
the KV ring cache in place at decode.

The layers' cache-less ``forward`` takes ``train``: attention then runs
``common.attention`` with ``make_attention_mask`` (``attention_blocked`` at
L >= ``attn_block_threshold``, L a multiple of ``attn_block_size``) and the
SSM mixers the chunked scan ``ref.chunked_linear_scan_ref``, as the
reference trains; no kernel runs, since the reference has no backward for
one.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import device as _device
from repro_torch.kernels import ops
from repro_torch.models import common, moe, ssm
from repro_torch.models.common import (ATTN, ATTN_BIDIR, ATTN_CHUNKED, ATTN_KINDS, ATTN_LOCAL,
                                       FFN_DENSE, FFN_MOE, MAMBA2, RWKV6, SSM_KINDS, ModelConfig,
                                       param)
from repro_torch.sharding import partition, spmd

FFN_NONE = "none"

# Optional partition spec of the residual stream in the training pass
# (Megatron-style sequence sharding; set by the launcher before training).
# On a mesh the stream is redistributed to it at the start of each scan
# cycle, as the reference's ``with_sharding_constraint`` on the scan carry.
_ACTIVATION_SPEC = None


def set_activation_sharding(spec) -> None:
    """The residual stream's spec in the training pass (a
    ``sharding.partition.P`` over the mesh's axes), or None."""
    global _ACTIVATION_SPEC
    _ACTIVATION_SPEC = spec


PORTED_KINDS = ((ATTN_BIDIR, FFN_DENSE), (ATTN, FFN_DENSE), (ATTN_LOCAL, FFN_DENSE),
                (ATTN, FFN_MOE), (ATTN_CHUNKED, FFN_DENSE), (ATTN_CHUNKED, FFN_MOE),
                (MAMBA2, FFN_NONE), (RWKV6, FFN_NONE))
MODALITIES = ("text", "vision", "audio_codec")


def cache_capacity(cfg: ModelConfig, mixer: str, max_len: int) -> int:
    if mixer == ATTN:
        return max_len
    if mixer == ATTN_LOCAL:
        return min(cfg.window_size, max_len)
    if mixer == ATTN_CHUNKED:
        return min(cfg.chunk_size, max_len)
    return 0


def _fill_cache_from_prefill(k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor,
                             cap: int) -> dict:
    """Write the last ``cap`` tokens of prefill K/V into a fresh ring cache."""
    b, l = k.shape[0], k.shape[1]
    take = min(cap, l)
    ks, vs = k[:, l - take:], v[:, l - take:]
    ps = positions[:, l - take:].expand(b, take)
    if take < cap:
        pad = cap - take
        return {"k": torch.cat([ks, ks.new_zeros((b, pad) + ks.shape[2:])], 1),
                "v": torch.cat([vs, vs.new_zeros((b, pad) + vs.shape[2:])], 1),
                "pos": torch.cat([ps, ps.new_full((b, pad), -1)], 1)}
    # ring layout: token at absolute position p sits in slot p % cap
    slots = (ps[0] % cap).long()
    inv = torch.zeros((cap,), dtype=torch.long, device=k.device)
    inv[slots] = torch.arange(cap, device=k.device)
    return {"k": ks[:, inv], "v": vs[:, inv], "pos": ps[:, inv]}


class AttentionLayer(nn.Module):
    """Pre-norm attention, then a pre-norm FFN: ``attn_bidir`` (the
    encoder's, plain attention), ``attn`` (causal), ``attn_local`` (causal
    within the last ``window_size`` keys) or ``attn_chunked`` (causal within
    the query's chunk of ``chunk_size`` positions); the causal kinds prefill
    through ``ops.flash_attention`` and decode against the ring cache. On
    the CPU, and in the training pass on every device, at L >=
    ``attn_block_threshold`` and L a multiple of ``attn_block_size``, every
    kind runs ``common.attention_blocked``, where the reference does; the
    training pass runs ``common.attention`` below that. The FFN is a SwiGLU
    (``dense``) or the MoE (``moe``, its weights under ``moe.``)."""

    def __init__(self, cfg: ModelConfig, mixer: str, device=None, ffn: str = FFN_DENSE):
        super().__init__()
        d, dh, dt = cfg.d_model, cfg.resolved_head_dim, cfg.dtype
        self.cfg, self.mixer, self.ffn = cfg, mixer, ffn
        self.ln1 = param((d,), torch.float32, device)
        self.wq = param((d, cfg.num_heads * dh), dt, device)
        self.wk = param((d, cfg.num_kv_heads * dh), dt, device)
        self.wv = param((d, cfg.num_kv_heads * dh), dt, device)
        self.wo = param((cfg.num_heads * dh, d), dt, device)
        if cfg.qk_norm:
            self.q_norm = param((dh,), torch.float32, device)
            self.k_norm = param((dh,), torch.float32, device)
        self.ln2 = param((d,), torch.float32, device)
        if ffn == FFN_MOE:
            self.moe = moe.MoE(cfg, device)
        else:
            self.w_gate = param((d, cfg.d_ff), dt, device)
            self.w_up = param((d, cfg.d_ff), dt, device)
            self.w_down = param((cfg.d_ff, d), dt, device)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        scale_o = 1.0 / max(1, self.cfg.num_layers) ** 0.5
        for w in (self.ln1, self.ln2) + ((self.q_norm, self.k_norm) if self.cfg.qk_norm else ()):
            w.zero_()
        for w in (self.wq, self.wk, self.wv):
            common.dense_init_(w, gen)
        common.dense_init_(self.wo, gen, scale=scale_o)
        if self.ffn == FFN_MOE:
            self.moe.init_(gen)
            return
        for w in (self.w_gate, self.w_up):
            common.dense_init_(w, gen)
        common.dense_init_(self.w_down, gen, scale=scale_o)

    def init_cache(self, batch: int, max_len: int, device=None) -> dict:
        cfg = self.cfg
        if self.mixer == ATTN_BIDIR:
            raise ValueError("encoder layers have no decode cache")
        cap = cache_capacity(cfg, self.mixer, max_len)
        shape = (batch, cap, cfg.num_kv_heads, cfg.resolved_head_dim)
        return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
                # absolute position held in each slot; -1 = empty
                "pos": torch.full((batch, cap), -1, dtype=torch.int32, device=device)}

    def _project_qkv(self, x: torch.Tensor, positions: torch.Tensor):
        cfg = self.cfg
        b, l, _ = x.shape
        dh = cfg.resolved_head_dim
        q = spmd.reshape(x @ self.wq, b, l, cfg.num_heads, dh)
        k = spmd.reshape(x @ self.wk, b, l, cfg.num_kv_heads, dh)
        v = spmd.reshape(x @ self.wv, b, l, cfg.num_kv_heads, dh)
        if cfg.qk_norm:
            q = common.rms_norm(q, self.q_norm, cfg.norm_eps)
            k = common.rms_norm(k, self.k_norm, cfg.norm_eps)
        # as in the reference, RoPE applies to the bidirectional encoder too
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
        return q, k, v

    def _ffn(self, x: torch.Tensor):
        """-> (x + FFN(x), the MoE's load-balance aux loss or 0)."""
        h = common.rms_norm(x, self.ln2, self.cfg.norm_eps)
        if self.ffn == FFN_MOE:
            out, aux = moe.moe_ffn(self.cfg, self.moe, h)
            return x + out, aux
        return x + common.swiglu(h, self.w_gate, self.w_up, self.w_down), 0.0

    def _attention(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   pos: torch.Tensor, train: bool = False) -> torch.Tensor:
        """q, k, v: (B, L, H, Dh), KV heads repeated; pos: (L,)."""
        cfg = self.cfg
        l = q.shape[1]
        if ((train or q.device.type == "cpu") and l >= cfg.attn_block_threshold
                and l % cfg.attn_block_size == 0):
            return common.attention_blocked(q, k, v, pos, pos, self.mixer, cfg.window_size,
                                            cfg.chunk_size, cfg.attn_softcap,
                                            cfg.attn_block_size)
        if train or self.mixer == ATTN_BIDIR:
            mask = common.make_attention_mask(pos, pos, self.mixer, cfg.window_size,
                                              cfg.chunk_size)
            return common.attention(q, k, v, mask, cfg.attn_softcap)
        if self.mixer == ATTN_CHUNKED and l > cfg.chunk_size:
            # within a chunk the mask is causal and no key crosses a chunk
            # edge: one causal K1 call per chunk, on views along L
            c = cfg.chunk_size
            return torch.cat([ops.flash_attention(q[:, j:j + c], k[:, j:j + c], v[:, j:j + c],
                                                  causal=True, softcap=cfg.attn_softcap)
                              for j in range(0, l, c)], dim=1)
        window = cfg.window_size if self.mixer == ATTN_LOCAL else 0
        return ops.flash_attention(q, k, v, causal=True, window=window, softcap=cfg.attn_softcap)

    def _attend(self, x: torch.Tensor, positions: torch.Tensor, train: bool = False):
        """Attention over the in-flight sequence only -> (x + out, (k, v))."""
        cfg = self.cfg
        b, l, _ = x.shape
        h = common.rms_norm(x, self.ln1, cfg.norm_eps)
        q, k, v = self._project_qkv(h, positions)
        n_rep = cfg.num_heads // cfg.num_kv_heads
        kr, vr = common.repeat_kv(k, n_rep), common.repeat_kv(v, n_rep)
        pos = positions[0]
        # on a mesh the core runs on each rank's shard of the batch and the
        # heads (it treats each on its own): DTensor's strategy search for
        # the f32 scores' products and masked softmax costs seconds a shape.
        # The heads merge inside, so no DTensor view splits them again in
        # the backward
        out = spmd.local(lambda q_, k_, v_: self._attention(q_, k_, v_, pos, train).flatten(2),
                         q, kr, vr, keep=(0, 2))
        return x + out @ self.wo, (k, v)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, train: bool = False):
        """The cache-less pass -> (x, aux); ``train``: the training pass's
        attention."""
        return self._ffn(self._attend(x, positions, train)[0])

    def prefill(self, x: torch.Tensor, positions: torch.Tensor, cache: dict):
        x, (k, v) = self._attend(x, positions)
        return self._ffn(x)[0], _fill_cache_from_prefill(k, v, positions, cache["k"].shape[1])

    def decode(self, x: torch.Tensor, offset: int, cache: dict):
        """One token against the ring cache; ``offset`` = tokens already
        processed (the new token's position). Writes the cache in place."""
        cfg = self.cfg
        b, l, _ = x.shape  # l == 1
        h = common.rms_norm(x, self.ln1, cfg.norm_eps)
        positions = torch.full((b, l), offset, dtype=torch.int32, device=x.device)
        q, k_new, v_new = self._project_qkv(h, positions)
        k, v, pos = cache["k"], cache["v"], cache["pos"]
        slot = offset % k.shape[1]
        k[:, slot] = k_new[:, 0].to(k.dtype)
        v[:, slot] = v_new[:, 0].to(v.dtype)
        pos[:, slot].fill_(offset)
        valid = (pos >= 0) & (pos <= offset)
        if self.mixer == ATTN_LOCAL:
            valid &= pos > offset - cfg.window_size
        elif self.mixer == ATTN_CHUNKED:
            valid &= pos // cfg.chunk_size == offset // cfg.chunk_size
        n_rep = cfg.num_heads // cfg.num_kv_heads
        kr, vr = common.repeat_kv(k, n_rep), common.repeat_kv(v, n_rep)
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) / math.sqrt(q.shape[-1])
        scores = common.softcap(scores, cfg.attn_softcap)
        scores = scores.masked_fill(~valid[:, None, None, :], -1e30)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.to(vr.dtype), vr)
        out = out.reshape(b, l, cfg.num_heads * cfg.resolved_head_dim)
        return self._ffn(x + out @ self.wo)[0], {"k": k, "v": v, "pos": pos}


class Mamba2Layer(nn.Module):
    """``mamba2:none``: pre-norm Mamba2, no FFN."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = param((cfg.d_model,), torch.float32, device)
        self.mamba = ssm.Mamba2(cfg, device)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        self.ln1.zero_()
        self.mamba.init_(gen)

    def init_cache(self, batch: int, max_len: int, device=None) -> dict:
        return self.mamba.init_state(batch, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, train: bool = False):
        """The cache-less pass from a zero state -> (x, 0); ``train``: the
        training pass's scan."""
        out, _ = self.mamba(common.rms_norm(x, self.ln1, self.cfg.norm_eps), train=train)
        return x + out, 0.0

    def prefill(self, x: torch.Tensor, positions: torch.Tensor, cache: dict):
        out, new = self.mamba(common.rms_norm(x, self.ln1, self.cfg.norm_eps), cache)
        return x + out, new

    def decode(self, x: torch.Tensor, offset: int, cache: dict):
        out, new = self.mamba.decode(common.rms_norm(x, self.ln1, self.cfg.norm_eps), cache)
        return x + out, new


class RWKV6Layer(nn.Module):
    """``rwkv6:none``: pre-norm time-mix, then pre-norm channel-mix (its own FFN)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = param((cfg.d_model,), torch.float32, device)
        self.ln2 = param((cfg.d_model,), torch.float32, device)
        self.rwkv = ssm.RWKV6(cfg, device)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        self.ln1.zero_()
        self.ln2.zero_()
        self.rwkv.init_(gen)

    def init_cache(self, batch: int, max_len: int, device=None) -> dict:
        return self.rwkv.init_state(batch, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, train: bool = False):
        """The cache-less pass from a zero state -> (x, 0); ``train``: the
        training pass's scan (its zero state made there)."""
        state = None if train else self.init_cache(x.shape[0], 0, x.device)
        return self._run(x, state, False, train)[0], 0.0

    def _run(self, x: torch.Tensor, state: dict, decode: bool, train: bool = False):
        eps = self.cfg.norm_eps
        out, s_new, shift_tm = self.rwkv.timemix(common.rms_norm(x, self.ln1, eps), state, decode,
                                                 train)
        x = x + out
        out2, shift_cm = self.rwkv.channelmix(common.rms_norm(x, self.ln2, eps), state)
        dt = self.cfg.dtype
        return x + out2, {"ssm": s_new, "shift_tm": shift_tm.to(dt), "shift_cm": shift_cm.to(dt)}

    def prefill(self, x: torch.Tensor, positions: torch.Tensor, cache: dict):
        return self._run(x, cache, decode=False)

    def decode(self, x: torch.Tensor, offset: int, cache: dict):
        return self._run(x, cache, decode=True)


def _make_layer(cfg: ModelConfig, kind: Tuple[str, str], device) -> nn.Module:
    mixer = kind[0]
    if mixer not in ATTN_KINDS + SSM_KINDS:
        raise ValueError(f"unknown mixer {mixer!r}")
    if kind not in PORTED_KINDS:
        raise NotImplementedError(f"layer kind {kind} is in no config of the zoo")
    if mixer == MAMBA2:
        return Mamba2Layer(cfg, device)
    if mixer == RWKV6:
        return RWKV6Layer(cfg, device)
    return AttentionLayer(cfg, mixer, device, ffn=kind[1])


class Transformer(nn.Module):
    """Token embedding, the layers in execution order, the final norm and
    the LM head; a vision model's ``vision_proj`` (patch embeddings into the
    model), an audio model's per-codebook ``codebook_embed`` and
    ``codebook_head``. The encoder never reads ``lm_head``, nor the audio
    model ``embed`` and ``lm_head``; they are kept because the profiler
    counts them, as the reference's does."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.modality not in MODALITIES:
            raise ValueError(f"unknown modality {cfg.modality!r}")
        self.cfg = cfg
        d, dt = cfg.d_model, cfg.dtype
        self.embed = param((cfg.vocab_size, d), dt, device)
        self.final_norm = param((d,), torch.float32, device)
        if not cfg.tie_embeddings:
            self.lm_head = param((d, cfg.vocab_size), dt, device)
        if cfg.modality == "vision":
            self.vision_proj = param((cfg.vision_embed_dim, d), dt, device)
        if cfg.modality == "audio_codec":
            self.codebook_embed = param((cfg.num_codebooks, cfg.vocab_size, d), dt, device)
            self.codebook_head = param((cfg.num_codebooks, d, cfg.vocab_size), dt, device)
        self.layers = nn.ModuleList(_make_layer(cfg, kind, device) for kind in cfg.plan_kinds())

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        common.embed_init_(self.embed, gen)
        self.final_norm.zero_()
        if not self.cfg.tie_embeddings:
            common.dense_init_(self.lm_head, gen)
        if self.cfg.modality == "vision":
            common.dense_init_(self.vision_proj, gen)
        if self.cfg.modality == "audio_codec":
            common.embed_init_(self.codebook_embed, gen)
            common.dense_init_(self.codebook_head, gen)
        for layer in self.layers:
            layer.init_(gen)

    def embed_tokens(self, tokens: torch.Tensor,
                     prefix_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens: (B, L) integer, or (B, K, L) codebook tokens for
        ``audio_codec`` (their K embeddings summed per frame) -> (B, L, D).
        ``prefix_embeds`` (B, Tv, Dv): stub patch embeddings, projected by
        ``vision_proj`` in the model's dtype and put in front of the text."""
        cfg = self.cfg
        # on a mesh the vocab-sharded table is gathered whole for the lookup:
        # DTensor's lookup leaves a masked pending sum whose backward it
        # cannot redistribute
        if cfg.modality == "audio_codec" and tokens.dim() == 3:
            x = spmd.local(lambda t, cb: torch.stack([F.embedding(t[:, i], cb[i])
                                                      for i in range(t.shape[1])], dim=1).sum(1),
                           tokens, self.codebook_embed, shared=(1,))
        else:
            x = spmd.local(F.embedding, tokens, self.embed, shared=(1,))
        if cfg.embed_scale:
            x = x * (cfg.d_model ** 0.5)
        if prefix_embeds is not None:
            pe = prefix_embeds.to(cfg.dtype)
            if hasattr(self, "vision_proj"):
                pe = pe @ self.vision_proj
            x = torch.cat([pe, x], dim=1)
        return x

    def _positions(self, x: torch.Tensor) -> torch.Tensor:
        b, l, _ = x.shape
        return torch.arange(l, dtype=torch.int32, device=x.device)[None].expand(b, l)

    def run_layers(self, x: torch.Tensor) -> torch.Tensor:
        """The cache-less pass over every layer, positions 0..L-1."""
        positions = self._positions(x)
        for layer in self.layers:
            x = layer(x, positions)[0]
        return x

    def apply_final_norm(self, x: torch.Tensor) -> torch.Tensor:
        return common.rms_norm(x, self.final_norm, self.cfg.norm_eps)

    def lm_logits(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L, V) f32 logits, or (B, L, K, V) through ``codebook_head``."""
        x = self.apply_final_norm(x)
        if self.cfg.modality == "audio_codec":
            logits = torch.einsum("bld,kdv->blkv", x, self.codebook_head)
        else:
            logits = x @ (self.embed.T if self.cfg.tie_embeddings else self.lm_head)
        return common.softcap(logits.float(), self.cfg.logit_softcap)

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, prefix_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The reference's cache-less pass: (logits at every position, the
        MoE layers' summed load-balance aux loss, f32)."""
        return self._cacheless(tokens, prefix_embeds, train=False)

    def train_forward(self, tokens: torch.Tensor, prefix_embeds: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The reference's training pass (``forward`` in its ``"train"``
        mode), under autograd: the same (logits, aux) as ``forward``, with
        the training pass's attention and scan on every device, and each
        layer run under ``torch.utils.checkpoint`` when ``cfg.remat``."""
        return self._cacheless(tokens, prefix_embeds, train=True)

    def cycle_starts(self) -> frozenset:
        """The indices of the layers that begin a repeat of their scan-plan
        block's cycle (the reference's scan body)."""
        starts, i = set(), 0
        for cycle, repeat in self.cfg.scan_plan():
            for _ in range(repeat):
                starts.add(i)
                i += len(cycle)
        return frozenset(starts)

    def _cacheless(self, tokens, prefix_embeds, train: bool):
        x = self.embed_tokens(tokens, prefix_embeds)
        positions = self._positions(x)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        starts = self.cycle_starts() if train and _ACTIVATION_SPEC is not None else ()
        for i, layer in enumerate(self.layers):
            if i in starts and spmd.is_dtensor(x):
                x = x.redistribute(x.device_mesh,
                                   partition.placements(_ACTIVATION_SPEC, x.device_mesh))
            if train and self.cfg.remat:
                x, a = checkpoint(layer, x, positions, train=True, use_reentrant=False)
            else:
                x, a = layer(x, positions, train=train)
            aux = aux + a
        return self.lm_logits(x), aux

    def init_cache(self, batch: int, max_len: int) -> List[dict]:
        """One cache entry per layer, in execution order."""
        dev = self.embed.device
        return [layer.init_cache(batch, max_len, dev) for layer in self.layers]

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: int,
                prefix_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, List[dict], int]:
        """Returns (last-token logits (B, 1, V) [(B, 1, K, V) audio] f32,
        caches, offset = prefix + prompt length). Caches are sized for
        ``max_len``."""
        x = self.embed_tokens(tokens, prefix_embeds)
        b, l, _ = x.shape
        positions = self._positions(x)
        caches = []
        for layer, cache in zip(self.layers, self.init_cache(b, max_len)):
            x, cache = layer.prefill(x, positions, cache)
            caches.append(cache)
        return self.lm_logits(x[:, -1:, :]), caches, l

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, caches: List[dict], offset: int
                    ) -> Tuple[torch.Tensor, List[dict]]:
        """ONE new token per sequence, tokens (B, 1) [(B, K, 1) audio],
        against the caches."""
        x = self.embed_tokens(tokens)
        new = []
        for layer, cache in zip(self.layers, caches):
            x, cache = layer.decode(x, offset, cache)
            new.append(cache)
        return self.lm_logits(x), new


def build(cfg: ModelConfig, device=None, seed: int = 0) -> Transformer:
    """The model on ``device`` (``cuda`` by default) with weights drawn from
    ``seed`` on that device."""
    dev = _device.resolve(device)
    model = Transformer(cfg, dev)
    model.init_(_device.generator(dev, seed))
    return model.eval()
