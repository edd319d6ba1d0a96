"""Operations, bytes and peaks: the benchmark's frozen yardstick.

Peaks of one NVIDIA H100 SXM (data sheet, dense): 989e12 FLOP/s in bf16 on
the tensor cores, 3.35e12 B/s of HBM3. A kernel's bound is the larger of
its operations at the peak and its bytes at the bandwidth, each input read
once and each output written once.

K1 is the served attention kernel (non-causal here): 4 operations per
query-key pair and head dimension (the two products), q, k, v and o moved
once. Model FLOPs are 2 per weight and row for every matrix product, plus
4 * Lq * Lk * (heads * head dim) for the two attention products, per layer.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BF16_BYTES = 2


def k1_cost(batch: int, lq: int, lk: int, heads: int, head_dim: int) -> tuple:
    """(operations, bytes) of one non-causal K1 call on bf16 tensors."""
    flops = 4.0 * lq * lk * batch * heads * head_dim
    nbytes = BF16_BYTES * (2 * batch * lq * heads * head_dim + 2 * batch * lk * heads * head_dim)
    return flops, nbytes


def bound_s(flops: float, nbytes: float) -> float:
    """The least time on the card: operations at the bf16 peak or bytes at HBM bandwidth."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def dit_step_flops(dit: dict, latent_tokens: int, cond_tokens: int, batch: int = 1) -> float:
    """Model FLOPs of one DiT evaluation on ``batch`` requests: the joint
    stream of cond + latent tokens through every layer, the input and
    output projections on their own tokens, and the timestep and
    modulation products on one row a request."""
    d, ff, n = dit["d_model"], dit["d_ff"], dit["num_layers"]
    l = latent_tokens + cond_tokens
    per_layer = 2.0 * (4 * d * d + 2 * d * ff) * l + 4.0 * l * l * d
    rows = (2.0 * dit["latent_dim"] * d * latent_tokens * 2      # x_in and x_out
            + 2.0 * dit["cond_dim"] * d * cond_tokens
            + 2.0 * (dit["time_embed_dim"] * d + d * d + n * 6 * d * d + 2 * d * d))
    return batch * (n * per_layer + rows)


def encoder_flops(enc: dict, cond_tokens: int, batch: int = 1) -> float:
    """Model FLOPs of the text encoder on ``batch`` prompts of ``cond_tokens``."""
    d, ff, n = enc["d_model"], enc["d_ff"], enc["num_layers"]
    dh = enc["head_dim"] or d // enc["num_heads"]
    hq, hkv = enc["num_heads"] * dh, enc["num_kv_heads"] * dh
    l = cond_tokens
    per_layer = 2.0 * (d * hq + 2 * d * hkv + hq * d + 3 * d * ff) * l + 4.0 * l * l * hq
    return batch * n * per_layer


def request_flops(cfg: dict, latent_tokens: int, cond_tokens: int, steps: int,
                  batch: int = 1) -> float:
    """Encode once and ``steps`` DiT evaluations: the model FLOPs that
    ``mfu_pct`` counts for a launch (the decoder's convolutions are left out)."""
    return (encoder_flops(cfg["encoder"], cond_tokens, batch)
            + steps * dit_step_flops(cfg["dit"], latent_tokens, cond_tokens, batch))
