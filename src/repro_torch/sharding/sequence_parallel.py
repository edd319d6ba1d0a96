"""Ulysses sequence parallelism over ``torch.distributed`` (the paper's SP
mechanism), and the chunk-parallel scan for the attention-free layers.

Counterpart of ``repro/sharding/sequence_parallel.py``, where both are
``shard_map`` bodies. Here each rank calls them on its own shard, and
the collectives run over the process group of one mesh axis.

DeepSpeed-Ulysses [arXiv:2309.14509]: activations enter sharded on the
*sequence* dim; an all-to-all re-shards them on the *head* dim for the
attention core (each rank holds H/n full-length heads), and a second
all-to-all restores sequence sharding. This is the φ_s = "ulysses"
parallel config a dispatch plan requests. The attention core is
``kernels.ops.flash_attention``: K1 on a CUDA tensor, the plain version on
the CPU.

For the attention-free SSM architectures (rwkv6, mamba2) Ulysses is
inapplicable; ``scan_chunk_parallel`` is the substitute: ranks hold
sequence chunks, scan them with ``kernels.ops.linear_scan`` (K3 on the
card) and chain the recurrent states. The reference chains them with n - 1
``ppermute`` rounds; here one ``all_gather_into_tensor`` of every rank's
(chunk state, chunk decay) lets each rank run the same recurrence in rank
order, the same arithmetic in the same order. Gloo carries that gather on
CUDA tensors too, where it has no CUDA send/recv.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels import ops


def _group(mesh, axis: str):
    """The process group of ``axis`` on ``mesh`` (a ``DeviceMesh``) and its size."""
    group = mesh.get_group(axis)
    return group, dist.get_world_size(group)


def shard_sequence(x: torch.Tensor, mesh, axis: str = "model", dim: int = 1) -> torch.Tensor:
    """This rank's shard of the full ``x`` along ``dim`` over ``axis``.
    Raises when the length does not divide, as ``shard_map`` would."""
    group, n = _group(mesh, axis)
    if x.shape[dim] % n:
        raise ValueError(f"sequence {x.shape[dim]} does not divide over {n} ranks")
    return x.chunk(n, dim)[dist.get_rank(group)]


def _all_gather(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """Every rank's ``x``, stacked in rank order: (n, *x.shape)."""
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out.view((n,) + tuple(x.shape))


def gather_sequence(x: torch.Tensor, mesh, axis: str = "model", dim: int = 1) -> torch.Tensor:
    """The full tensor from every rank's equal shard along ``dim``."""
    group, n = _group(mesh, axis)
    return torch.cat(_all_gather(x, group, n).unbind(0), dim)


def _equal_lengths(length: int, device, group, n: int) -> None:
    lengths = _all_gather(torch.tensor([length], device=device), group, n)
    if len(set(lengths.flatten().tolist())) != 1:
        raise ValueError(f"sequence shards of lengths {lengths.flatten().tolist()}: the length does not "
                         "divide over the ranks")


def _seq_to_heads(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """(B, L/n, H, D) -> all-to-all -> (B, L, H/n, D): rank j gets head
    chunk j of every rank's sequence shard, concatenated in rank order
    (the reference's ``all_to_all(split_axis=2, concat_axis=1, tiled)``)."""
    b, ls, h, d = x.shape
    send = x.reshape(b, ls, n, h // n, d).permute(2, 0, 1, 3, 4).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.permute(1, 0, 2, 3, 4).reshape(b, n * ls, h // n, d)


def _heads_to_seq(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """(B, L, H/n, D) -> all-to-all -> (B, L/n, H, D), the inverse."""
    b, l, hn, d = x.shape
    send = x.reshape(b, n, l // n, hn, d).permute(1, 0, 2, 3, 4).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.permute(1, 2, 0, 3, 4).reshape(b, l // n, n * hn, d)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                      axis: str = "model", causal: bool = False,
                      softcap: float = 0.0) -> torch.Tensor:
    """q/k/v: this rank's (B, L/n, H, D) sequence shard over ``axis`` (GQA
    expanded); H % n == 0. Returns the attention output's (B, L/n, H, D)
    shard. Raises when the shards differ in length (L % n != 0)."""
    group, n = _group(mesh, axis)
    assert q.shape[2] % n == 0, f"heads {q.shape[2]} % {n} != 0"
    if n == 1:
        return ops.flash_attention(q, k, v, causal=causal, softcap=softcap)
    _equal_lengths(q.shape[1], q.device, group, n)
    qh, kh, vh = (_seq_to_heads(t, group, n) for t in (q, k, v))
    out = ops.flash_attention(qh, kh, vh, causal=causal, softcap=softcap)
    return _heads_to_seq(out, group, n)


def _ladder(every: torch.Tensor, rank: int) -> torch.Tensor:
    """The state entering rank ``rank``'s chunk from every rank's gathered
    (S, dtot) (n, B, H, K, V + 1): prefix_i = dtot_{i-1} * prefix_{i-1} +
    S_{i-1}, in rank order from prefix_0 = 0."""
    carry = torch.zeros_like(every[0, ..., :-1])
    for i in range(rank):
        s_i, dtot_i = every[i, ..., :-1], every[i, ..., -1]
        carry = dtot_i[..., None] * carry + s_i
    return carry


def scan_chunk_parallel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        decay: torch.Tensor, mesh, axis: str = "model",
                        bonus: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequence-chunk parallel gated linear scan (SSM SP substitute).

    q/k/decay (B, H, L/n, K), v (B, H, L/n, V): this rank's chunk. Each rank
    scans its chunk from a zero state, then the states are chained: rank i
    starts from prefix_i = dtot_{i-1} * prefix_{i-1} + S_{i-1} (prefix_0 =
    0, dtot a chunk's total decay) and scans its chunk again from there.
    Returns (this rank's output chunk, the last rank's final state, on
    every rank)."""
    group, n = _group(mesh, axis)
    rank = dist.get_rank(group)
    _, s_local = ops.linear_scan(q, k, v, decay, bonus=bonus)
    # total decay of the local chunk per (B, H, K)
    dtot = torch.exp(torch.sum(torch.log(torch.clamp(decay.float(), min=1e-30)), dim=2))
    # every rank's (S, dtot), then the ladder in rank order
    every = _all_gather(torch.cat([s_local, dtot[..., None]], -1), group, n)
    carry = _ladder(every, rank)
    # redo the local scan seeded with the exact prefix state
    out, s_final = ops.linear_scan(q, k, v, decay, bonus=bonus, initial_state=carry)
    return out, _all_gather(s_final, group, n)[-1]
