"""The three-term roofline of a counted step, and the port's bounds.

Counterpart of ``repro/roofline/analysis.py``. Per device:

  compute    = flops      / peak FLOP/s
  memory     = HBM bytes  / HBM bytes/s
  collective = wire bytes / link bytes/s

from ``counts.ModuleCosts``, priced on a ``core.profiler.Hardware``
(``H100_SXM`` by default; ``REFERENCE_HW`` carries the reference's 197e12,
819e9 and 50e9, under which the three terms are the reference's for the
same counts). A collective group that lies inside one block of
``link_domain_chips`` consecutive ranks (one node's NVLink domain) is
priced at ``link_bw``, a wider one at ``inter_node_bw``, as ``Profiler``
prices an SP group; on the 16x16 mesh both axes cross a node of 8.

The bounds below are the least times ``chip_smoke.py`` prints beside its
measurements: a kernel call's (its module's ``cost`` at its ``PEAK``), a
decode step's, a prefill group's and a train step's, and a trainer's
reckoned memory. They are priced on the H100 SXM data sheet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.core.profiler import H100_SXM, Hardware

# published H100 SXM peaks (NVIDIA data sheet)
PEAK_BF16_TENSOR = H100_SXM.peak_flops     # FLOP/s, dense
PEAK_F32 = 67e12                           # FLOP/s, outside the tensor cores
PEAK_HBM = H100_SXM.hbm_bw                 # bytes/s
# the peak each kernel module's ``PEAK`` names
PEAKS = {"bf16_tensor": PEAK_BF16_TENSOR, "f32": PEAK_F32}


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    wire_bytes: Dict[str, float]

    @property
    def total_bytes(self) -> float:
        return sum(self.wire_bytes.values())


def collective_stats(mc) -> CollectiveStats:
    """A counted step's collectives (``parse_collectives``' role: the port
    reads them from the counter, not from HLO text)."""
    return CollectiveStats(dict(mc.collective_counts), {"total": mc.collective_wire_bytes})


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float          # per-device
    hlo_bytes: float          # per-device
    coll_bytes: float         # per-device wire bytes
    model_flops: float        # 6*N*D useful flops (global)
    coll_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    peak_mem_bytes: float = 0.0
    coll_bytes_wide: float = 0.0  # of coll_bytes, those of groups wider than a link domain
    hw: Hardware = H100_SXM

    @classmethod
    def from_costs(cls, arch: str, shape: str, mesh: str, chips: int, mc, model_flops: float,
                   hw: Hardware = H100_SXM) -> "Roofline":
        """The roofline of one device's counts ``mc`` (``counts.ModuleCosts``)."""
        return cls(arch=arch, shape=shape, mesh=mesh, chips=chips, hlo_flops=mc.flops,
                   hlo_bytes=mc.hbm_bytes, coll_bytes=mc.collective_wire_bytes,
                   model_flops=model_flops, coll_counts=dict(mc.collective_counts),
                   peak_mem_bytes=mc.peak_bytes,
                   coll_bytes_wide=mc.wide_wire_bytes(hw.link_domain_chips), hw=hw)

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / self.hw.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / self.hw.hbm_bw

    @property
    def t_collective(self) -> float:
        inside = self.coll_bytes - self.coll_bytes_wide
        return inside / self.hw.link_bw + self.coll_bytes_wide / self.hw.inter_node_bw

    @property
    def t_bound(self) -> float:
        """The step's least time: the largest of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    def row(self) -> str:
        return (f"{self.arch:26s} {self.shape:12s} {self.mesh:9s} "
                f"compute={self.t_compute * 1e3:9.2f}ms "
                f"memory={self.t_memory * 1e3:9.2f}ms "
                f"coll={self.t_collective * 1e3:9.2f}ms "
                f"-> {self.bottleneck:10s} useful={self.useful_ratio:6.3f}")


def _meta_model(cfg):
    from repro_torch.models import transformer
    return transformer.Transformer(cfg, "meta")


def model_flops(cfg, kind: str, batch: int, seq_len: int) -> float:
    """6*N*D for training, 2*N_active*D for inference (per step), N counted
    on a ``meta`` model, an MoE's routed experts scaled by k/E."""
    model = _meta_model(cfg)
    n_total = sum(p.numel() for p in model.parameters())
    n_active = n_total
    if cfg.num_experts:
        expert_n = sum(p.numel() for name, p in model.named_parameters()
                       if "moe" in name.split(".")
                       and name.split(".")[-1] in ("w_gate", "w_up", "w_down"))
        n_active = n_total - expert_n * (1 - cfg.experts_per_token / cfg.num_experts)
    tokens = batch * (seq_len if kind != "decode" else 1)
    factor = 6.0 if kind == "train" else 2.0
    return factor * n_active * tokens


# ---------------------------------------------------------------------------
# The bounds chip_smoke.py prints
# ---------------------------------------------------------------------------

def kernel_bound_ms(module, cost: Tuple[float, float]) -> Tuple[float, str]:
    """A kernel call's bound -> (ms, bound_by): the larger of its operations
    (``cost`` = its module's (operations, bytes)) at the peak its module's
    ``PEAK`` names and its bytes at PEAK_HBM; "bytes" on a tie."""
    ops_ms, bytes_ms = cost[0] / PEAKS[module.PEAK] * 1e3, cost[1] / PEAK_HBM * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms > bytes_ms else "bytes")


def decode_bound_ms(model) -> float:
    """A decode step's least time: every weight read once at PEAK_HBM, but
    the embedding tables, of which a step gathers a row per token (every
    expert is read: a batch of tokens routes to most of them)."""
    gathered = {"embed", "codebook_embed"}
    nbytes = sum(p.numel() * p.element_size() for n, p in model.named_parameters()
                 if n not in gathered)
    return nbytes / PEAK_HBM * 1e3


def weights_per_token(cfg, model, skip) -> int:
    """The weights one token meets: every parameter not named in ``skip``,
    and of an MoE layer's routed experts only the ``experts_per_token`` it
    takes."""
    n = sum(p.numel() for name, p in model.named_parameters() if name not in skip)
    moe_layers = sum(1 for _, ffn in cfg.layer_kinds() if ffn == "moe")
    return n - (moe_layers * (cfg.num_experts - cfg.experts_per_token) * 3 * cfg.d_model
                * (cfg.moe_d_ff or cfg.d_ff))


def attention_pairs(cfg, length: int) -> int:
    """The query-key pairs the attention layers' masks keep over one
    sequence of ``length`` tokens, summed over the layers."""
    total = 0
    for mixer, _ in cfg.layer_kinds():
        if mixer == "attn_chunked":
            total += sum(i % cfg.chunk_size + 1 for i in range(length))
        elif mixer == "attn_local":
            total += sum(min(i + 1, cfg.window_size) for i in range(length))
        elif mixer == "attn":
            total += length * (length + 1) // 2
    return total


def prefill_bound_ms(cfg, model, length: int, batch: int) -> float:
    """A prefill group's least time (``batch`` x ``length`` tokens): the
    larger of every weight read once at PEAK_HBM and its products at
    PEAK_BF16_TENSOR: two operations per token and weight of the layers
    (``weights_per_token``), four per query-key pair an attention layer's
    mask keeps and head dim, and the LM head on the last token."""
    per_token = weights_per_token(cfg, model, {"embed", "codebook_embed", "lm_head",
                                               "codebook_head"})
    flops = 2.0 * batch * (length * per_token
                           + cfg.d_model * cfg.vocab_size * max(1, cfg.num_codebooks))
    flops += (4.0 * batch * attention_pairs(cfg, length) * cfg.num_heads
              * cfg.resolved_head_dim)
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    return max(flops / PEAK_BF16_TENSOR, nbytes / PEAK_HBM) * 1e3


def train_memory_gib(cfg, batch: int, seq: int) -> dict:
    """A trainer's memory, reckoned from the shapes before the card holds
    it: its weights (bf16, norms f32), grads of the same dtypes, f32 AdamW
    moments, the layers' inputs that remat keeps, and the largest transient:
    three f32 tensors of the plain attention's scores (B x H x L x L: the
    scores, their softmax and its gradient) or of the logits (B x L x V:
    logits, log-softmax and its gradient)."""
    model = _meta_model(cfg)
    n = sum(p.numel() for p in model.parameters())
    w = sum(p.numel() * p.element_size() for p in model.parameters())
    t = batch * seq
    attn = any(m.startswith("attn") for m, _ in cfg.layer_kinds())
    scores = batch * cfg.num_heads * seq * seq * 4 if attn and seq < cfg.attn_block_threshold else 0
    logits = t * cfg.vocab_size * max(1, cfg.num_codebooks) * 4
    out = {"params": n, "weights": w, "grads": w, "moments": 8 * n,
           "remat_saved": cfg.num_layers * t * cfg.d_model * 2,
           "transient": 3 * max(scores, logits)}
    gib = {k: v / 2 ** 30 for k, v in out.items() if k != "params"}
    gib["total"] = sum(gib.values())
    return {"params": n, **gib}


def train_bound_ms(cfg, batch: int, seq: int) -> tuple:
    """A train step's least time -> (ms, bound_by): the larger of its
    products at PEAK_BF16_TENSOR, 6 per token and weight a token meets (the
    LM head included, the embedding gather and an MoE layer's experts the
    token does not take left out) plus 12 per query-key pair the mask keeps
    and head dim in each attention layer (forward 4, backward 8), and its
    bytes at PEAK_HBM: the weights read, the grads written and read, the
    moments read and written and the weights written once each."""
    model = _meta_model(cfg)
    flops = (6.0 * batch * seq * weights_per_token(cfg, model, {"embed", "codebook_embed"})
             + 12.0 * batch * attention_pairs(cfg, seq) * cfg.num_heads * cfg.resolved_head_dim)
    n = sum(p.numel() for p in model.parameters())
    w = sum(p.numel() * p.element_size() for p in model.parameters())
    nbytes = 3 * w + 16 * n
    ops_ms, bytes_ms = flops / PEAK_BF16_TENSOR * 1e3, nbytes / PEAK_HBM * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")
