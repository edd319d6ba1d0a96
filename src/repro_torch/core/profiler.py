"""Offline Profiler (§5.1): latency/memory statistics per stage × degree.

Counterpart of ``repro/core/profiler.py``. It derives the tables from a
roofline-style analytic model over the pipeline's configs; parameter counts
and bytes come from the port's own modules built on the ``meta`` device, so
they are exact and allocate nothing. The hardware is a named, frozen
``Hardware`` set passed to ``Profiler``: this package defines ``H100_SXM``,
and ``REFERENCE_HW``, the JAX reference's own constants, so the port can
reproduce the reference's committed results.
Its rates are the data sheet's; its efficiency knobs (``mfu``,
``seq_mfu_knee``, ``mfu_conv``) are fitted to stage times measured on one
H100 (``python -m repro_torch.launch.calibrate``), and its host costs are
measured on the card's machine (``chip_smoke.py``).

Calibration targets (validated against the reference in the tests):
  * Diffuse scales well with SP at high resolution, poorly at low (Fig. 3);
  * Decode is memory/link-bound and scales poorly (Fig. 3);
  * Encode barely benefits from parallelism (§3);
  * Diffuse dominates end-to-end time (> 70%, §2.1/Fig. 8).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.request import Request
from repro_torch.models import diffusion, pipeline as pipe_lib, transformer


@dataclasses.dataclass(frozen=True)
class Hardware:
    """Per-chip constants of the cost model."""
    name: str
    peak_flops: float            # dense bf16 FLOP/s
    hbm_bw: float                # device memory bytes/s
    link_bw: float               # chip-to-chip bytes/s inside a node
    hbm_bytes: int               # device memory
    mem_reserve: int             # per-chip runtime reserve
    mfu: float                   # sustained matmul efficiency (long sequences)
    mfu_conv: float              # conv stacks' efficiency
    seq_mfu_knee: int            # per-chip tokens below which MFU degrades
    dispatch_overhead: float     # s, per-dispatch CPU scheduling cost
    inter_node_bw: float         # chip-to-chip bytes/s across nodes
    host_bw: float               # host<->device staging bytes/s
    comm_group_init: float       # s, lazy (non-hot-set) communicator build
    link_domain_chips: int = 0   # chips one ``link_bw`` domain spans (an SP
                                 # group wider than this all-to-alls at
                                 # ``inter_node_bw``); 0: every chip


# NVIDIA H100 SXM. Data sheet: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, 80 GB,
# NVLink 900 GB/s within an HGX H100 node of 8 GPUs; inter-node, one
# ConnectX-7 NIC of 400 Gb/s per GPU (not measured: no run here has more
# than one node). The reserve (CUDA context, library workspaces) is an
# estimate. The rest is from one chip run of ``chip_smoke.py`` on an NVIDIA
# H100 80GB HBM3 at 700.00 W, each stage on one chip after an untimed run at
# its shape:
#   mfu, seq_mfu_knee: least squares on log(predicted / measured) over the
#     Diffuse stage of sd3 at 1024 and 1536 px, flux at 512 and 1024 px,
#     cogvideox 480 px x 2 s and hunyuanvideo 540 px x 1 s (the knee at its
#     lower bound: no fall-off on one chip down to 1101 tokens; SP > 1 is
#     not measured);
#   mfu_conv: the same over the image Decode readings (sd3, flux);
#   dispatch_overhead: the host time of one Dispatcher.dispatch round on
#     the served path (0.0811 ms);
#   host_bw: a pinned 512 MiB host-to-device copy (51.51 GB/s);
#   comm_group_init: an NCCL communicator's build and first all-reduce at
#     world size 1 (528.81 ms), a lower bound on a group across GPUs.
H100_SXM = Hardware(
    name="H100-SXM", peak_flops=989e12, hbm_bw=3.35e12, link_bw=900e9,
    hbm_bytes=80 * 10 ** 9, mem_reserve=2 ** 30, mfu=0.6279, mfu_conv=0.3761,
    seq_mfu_knee=0, dispatch_overhead=8.11e-5, inter_node_bw=400e9 / 8,
    host_bw=51.51e9, comm_group_init=0.52881, link_domain_chips=8)

# The JAX reference's constant set (a TPU v5e chip), copied from its
# profiler. Not the port's hardware: it exists so that the port's host paths
# can be held against the reference's committed results
# (``launch/serve_fleet.py --hw reference``). Its links span every chip, as
# the reference prices its cross-node SP.
REFERENCE_HW = Hardware(
    name="reference", peak_flops=197e12, hbm_bw=819e9, link_bw=50e9,
    hbm_bytes=16 * 2 ** 30, mem_reserve=512 * 2 ** 20, mfu=0.5, mfu_conv=0.12,
    seq_mfu_knee=384, dispatch_overhead=0.004, inter_node_bw=25e9,
    host_bw=10e9, comm_group_init=0.05)

# the constant sets the launchers' ``--hw`` option names
HARDWARE = {"h100": H100_SXM, "reference": REFERENCE_HW}

# SP degrees in scheduling units; those above one node's worth (8 chips) are
# reachable only with cross-node SP (``Profiler(cross_node_sp=True)``)
PARALLEL_DEGREES = (1, 2, 4, 8, 16, 32)
EFFICIENCY_THRESHOLD = 0.8   # paper footnote 4/5


def _count(module: torch.nn.Module) -> Tuple[int, int]:
    """(parameter count, parameter bytes) of a module."""
    ps = list(module.parameters())
    return (sum(p.numel() for p in ps), sum(p.numel() * p.element_size() for p in ps))


@dataclasses.dataclass(frozen=True)
class StageModelInfo:
    params: int          # parameter count
    bytes: int           # parameter bytes
    num_layers: int
    d_model: int


class Profiler:
    """Cost/memory model for one diffusion pipeline."""

    def __init__(self, cfg: pipe_lib.PipelineConfig, hw: Hardware = H100_SXM,
                 force_k_min: Optional[int] = None, cross_node_sp: bool = False):
        self.cfg = cfg
        self.hw = hw
        self.info = self._stage_infos(cfg)
        # force_k_min=1 models baselines that do not use the App.-E.2 MP fold
        self.k_min = force_k_min if force_k_min else self._compute_k_min()
        # SP instances are intra-node in the paper (§6.2, a PCIe-box
        # constraint), so by default SP stays inside one 8-GPU node.
        # cross_node_sp extends the degrees to 32 units across nodes, still
        # filtered by efficiency; a group wider than the hardware's link
        # domain is priced at its inter-node rate (``_link_bw``)
        self.cross_node_sp = cross_node_sp
        base = max(1, 8 // self.k_min)
        self.max_degree_units = 32 // self.k_min if cross_node_sp else base
        # memo tables keyed by request class — request mixes repeat heavily,
        # exactly the paper's "pre-profiled candidate resolutions" (§5.1)
        self._time_memo: Dict[Tuple, float] = {}
        self._deg_memo: Dict[Tuple, int] = {}
        self._fits_memo: Dict[Tuple, bool] = {}
        self._batch_memo: Dict[Tuple, float] = {}

    @staticmethod
    def _class_key(req: Request) -> Tuple:
        """Workload-class memo key: (pipeline, resolution, seconds) + prompt."""
        return req.key() + (req.cond_len,)

    def _seq_mfu(self, l_per_chip: float) -> float:
        """MFU falls off when the per-chip sequence shard is small — sliced
        matmuls stop saturating the tensor cores. This is what makes
        low-resolution requests prefer small SP degrees (Fig. 3)."""
        return self.hw.mfu * l_per_chip / (l_per_chip + self.hw.seq_mfu_knee)

    # -- static model facts --------------------------------------------------

    @staticmethod
    @functools.lru_cache(maxsize=None)
    def _stage_infos_cached(cfg: pipe_lib.PipelineConfig):
        meta = torch.device("meta")
        enc = transformer.Transformer(cfg.encoder, meta)
        dit = pipe_lib.dit_class(cfg.dit)(cfg.dit, meta)
        dec = diffusion.Decoder(cfg.decoder, meta)

        def mk(module, nl, dm):
            n, nbytes = _count(module)
            return StageModelInfo(params=n, bytes=nbytes, num_layers=nl, d_model=dm)

        return {
            "E": mk(enc, cfg.encoder.num_layers, cfg.encoder.d_model),
            "D": mk(dit, cfg.dit.num_layers, cfg.dit.d_model),
            "C": mk(dec, cfg.decoder.num_upsamples, cfg.decoder.base_channels),
        }

    def _stage_infos(self, cfg):
        return self._stage_infos_cached(cfg)

    def _compute_k_min(self) -> int:
        """Smallest power-of-two chips/unit so the Diffusion model's MP shard
        fits one chip with headroom (App. E.2)."""
        need = self.info["D"].bytes * 1.25
        k = 1
        while need / k > self.hw.hbm_bytes * 0.9 and k < 8:
            k *= 2
        return k

    # -- workload geometry ----------------------------------------------------

    def proc_len(self, req: Request, stage: str) -> int:
        return pipe_lib.stage_proc_len(self.cfg, stage, req.resolution,
                                       req.seconds, req.cond_len)

    def latent_tokens(self, req: Request) -> int:
        return self.cfg.latent_tokens(req.resolution, req.seconds)

    # -- FLOPs / bytes per stage ----------------------------------------------

    def stage_flops(self, req: Request, stage: str) -> float:
        if stage == "E":
            i = self.info["E"]
            l = req.cond_len
            return 2.0 * i.params * l + 4.0 * i.num_layers * l * l * i.d_model
        if stage == "D":
            i = self.info["D"]
            l = self.latent_tokens(req) + req.cond_len
            per_step = 2.0 * i.params * l + 4.0 * i.num_layers * l * l * i.d_model
            return per_step * self.cfg.num_steps
        flops, _, _ = self._decoder_cost(req)
        return flops

    def _decoder_cost(self, req: Request) -> Tuple[float, float, float]:
        """(flops, activation_bytes, hbm_traffic) for the AE decoder.

        Models the *real* AE-KL decoder cost: residual conv blocks per level,
        3D (27-point) kernels + temporal upsampling for video — the
        reference decoder is 2D-per-frame, but the serving planner must see
        the production decoder's cost profile (DESIGN.md §assumptions).
        """
        dec = self.cfg.decoder
        f_lat, h, w = self.cfg.latent_grid(req.resolution, req.seconds)
        side = 2 * h                       # after un-patchify
        kernel = 18 if self.cfg.is_video else 9  # video AEs use factorized 2+1D convs
        convs = 1 + 2 * dec.res_blocks     # per level (res blocks = 2 convs)
        flops = act = 0.0
        for lvl in range(dec.num_upsamples + 1):
            spatial = (side * (2 ** lvl)) ** 2
            frames = (f_lat * (2 ** min(lvl, 2))) if self.cfg.is_video else 1
            cc = max(dec.base_channels // (2 ** lvl), 128)
            flops += spatial * frames * cc * cc * kernel * 2 * convs
            act += spatial * frames * cc * 2 * convs
        return flops, act, self.info["C"].bytes + act * 2

    def stage_act_bytes(self, req: Request, stage: str) -> float:
        """Peak activation bytes at degree 1 (shards ~1/k with SP)."""
        if stage == "E":
            return req.cond_len * self.info["E"].d_model * 2 * 12
        if stage == "D":
            l = self.latent_tokens(req) + req.cond_len
            return l * self.info["D"].d_model * 2 * 24
        _, act, _ = self._decoder_cost(req)
        return act

    def stage_hbm_bytes(self, req: Request, stage: str) -> float:
        """Total HBM traffic (params re-read per step + activations)."""
        if stage == "E":
            return self.info["E"].bytes + self.stage_act_bytes(req, "E") * 2
        if stage == "D":
            return (self.info["D"].bytes + self.stage_act_bytes(req, "D") * 4
                    ) * self.cfg.num_steps
        _, _, hbm = self._decoder_cost(req)
        return hbm

    # -- latency model ---------------------------------------------------------

    def stage_time(self, req: Request, stage: str, k_chips: int) -> float:
        """Wall-clock estimate of stage ``stage`` at SP degree ``k_chips``."""
        key = (req.pipeline, req.resolution, req.seconds, req.cond_len,
               stage, k_chips)
        hit = self._time_memo.get(key)
        if hit is not None:
            return hit
        t = self._stage_time_impl(req, stage, k_chips)
        self._time_memo[key] = t
        return t

    def _link_bw(self, k_chips: int) -> float:
        """Bytes/s of an SP group's exchange: the node's links, or the
        inter-node rate once the group spans more than one link domain."""
        dom = self.hw.link_domain_chips
        return self.hw.link_bw if dom == 0 or k_chips <= dom else self.hw.inter_node_bw

    def _stage_time_impl(self, req: Request, stage: str, k_chips: int) -> float:
        hw = self.hw
        flops = self.stage_flops(req, stage)
        hbm = self.stage_hbm_bytes(req, stage)
        if stage == "E":
            # batching-friendly, parallelism-averse: capped speedup
            speed = min(k_chips, 1.3)
            return (max(flops / (hw.peak_flops * hw.mfu), hbm / hw.hbm_bw) / speed
                    + (k_chips - 1) * 2e-3 + hw.dispatch_overhead)
        if stage == "D":
            i = self.info["D"]
            l = self.latent_tokens(req) + req.cond_len
            compute = flops / (k_chips * hw.peak_flops * self._seq_mfu(l / k_chips))
            mem = hbm / (k_chips * hw.hbm_bw)
            # Ulysses: 2 all-to-alls per layer per step; (k-1)/k^2 wire factor
            a2a = l * i.d_model * 2
            comm = (self.cfg.num_steps * i.num_layers * 2 * a2a
                    * (k_chips - 1) / (k_chips ** 2) / self._link_bw(k_chips)
                    ) if k_chips > 1 else 0.0
            return max(compute, mem) + comm + hw.dispatch_overhead
        # Decode: conv pyramid; halo exchange + per-chip launch overhead make
        # spatial sharding scale poorly (paper Fig. 3 right)
        mem = hbm / (k_chips * hw.hbm_bw)
        compute = flops / (k_chips * hw.peak_flops * hw.mfu_conv)
        comm = ((self.stage_act_bytes(req, "C") * 0.3 * (k_chips - 1)
                 / k_chips / self._link_bw(k_chips)) + (k_chips - 1) * 2e-3
                ) if k_chips > 1 else 0.0
        return max(mem, compute) + comm + hw.dispatch_overhead

    def batched_stage_time(self, req: Request, stage: str, k_chips: int,
                           batch: int) -> float:
        """Latency of serving ``batch`` identical requests in one run
        (App. E.1): compute-bound work amortizes per-item; activation
        traffic scales linearly."""
        if batch <= 1:
            return self.stage_time(req, stage, k_chips)
        key = (req.pipeline, req.resolution, req.seconds, req.cond_len,
               stage, k_chips, batch)
        hit = self._batch_memo.get(key)
        if hit is not None:
            return hit
        flops = self.stage_flops(req, stage) * batch
        hbm = (self.stage_hbm_bytes(req, stage)
               + (batch - 1) * self.stage_act_bytes(req, stage) * 3)
        base = self.stage_time(req, stage, k_chips)
        hw = self.hw
        mfu = hw.mfu_conv if stage == "C" else hw.mfu
        t = max(flops / (k_chips * hw.peak_flops * mfu),
                hbm / (k_chips * hw.hbm_bw)) + hw.dispatch_overhead
        t = max(base, t)
        self._batch_memo[key] = t
        return t

    def optimal_batch(self, req: Request, stage: str, k_chips: int,
                      cap: int = 8) -> int:
        """Largest batch whose latency stays within 1.2x single (E.1)."""
        key = (req.pipeline, req.resolution, req.seconds, req.cond_len,
               stage, k_chips, "bs")
        hit = self._deg_memo.get(key)
        if hit is not None:
            return hit
        t1 = self.stage_time(req, stage, k_chips)
        best = 1
        bs = 2
        while bs <= cap:
            if self.batched_stage_time(req, stage, k_chips, bs) <= 1.2 * t1:
                best = bs
            bs *= 2
        self._deg_memo[key] = best
        return best

    def speedup(self, req: Request, stage: str, k_chips: int) -> float:
        return self.stage_time(req, stage, 1) / self.stage_time(req, stage, k_chips)

    def efficiency(self, req: Request, stage: str, k_chips: int) -> float:
        return self.speedup(req, stage, k_chips) / k_chips

    def optimal_degree(self, req: Request, stage: str) -> int:
        """Paper's *optimal parallelism strategy*: highest degree with
        efficiency > 0.8 (footnote 4). In scheduling *units*."""
        key = (req.pipeline, req.resolution, req.seconds, req.cond_len,
               stage)
        hit = self._deg_memo.get(key)
        if hit is not None:
            return hit
        best = 1
        for k in PARALLEL_DEGREES:
            if k > self.max_degree_units:
                break
            if self.efficiency(req, stage, k * self.k_min) > EFFICIENCY_THRESHOLD:
                best = k
        self._deg_memo[key] = best
        return best

    def pipeline_time(self, req: Request, k_chips: Optional[int] = None) -> float:
        """End-to-end time at per-stage optimal (used for SLO = 2.5x this)."""
        total = 0.0
        for s in ("E", "D", "C"):
            k = k_chips or self.optimal_degree(req, s) * self.k_min
            total += self.stage_time(req, s, k)
        return total

    # -- memory feasibility ------------------------------------------------------

    def unit_param_bytes(self, ptype: str) -> float:
        """Per-chip parameter bytes for a placement type (MP folds /k_min)."""
        return sum(self.info[s].bytes for s in ptype) / self.k_min

    def peak_mem(self, req: Request, ptype: str, k_units: int) -> float:
        """Per-chip peak bytes running the heaviest stage of ``ptype`` for
        ``req`` at degree ``k_units`` (SP shards activations, not params).

        Decode activations are capped at the tiled-decode working set (VAE
        tiling is standard practice; the *time* model still pays the full
        HBM traffic)."""
        k_chips = k_units * self.k_min

        def act(s):
            a = self.stage_act_bytes(req, s) / k_chips
            return min(a, 4 * 2 ** 30) if s == "C" else a

        peak = max(act(s) for s in ptype)
        return self.unit_param_bytes(ptype) + peak + self.hw.mem_reserve

    def fits(self, req: Request, ptype: str, k_units: int) -> bool:
        """Memory-feasibility filter F_{r,i,k} — memoized: it sits on the
        dispatch hot path (called per pending request x VR type x degree,
        every scheduler wake-up)."""
        key = (req.pipeline, req.resolution, req.seconds, req.cond_len,
               ptype, k_units)
        hit = self._fits_memo.get(key)
        if hit is None:
            hit = self.peak_mem(req, ptype, k_units) <= self.hw.hbm_bytes
            self._fits_memo[key] = hit
        return hit

    # -- inter-stage communication -------------------------------------------------

    def comm_bytes(self, req: Request, edge: str) -> float:
        """Q_ED / Q_DC tensor volumes (bf16)."""
        if edge == "ED":
            return req.cond_len * self.info["E"].d_model * 2.0
        if edge == "DC":
            return self.latent_tokens(req) * self.cfg.dit.latent_dim * 2.0
        raise KeyError(edge)

    def transfer_time(self, nbytes: float, intra_node: bool) -> float:
        return nbytes / (self.hw.link_bw if intra_node else self.hw.inter_node_bw) + 2e-4

    def stage_load_time(self, stage: str, via_host: bool) -> float:
        """Adjust-on-Dispatch replica load (P2P peer vs pinned-host path)."""
        per_chip = self.info[stage].bytes / self.k_min
        return per_chip / (self.hw.host_bw if via_host else self.hw.link_bw) + 1e-3
