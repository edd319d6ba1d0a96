#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA H100 and check it.

  python3 chip_smoke.py

Phases:
  1. require a CUDA card; print its name and power limit; turn TF32 off;
  2. build the Hopper kernels from ``src/repro_torch/csrc``, and print K1's,
     K2's and K3's registers and spills per instantiation (from ptxas), and
     K1's shared memory;
  3. hold each kernel against its plain PyTorch version on the same CUDA
     tensors at every shape the serve phases give it (and the variant
     shapes of the reference's kernel tests, and for K1 the lengths on and
     beside its 128-row and 128-key tile edges, causal queries at the end of
     a longer kv, a window across tiles and causal D=128; at D=256, where its
     key tile is 64, lengths on and beside those edges, causal and not, a
     window across tiles, a window with a softcap, a softcap alone and
     causal queries at the end of a longer kv; for K2 float32 at
     the served widths and batches > 1 with ragged blocks), with kernel,
     plain, library and bound times per shape (device times from CUDA-graph
     replays; each K1 shape timed with its own window and softcap, and with
     no library call where a softcap leaves no single PyTorch call computing
     it), each time's share of its bound and its ratio to the library
     call; at the serving shapes K1's check must also reject the output of
     a kernel that lets the padded keys of its ragged last tile in. K1 at
     the heavy classes' lengths (up to 81077) and at llama4's 8192-token
     chunks and global layers, whose plain scores do not fit, is held on a
     subset of its query rows against every key (the first tile, a tile
     edge in the middle, the ragged last tile and seeded tiles; a causal
     row with its own row of the mask), its plain time taken on those rows
     alone;
  4. check that a two-layer cut of each diffusion pipeline (sd3, flux,
     cogvideox, hunyuanvideo) at full width agrees on the card (bf16, through
     the kernels) with the same weights on the CPU (float32, plain versions):
     the encoder's output and one DiT forward's output (a 256 px image, or
     one second of 256 px video);
  5. serve five full-width, full-depth sd3 requests (128, 256, 512, 1024,
     1536 px, 20 steps) stage by stage through
     ``repro_torch.launch.quickstart.serve``, counting the kernels' launches;
  5b. the same for flux (128, 256, 512 and 1024 px, 4 steps), cogvideox
     (480 px x 2 s, 6 steps) and hunyuanvideo (540 px x 1 s, 6 steps), one
     pipeline at a time, each freed before the next is built;
  5d. on each video pipeline and flux before it is freed, every class of
     ``quickstart.HEAVY`` (flux at 2048-4096 px, cogvideox at 480 px x 4-10 s
     and 720 px x 2-10 s, hunyuanvideo at 540 px x 2-8 s and 720 px x 1-8 s)
     with its DDIM loop cut to one step, then the cheapest of them
     (WHOLE_HEAVY) whole, with the same output and launch checks;
  5c. print each served request's stage times beside the profiler's
     predictions under ``H100_SXM`` (fitted to such readings by
     ``python -m repro_torch.launch.calibrate``), write them to
     ``chiprun_out/stage_times.json``, and fail if a fitted Diffuse reading
     leaves [0.7, 1.3] x its prediction; measure the host constants the
     profiler takes from this machine (a pinned 512 MiB host-to-device copy,
     an NCCL communicator's build at world size 1, one dispatch round) and
     print each beside its constant;
  6. hold K3 (the gated linear-attention scan) against its plain version at
     every shape and layout the LLM serve phase gives it, at the reference's
     kernel-test shapes, at the decay floor (where it must also give the same
     result when the sequence is cut at a point that is no chunk boundary),
     with q, k and the decay all shared across heads, on and beside the
     edges of its chunks and of its ring of staged chunks, and at a layout
     that takes its element-wise staging path; each record prints the
     kernel's plan (rows of S per thread, slice, staging path);
  7. check that a full-width cut of each served LLM agrees on the card (bf16,
     kernels) with the same weights on the CPU (float32, plain versions):
     rwkv6-3b's first 2 layers, zamba2-1.2b's 6-layer cycle, and 2 layers of
     yi-9b, yi-34b, starcoder2-15b, gemma2-9b (one local, one global layer)
     and deepseek-moe-16b (the dense layer, then an MoE one), llama4-maverick
     (a chunked and the global dense layer), internvl2-2b (behind its
     256-token vision prefix) and musicgen-medium (on delayed codebook
     tokens), the window models' window and llama4's chunk cut to
     CUT_WINDOW so that the prompt passes it and the decode steps wrap their
     ring: the last-token logits of an 1100-token prompt, the final SSM
     states, the K/V caches, and the logits after 4 decode steps; then
     llama4's MoE layer alone with all 128 experts, fed the same bf16
     hidden states on both sides (``check_moe_cut``: tokens routed to
     another expert on the card are counted and left out);
  8. serve eight requests (prompts of 256..2048 tokens, 32 new tokens, 4 per
     group) on full-width, full-depth rwkv6-3b, zamba2-1.2b, yi-9b, yi-34b
     and deepseek-moe-16b through ``repro_torch.launch.serve_llm.serve``,
     counting the kernels' launches, one model built and freed at a time
     (yi-34b's 64 GiB of weights leave room for nothing else);
  8b. the same for starcoder2-15b and gemma2-9b on prompts of 4352..6144
     tokens, past their 4096-token window, so the window binds in prefill
     and the local rings wrap in decode;
  8c. the same for the zoo's last three: llama4-maverick at full width cut
     to one period of its pattern (4 layers, 128 experts) on prompts of
     8448..10240 tokens, past its 8192-token chunk; internvl2-2b whole, text
     prompts of 256..2048 tokens behind 256 stub patch embeddings;
     musicgen-medium whole on delayed (4, 250..1500) codebook prompts; each
     group printed beside its prefill and decode bounds;
  13. (run after 8c, once every served model is freed) training on the
     card, through the reference's training math, which reaches no kernel:
     (a) ``launch/train_llm --preset 100m --steps 200`` (float32), whose
     loss must fall and whose checkpoint (parameters, AdamW moments, step)
     must restore bit-equal into a state drawn from another seed; (b) one
     forward and backward of full-width 2-layer cuts of yi-9b, deepseek-moe-16b
     (its dense layer, then an MoE one of 64 experts) and rwkv6-3b in bf16 on
     the card against the same weights in float32 on the CPU, on one
     256-token batch: the loss, the mean NLL, the aux loss and every
     parameter's gradient within ``TRAIN_CUT_TOL`` (tokens whose set of
     experts differs, or that one side kept and the other dropped, are left
     out of both losses); (c) full-width trainers through
     ``launch/train.main``, 10 steps of 4 x 2048 tokens each: yi-9b cut to
     8 layers, deepseek-moe-16b cut to 4 (one dense, three MoE) and
     rwkv6-3b whole, each with its memory reckoned before the card holds
     it, finite loss and gradient norm at every step, step 10 at the end,
     and ms a step, tokens/s, peak GiB and the step's bound printed. The
     phase must add no K1 and no K3 launch;
  14. (run after 13) sharding on the card, with worlds of 4 and 2 ranks
     sharing it over gloo (``repro_torch.launch.shard_check``; NCCL does
     not put two ranks on one card, and gloo carries CUDA tensors through
     the host, so the phase's host seconds time gloo, not the card): (a)
     Ulysses attention (``sharding/sequence_parallel.py``: an all-to-all
     from sequence to head sharding, K1, the all-to-all back) at sd3's and
     flux's attention widths (B = 1, L = 4096, non-causal) and yi-9b's (B =
     2, L = 2048, causal), bf16, its gathered output held against K1
     unsharded within K1's limits and against the plain version on
     ``k1_rows``; (b) the chunk-parallel scan through K3 at rwkv6-3b's
     width (with the bonus) and zamba2-1.2b's (inclusive), B = 1, L =
     2048, each also at the decay floor, held against K3 unsharded within
     K3's limits; (c) one sharded train step (``launch/train``'s path:
     DTensor state by the partition rules, float32, TF32 off) of yi-9b cut
     to 2 layers with ``zero`` and without, and of deepseek-moe-16b cut to
     2 layers with ``fsdp``, B x L = 2 x 1024, against the unsharded step
     on the card (loss, aux loss, gradient norm, every parameter, its
     step and every moment element), each
     with its memory reckoned first, at world size 1 under NCCL on a 1x1
     mesh (``SP_TRAIN_WHY``: gloo's functional all-gather on CUDA tensors
     ends the rank in torch 2.11). One ``[14]
     {json}`` row per check; the ranks' K1 and K3 launches are counted (a
     path of their own in the kernels line), and the train step must
     launch none;
  15. (run after 14) the roofline and the dry run (``repro_torch.roofline``,
     ``launch/dryrun``, ``launch/dryrun_pipeline``): (a) the counter's known
     answers on this torch (a Shard(0) x Shard(1) product on a fake 16x16
     world, its first call and its second; two collectives on a fake world
     of 4); (b) the dry run of DRYRUN_CASES and sd3's stages on ``meta``
     over fake 16x16 and 2x16x16 worlds, one ``[15b]`` row each (the three
     terms on H100_SXM), failing on an error, with its host seconds; (c) one
     yi-9b prefill group at phase 8's first shape and one sd3 DiT step at
     512 px on the card under the counter, each equal in FLOPs, bytes and
     kernel calls to the same step on ``meta``, its kernel calls equal to
     the launches it made (a path of the kernels line), printed with its
     CUDA-event time after an untimed run, its roofline bound on H100_SXM,
     their ratio and the reckoned peak beside the allocator's. (d): every
     bound the phases print (3, 5, 6, 8, 13) comes from
     ``roofline.analysis`` and the kernel modules' ``cost``;
  9. run the simulated H100 cluster through ``repro_torch.launch.serve.main``
     for each pipeline on the dynamic workload over 600 s, trident and B1-B6,
     at 128 chips and at 16 (with the rate scaled to the same load per
     chip), printing each result, writing them to ``chiprun_out/cluster.json``,
     and failing if a second trident run of one cell differs in any
     deterministic field;
  10. run the simulated H100 fleet through
     ``repro_torch.launch.serve_fleet.main`` on the host: the shared-cluster
     mix flip (sd3 + flux + cogvideox, 128 chips at the reference's load per
     chip, 600 s) under the static, proportional, adaptive and predictive
     fleet schedulers; the diurnal predictive scenario at its CI size cut to
     480 s (adaptive, predictive); the cross-lane batching burst storm at its
     CI size (batching off, on); unit lending on the bursty-E/C trace at its
     own pool (sd3 + cogvideox, 256 chips; adaptive without and with
     lending, cut to 300 s); elastic capacity at its CI size (sd3 +
     hunyuanvideo, 128 chips, one preemption storm, 480 s; drain-aware,
     drain-unaware), on ``H100_SXM`` and again on the reference's constants.
     One ``[10] {json}`` row per mode, written to ``chiprun_out/fleet.json``;
     a second run of one mode of each scenario must give every
     ``FleetResult`` field (and the elastic recovery-window P95) the same,
     no Diffuse stage may run on a borrowed unit, and on the reference's
     constants the drain-unaware arm must requeue work when nodes are lost,
     or the phase fails;
  11. the fleet's host-path switches (``array_state``, ``incremental_ilp``,
     ``step_changed_lanes_only``), on the host: (a) phase 10's six scenario
     cells again with ``serve_fleet --fast``, a second run of one mode of
     each must give the same ``FleetResult``, each mode must serve as many
     requests as its phase-10 run and finish as many, and no Diffuse stage
     may run on a borrowed unit; each ``[11] {json}`` row carries phase 10's
     ``host_s`` beside its own; (b) the lending (600 s) and predictive
     (960 s) scenarios uncut, with ``--fast``; (c) the scale tier's smoke
     size (512 chips, 100,000 requests) through ``launch/scale.py``, on the
     reference's constants, where the simulated fields must be the ones the
     CPU gives, and on ``H100_SXM``; (d) trident with cross-node SP on
     hunyuanvideo's dynamic workload at 128 chips on ``H100_SXM``, with and
     without ``--cross-node-sp``, printing the VR and SP degree histograms.
     Rows are written to ``chiprun_out/fast.json``;
  12. the paper's figure scripts (``repro_torch.benchmarks.run``'s modules:
     Figs. 3, 4, 10-15 and 17, Table 4) in quick mode on ``H100_SXM``, on the
     host, every row written to ``chiprun_out/figures_h100.csv`` and printed
     (simulated numbers); then the event-vs-tick smoke set on the
     reference's constants, whose scenarios, wake-up counts and clock parity
     must equal the committed ``BENCH_event_sim.json`` and
     ``BENCH_unified_clock.json``.

Each phase prints the seconds it took.

Every counted serve run (phases 5, 5b, 5d, 8, 8b and 8c) follows one untimed run at
each of its shapes, so its stage times hold no first-call cost. K1 is also
held, timed and counted at every LLM's causal prefill shapes (from its
config: heads, head dim, window, softcap) and at hunyuanvideo's causal
encoder. The second-to-last lines are the card's name
and power limit, then one JSON object with a record per kernel; the last
line is
``{"ok": true, "device": {...}}``. Any failure raises: the script then
exits non-zero and prints no such line.
"""
from __future__ import annotations

import ctypes
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.roofline import analysis as roofline  # noqa: E402

# published H100 SXM peaks (NVIDIA data sheet): every bound is priced at them
PEAK_BF16_TENSOR = roofline.PEAK_BF16_TENSOR   # FLOP/s, dense
PEAK_F32 = roofline.PEAK_F32                   # FLOP/s, outside the tensor cores
PEAK_HBM = roofline.PEAK_HBM                   # bytes/s

# the served pipelines: phase 5 serves the first, phase 5b the others, phase
# 5d the heavy classes of the last three
PIPELINES = ("sd3", "flux", "cogvideox", "hunyuanvideo")
# (K1, K2) launches of a serve (``serve_launches``): per request and step,
# one K1 per DiT block and one K2 per block's two norms plus the final one;
# per request, one K1 per layer of a causal encoder (hunyuanvideo's 32).
# Phases 5 and 5b serve quickstart.REQUESTS whole:
#   sd3   5 requests x 20 steps: 24 x 100 = 2400, 49 x 100 = 4900
#   flux  4 x 4: 56 x 16 = 896, 113 x 16 = 1808
#   cogvideox 1 x 6: 25 x 6 = 150, 51 x 6 = 306
#   hunyuanvideo 1 x 6: 64 x 6 + 32 = 416, 129 x 6 = 774
# phase 5d quickstart.HEAVY at one step, then WHOLE_HEAVY with all its steps:
#   flux  3 x 1 + 4: 56 x 7 = 392, 113 x 7 = 791
#   cogvideox 7 x 1 + 6: 25 x 13 = 325, 51 x 13 = 663
#   hunyuanvideo 7 x 1 + 6: 64 x 13 + 32 x 8 = 1088, 129 x 13 = 1677
# the cheapest heavy class of each pipeline, which phase 5d also serves whole
WHOLE_HEAVY = {"flux": (2048, 0.0), "cogvideox": (720, 2.0), "hunyuanvideo": (540, 2.0)}
COND_LEN = 77                 # prompt tokens of every served request
# Table 5's light end: the smallest classes of quickstart.REQUESTS
LIGHT_END = (("sd3", 128, 0.0), ("sd3", 256, 0.0), ("flux", 128, 0.0), ("flux", 256, 0.0))
CUT_RES = 256                 # phase 4's latent grid: 256 px, one second of video
# K1, bf16: attention outputs of N(0, 1) inputs are small (rms ~ sqrt(e / L)),
# so its limits scale with the output's rms. Elementwise, |kernel - plain|
# <= K1_ATOL * rms(row) + K1_RTOL * |plain| (two bf16 ulps), where rms(row)
# is the rms of the plain output's query row (over heads and D): a causal
# row t averages only t + 1 values, so early rows are large and their
# probabilities' rounding (at another place in K1 than in the plain version)
# shows where the terms cancel. In all, rms(kernel - plain) <= K1_RMS *
# rms(plain). Rounding alone gives about 0.5x and 0.3% of these; letting the
# 51 padded keys of the ragged last tile in at score 0 fails the first at
# L = 1101 and the second at L = 1101 and 4173, and the second with 47 at
# 4433 (tests/test_torch_smoke_checks.py holds these with a CPU model of K1's
# rounding, whose maximum errors agree with the card's)
K1_ATOL = 3e-2
K1_RTOL = 2.0 ** -6
K1_RMS = 5e-3
# at 7277 (19 padded keys: 0.36% rms in that model) and 9293 the fault is
# below the limits
K1_FAULT_SHOWN = (1101, 4173, 4433)
K1_BN = 128                    # K1's keys per KV tile: the padding of its ragged last tile
K1_BM = 128                    # query rows of a tile (two 64-row consumers)
# the plain version holds one 8-head group's f32 scores, B x 8 x Lq x Lkv; a
# shape past this many bytes of them (the heavy DiT classes from L = 14477;
# the largest shape held whole is 4 x 5975 tokens, 4.57e9 bytes) is checked
# on a subset of its query rows against every key (``k1_rows``)
K1_PLAIN_BYTES = 6e9
K1_SUBSET_TILES = 4
# K1 shapes past K1_LONG_FLOPS (a call of milliseconds or more, up to ~0.2 s
# at L = 81077) are timed over K1_LONG_REPS calls, the others over 20
K1_LONG_FLOPS, K1_LONG_REPS = 2e12, 3
# K2: |kernel - plain| <= tol + tol * |plain|, elementwise (the reference's
# kernel tests use the same form): bf16 outputs differ by an ulp or two of
# rounding, f32 ones by the order of the sums
K2_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# K2 at batches > 1 and the served widths: a block's rows lie in one batch
# row, each batch row ends in a ragged block (L is no multiple of the plan's
# rows per block), and a block that read another batch row's modulation shows
# (tests/test_torch_smoke_checks.py models that fault and the others)
K2_BATCHED = ((2, 1101, 1536), (3, 333, 3072), (4, 333, 1536))
# phase 4, bf16 card vs f32 CPU: the encoder's output by max |err| / max |ref|;
# the DiT's output (eps) by rms(err) / rms(ref), where the CPU's own bf16 run
# reads 0.5% and zeroing the attention moves it 4% (tests/test_torch_smoke_checks.py)
ENC_TOL = 5e-2
EPS_TOL = 1e-2
L2_BYTES = 50 * 2 ** 20
# K3: the kernel and its plain version keep the state and every sum in f32 and
# differ only in the order of the sums over K: the state and f32 outputs agree
# to 1e-5 of their rms (elementwise: 1e-5 rms + 1e-5 |plain|); bf16 outputs
# are those f32 values rounded, so at most one bf16 ulp apart (1e-5 rms +
# 2^-7 |plain|)
K3_RMS = 1e-5
K3_REL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
# phase 7, bf16 card vs f32 CPU, each reading rms(err) / rms(ref): the CPU's
# own bf16 run of the same cut reads 0.9-1.9%, and a scan that drops rwkv6's
# bonus or reads one token late in zamba2 moves a reading to 8-12%
# (tests/test_torch_smoke_checks.py prints both and holds the limits between)
# (the K/V caches: their bf16 projections' rounding, 0.4-1.6% on the card)
LLM_CUT_TOL = {"logits": 0.04, "ssm_state": 0.04, "kv_cache": 0.04, "decode_logits": 0.04}
# the SSM LLMs (phase 7's limits on them are held against scan faults in
# tests/test_torch_smoke_checks.py), then the attention LLMs; phase 8 serves
# all but LONG_ARCHS, phase 8b those, on prompts past their window
LLM_ARCHS = ("rwkv6-3b", "zamba2-1.2b")
ATTN_ARCHS = ("yi-9b", "yi-34b", "deepseek-moe-16b", "starcoder2-15b", "gemma2-9b")
LONG_ARCHS = ("starcoder2-15b", "gemma2-9b")
LLM_REQUESTS, LLM_LENGTHS, LLM_MAX_NEW = 8, (256, 2048), 32
LONG_LENGTHS = (4352, 6144)
LLM_BATCH = 4                 # serve_llm.MAX_BATCH: requests per ServeEngine group
CUT_PROMPT, CUT_BATCH, CUT_DECODE = 1100, 2, 4
CUT_WINDOW = 512              # phase 7's window and chunk: CUT_PROMPT passes it, the decode wraps
# phase 8c: the zoo's last three LLMs, each built and freed in turn. llama4 at
# full width, its depth cut to one period of its pattern (LLAMA4_LAYERS: 3
# chunked layers and 1 global; 2 MoE layers with all 128 experts and the
# shared expert, 2 dense): 35.0 B parameters, 65.3 GiB in bf16. Its prompts
# pass the 8192-token chunk, so the chunk binds in prefill and the chunked
# rings wrap in decode. Each group's padded B x L (4 x 10240, 4 x 9216) has
# 1024 as a divisor, so the MoE routes in groups of 1024 tokens
# (``moe._group_size``); a B x L with no divisor near 1024 would route in tiny
# groups, whose gathered expert batch holds ~T x 512 x D elements.
ZOO_ARCHS = ("llama4-maverick-400b-a17b", "internvl2-2b", "musicgen-medium")
LLAMA4 = ZOO_ARCHS[0]
LLAMA4_LAYERS = 4
LLAMA4_PROMPTS = (10240, 8448, 9472, 8960, 9216, 8704, 8832, 9000)
MUSICGEN_FRAMES = (250, 1500)  # musicgen's prompts: 5-30 s of audio at 50 frames a second
# phase 7's llama4 MoE layer: a router near-tie sends a token to another of
# the 128 experts on the card than on the CPU, which changes its whole row;
# such tokens (and those whose place in an expert's buffer moved past its
# capacity or back) are left out, and at most this share may change expert
# (bf16's rounding of the router's input alone flips ~0.2%:
# tests/test_torch_smoke_checks.py)
MOE_FLIP_LIMIT = 0.01
CARD_GIB = 79.0               # what one H100's 80 GB leaves to PyTorch, about


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def agree(got, want, tol: float):
    """(max |got - want|, whether every element is within tol + tol * |want|)."""
    d = (got.float() - want.float()).abs()
    return d.max().item(), bool((d <= tol + tol * want.float().abs()).all().item())


def k1_agree(got, want):
    """(max |err|, rms(err) / rms(want), whether K1's two limits hold);
    (B, L, H, D) outputs."""
    d = (got.float() - want.float()).abs()
    w = want.float()
    rel = (d.pow(2).mean().sqrt() / w.pow(2).mean().sqrt()).item()
    row = w.pow(2).mean(dim=(2, 3), keepdim=True).sqrt()
    ok = bool((d <= K1_ATOL * row + K1_RTOL * w.abs()).all().item()) and rel <= K1_RMS
    return d.max().item(), rel, ok


def call_ms(fn, arg_sets, reps: int) -> float:
    """Mean ms of one eager call as the caller sees it in a stream of calls:
    the wrapper's host work and the launch included. Taken for K2 only, whose
    device time is below the host cost of a launch."""
    import torch
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)])
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def device_ms(fn, arg_sets, reps: int) -> float:
    """Mean device ms of one call: ``reps`` calls captured in a CUDA graph and
    replayed, so no host work sits between the kernels."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in arg_sets[:2]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    torch.cuda.synchronize()
    del graph
    return e0.elapsed_time(e1) / reps


def shares(rec: dict) -> None:
    """A timed record's share of its bound and its ratio to the library call."""
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    rec["vs_library"] = rec["ms"] / rec["library_ms"] if rec["library_ms"] else None


def ptxas_report(_build, entry: str, params) -> list:
    """Registers, stack and spills of each instantiation of one kernel, from
    ``ptxas -v`` in the build's nvcc.log: ``entry`` matches the mangled name
    and its groups are the template arguments, named by ``params``."""
    lines = open(_build.build_dir() / "nvcc.log").read().splitlines()
    out = []
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '\S*" + entry, line)
        if not m:
            continue
        info = dict(zip(params, m.groups()))
        for nxt in lines[i + 1:i + 6]:
            for key, pat in (("registers", r"Used (\d+) registers"),
                             ("stack_bytes", r"(\d+) bytes stack frame"),
                             ("spill_store_bytes", r"(\d+) bytes spill stores"),
                             ("spill_load_bytes", r"(\d+) bytes spill loads")):
                hit = re.search(pat, nxt)
                if hit and key not in info:
                    info[key] = int(hit.group(1))
        out.append(info)
    if not out:
        raise RuntimeError(f"no ptxas report for {entry} in nvcc.log")
    return out


def k1_build_report(_build) -> str:
    """K1's registers, spills and shared memory per instantiation (head dim D,
    NC consumer warpgroups): the first two from ``ptxas -v``, the dynamic
    shared memory each launch asks for from the kernel's own layout."""
    smem = _build.function("repro_flash_attention_smem_bytes", [ctypes.c_int, ctypes.c_int])
    out = ptxas_report(_build, r"fa_fwd_kernelILi(\d+)ELi(\d+)E", ("D", "NC"))
    for info in out:
        info["D"], info["NC"] = int(info["D"]), int(info["NC"])
        info["dynamic_smem_bytes"] = smem(info["D"], info["NC"])
    if any(r["dynamic_smem_bytes"] == 0 for r in out):
        raise RuntimeError(f"K1's shared memory not reported: {out}")
    return json.dumps(sorted(out, key=lambda r: (r["D"], r["NC"])))


def k3_build_report(_build) -> str:
    """K3's registers and spills per instantiation: dtype x read x decay x R
    (rows of S per thread, which sets the slice: 8 R columns)."""
    out = ptxas_report(_build, r"ssm_scan_kernelI(f|13__nv_bfloat16)Lb([01])ELb([01])ELi(\d+)E",
                       ("dtype", "read", "decay", "rows"))
    for info in out:
        info["dtype"] = "float32" if info["dtype"] == "f" else "bfloat16"
        info["read"] = "strict" if info["read"] == "1" else "inclusive"
        info["decay"] = "per-token" if info["decay"] == "1" else "per-channel"
        info["rows"] = int(info["rows"])
    if len(out) != 24:
        raise RuntimeError(f"K3: {len(out)} instantiations in nvcc.log, expected 24")
    return json.dumps(sorted(out, key=lambda r: (r["dtype"], r["read"], r["decay"], r["rows"])))


def ring(make, nbytes: int) -> list:
    """Enough copies of one call's inputs to spill the 50 MB L2 between calls."""
    return [make() for _ in range(max(1, math.ceil(2 * L2_BYTES / nbytes)))]


def plain_by_heads(ref, q, k, v, mask=None, softcap=0.0):
    """The plain attention, eight heads at a time: its f32 scores are large."""
    import torch
    return torch.cat([ref.attention_ref(q[:, :, i:i + 8], k[:, :, i:i + 8], v[:, :, i:i + 8], mask,
                                        softcap)
                      for i in range(0, q.shape[2], 8)], dim=2)


def k1_calls(F, fa, ref, causal: bool, window: int, softcap: float, mask) -> tuple:
    """(kernel, plain, library) calls of one K1 shape on (B, L, H, D) tensors,
    each computing the shape's own function: its causal mask, window and
    softcap (``mask``: ``ops.attention_mask`` of the shape, or None). The
    library call is ``scaled_dot_product_attention``: causal where the mask is
    plain causal with Lq = Lkv, the boolean mask where a window cuts it; None
    where a softcap leaves no single PyTorch call computing the function."""
    def kernel(q, k, v):
        return fa.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)

    def plain(q, k, v):
        return plain_by_heads(ref, q, k, v, mask, softcap)

    if softcap > 0.0:
        return kernel, plain, None
    square = mask is None or mask.shape[0] == mask.shape[1]
    attn_mask = None if (window == 0 and square) else mask

    def library(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=attn_mask,
            is_causal=causal and attn_mask is None).transpose(1, 2)
    return kernel, plain, library


def k1_rows(lq: int, seed: int) -> list:
    """The query rows K1's check reads where the plain version cannot hold
    every row's scores: the first K1_BM-row tile, the K1_BM rows about a tile
    edge in the middle, the last (ragged) tile and K1_SUBSET_TILES tiles drawn
    from ``seed``. A query row's output depends on that row, every key and its
    own row of the mask alone, so the check is exact on the rows it reads,
    causal or not."""
    import random
    tiles = -(-lq // K1_BM)
    mid = tiles // 2 * K1_BM
    rows = set(range(min(K1_BM, lq))) | set(range(max(0, mid - K1_BM // 2),
                                                  min(lq, mid + K1_BM // 2)))
    rows |= set(range((tiles - 1) * K1_BM, lq))
    for t in random.Random(seed).sample(range(tiles), min(tiles, K1_SUBSET_TILES)):
        rows |= set(range(t * K1_BM, min(lq, (t + 1) * K1_BM)))
    return sorted(rows)


def k1_subset_agree(ref, got, q, k, v, rows, mask=None):
    """``k1_agree`` of K1's output ``got`` against the plain version on the
    query ``rows``, every key included: each kept row with its own row of the
    call's (Lq, Lkv) ``mask`` (None: no mask)."""
    return k1_agree(got[:, rows], plain_by_heads(ref, q[:, rows], k, v,
                                                 None if mask is None else mask[rows]))


def check_flash_attention(torch, ops, ref, fa, gen, records, main, ends):
    """``main``: (path, (B, Lq, Lkv, H, D, causal, window, softcap)) of every
    call shape the serve phases make (``serving_shapes``); ``ends``: those
    of Table 5's ends (``table5_end_shapes``). A shape whose plain scores
    would pass K1_PLAIN_BYTES is held on a subset of its query rows
    (``k1_rows``), and its plain time is taken on those rows."""
    import torch.nn.functional as F
    dev = "cuda"
    timed = {shape: path for path, shape in main}
    extra = []
    # the reference's kernel-test shapes (tests/test_kernels.py), head dim
    # raised to the kernel's 64/128
    for b, lq, lkv, h, d in [(2, 64, 64, 2, 32), (1, 100, 100, 3, 64), (2, 1, 128, 2, 32),
                             (1, 128, 128, 1, 128), (1, 17, 17, 2, 16)]:
        extra.append((b, lq, lkv, h, max(64, d), True, 0, 0.0))
    for window, cap, causal in [(48, 0.0, True), (0, 50.0, True), (16, 30.0, True),
                                (0, 0.0, False)]:
        extra.append((2, 96, 96, 2, 64, causal, window, cap))
    # what K1's tiling can get wrong: lengths on and beside its 128-row query
    # and 128-key tile edges, causal queries at the end of a longer kv
    # (q_offset > 0), a window across tile edges, causal D=128
    for n in (1, 127, 128, 129, 255, 257):
        extra += [(1, n, n, 4, 64, False, 0, 0.0), (1, n, n, 4, 128, True, 0, 0.0)]
    extra += [(1, 100, 300, 4, 64, True, 0, 0.0), (1, 1, 1810, 4, 128, True, 0, 0.0),
              (2, 300, 300, 2, 64, True, 130, 0.0), (1, 1810, 1810, 8, 128, True, 0, 0.0)]
    # D = 256 (gemma2), on 64-key tiles: lengths on and beside the tile edges,
    # causal and not; a window across tiles; gemma2's window with its softcap;
    # a softcap alone; causal queries at the end of a longer kv
    for n in (1, 63, 64, 65, 127, 129, 257):
        extra += [(1, n, n, 4, 256, causal, 0, 0.0) for causal in (True, False)]
    extra += [(2, 300, 300, 2, 256, True, 130, 0.0), (2, 300, 300, 2, 256, True, 48, 50.0),
              (1, 200, 200, 4, 256, True, 0, 30.0), (1, 100, 300, 4, 256, True, 0, 0.0),
              (1, 100, 300, 2, 256, True, 48, 50.0)]
    out = []
    for shape in list(dict.fromkeys(m[1] for m in main)) + extra:
        b, lq, lkv, h, d, causal, window, cap = shape

        def make():
            return tuple(torch.randn((b, n, h, d), generator=gen, device=dev).to(torch.bfloat16)
                         for n in (lq, lkv, lkv))
        q, k, v = make()
        mask = ops.attention_mask(lq, lkv, window, q.device) if (causal or window) else None
        o = fa.flash_attention(q, k, v, causal=causal, window=window, softcap=cap)
        torch.cuda.synchronize()
        if not torch.isfinite(o).all():
            raise RuntimeError(f"flash_attention: non-finite output at {(b, lq, lkv, h, d)}")
        rec = {"shape": [b, lq, lkv, h, d], "causal": causal, "window": window,
               "softcap": cap}
        rows = want = None
        if 4 * b * 8 * lq * lkv > K1_PLAIN_BYTES:
            if window or cap:
                raise RuntimeError(f"K1's row-subset check takes no window or softcap: {rec}")
            rows = k1_rows(lq, seed=lq)
            err, rel, ok = k1_subset_agree(ref, o, q, k, v, rows, mask)
            rec["checked_rows"] = len(rows)
        else:
            want = plain_by_heads(ref, q, k, v, mask, cap)   # per head group: large f32 scores
            err, rel, ok = k1_agree(o, want)
        rec.update(max_abs_err=err, rms_rel_err=rel)
        if not ok:
            raise RuntimeError(f"flash_attention disagrees with its plain version: {rec}")
        if lq in K1_FAULT_SHOWN and not causal:
            # what a kernel that let the ragged tile's zero padding in would give
            pad = -lkv % K1_BN
            padded = [torch.cat([t, t.new_zeros((b, pad, h, d))], 1) for t in (k, v)]
            _, fault_rel, fault_ok = k1_agree(plain_by_heads(ref, q, *padded), want)
            rec["padded_key_fault_rms_rel_err"] = fault_rel
            if fault_ok:
                raise RuntimeError(f"K1's check cannot see the padded-key fault: {rec}")
        flops, nbytes = fa.cost(q, k, v, causal=causal, window=window)
        rec["bound_ms"], rec["bound_by"] = roofline.kernel_bound_ms(fa, (flops, nbytes))
        del o, want
        if shape in timed:
            sets = ring(make, nbytes) if rows is None else [(q, k, v)]
            reps = K1_LONG_REPS if flops > K1_LONG_FLOPS else 20
            kernel, plain, library = k1_calls(F, fa, ref, causal, window, cap, mask)
            rec["ms"] = device_ms(kernel, sets, reps)
            if rows is None:
                rec["plain_ms"] = device_ms(plain, sets[:1], 3)
            else:
                # the plain version on the checked rows alone: no whole-shape time
                rec["plain_ms"] = None
                sub = (q[:, rows].contiguous(), k, v)
                rows_mask = None if mask is None else mask[rows]
                rec["plain_rows_ms"] = device_ms(
                    lambda q, k, v: plain_by_heads(ref, q, k, v, rows_mask, cap), [sub], 1)
                del sub
            rec["library_ms"] = device_ms(library, sets, reps) if library else None
            rec["main_path"] = timed[shape]
            rec["table5_end"] = shape in ends
            shares(rec)
            del sets
        print("K1 flash_attention " + json.dumps(rec), flush=True)
        out.append(rec)
        del q, k, v
        torch.cuda.empty_cache()
    records["flash_attention"] = out


def k2_check_shapes(main) -> list:
    """(B, L, D, dtype) of every K2 check: each served (B, L, D) in bf16 (the
    timed ones) and in float32, where K2's 1e-5 limit sees a sum of squares
    that drops a lane's or a vector's share; K2_BATCHED in both; and the
    reference's kernel-test shapes."""
    import torch
    served = list(dict.fromkeys(shape for _, shape in main))
    shapes = [s + (torch.bfloat16,) for s in served] + [s + (torch.float32,) for s in served]
    shapes += [(b, l, d, dt) for b, l, d in K2_BATCHED for dt in (torch.float32, torch.bfloat16)]
    shapes += [(b, l, d, dt) for b, l, d in [(2, 100, 64), (1, 7, 128), (4, 256, 32)]
               for dt in (torch.float32, torch.bfloat16)]
    return shapes


def check_adaln_rmsnorm(torch, ref, ar, gen, records, main, ends):
    """``main``: (path, (B, L, D)) of every call shape the serve phases make;
    ``ends``: those of Table 5's ends (``table5_end_shapes``)."""
    dev = "cuda"
    out = []
    timed = {shape: path for path, shape in main}
    for b, l, d, dt in k2_check_shapes(main):
        def make():
            x = torch.randn((b, l, d), generator=gen, device=dev).to(dt)
            # scale/shift as the DiT passes them: rows of a (B, 6, D) modulation
            mod = (torch.randn((b, 6, d), generator=gen, device=dev) * 0.1).to(dt)
            return x, mod[:, 0], mod[:, 1]
        x, s, t = make()
        y = ar.adaln_rmsnorm(x, s, t)
        torch.cuda.synchronize()
        want = ref.adaln_rmsnorm_ref(x, s, t)
        name = str(dt).split(".")[-1]
        err, ok = agree(y, want, K2_TOL[name])
        rec = {"shape": [b, l, d], "dtype": name, "max_abs_err": err, "tol": K2_TOL[name],
               "plan": ar.plan(b, l, d, dt)}
        if not torch.isfinite(y).all() or not ok:
            raise RuntimeError(f"adaln_rmsnorm disagrees with its plain version: {rec}")
        cost = ar.cost(x, s, t)
        nbytes = cost[1]
        rec["bound_ms"], rec["bound_by"] = roofline.kernel_bound_ms(ar, cost)
        if (b, l, d) in timed and dt == torch.bfloat16:
            sets = ring(make, nbytes)
            rec["ms"] = device_ms(ar.adaln_rmsnorm, sets, 50)
            rec["call_ms"] = call_ms(ar.adaln_rmsnorm, sets, 50)
            rec["plain_ms"] = device_ms(ref.adaln_rmsnorm_ref, sets, 20)
            rec["library_ms"] = None       # no single PyTorch call computes it
            rec["main_path"] = timed[(b, l, d)]
            rec["table5_end"] = (b, l, d) in ends
            shares(rec)
        print("K2 adaln_rmsnorm " + json.dumps(rec), flush=True)
        out.append(rec)
    records["adaln_rmsnorm"] = out


def k2_build_report(_build) -> str:
    """K2's registers and spills per instantiation: dtype x V (16-byte vectors
    per lane)."""
    out = ptxas_report(_build, r"adaln_rmsnorm_kernelI(f|13__nv_bfloat16)Li(\d+)E",
                       ("dtype", "vectors"))
    for info in out:
        info["dtype"] = "float32" if info["dtype"] == "f" else "bfloat16"
        info["vectors"] = int(info["vectors"])
    if len(out) != 16:
        raise RuntimeError(f"K2: {len(out)} instantiations in nvcc.log, expected 16")
    return json.dumps(sorted(out, key=lambda r: (r["dtype"], r["vectors"])))


def llm_k1_shapes(cfg, lengths) -> list:
    """K1's (B, Lq, Lkv, H, D, causal, window, softcap) shapes in one LLM's
    prefill: per group of LLM_BATCH prompts padded to ``lengths`` (a vision
    prefix included), one per kind of attention layer the model has (a
    local layer's with its window; a chunked layer's one per distinct chunk
    length: the full chunk and the ragged tail), its KV heads repeated to
    the query heads."""
    kinds = dict.fromkeys(m for m, _ in cfg.layer_kinds()
                          if m in ("attn", "attn_local", "attn_chunked"))
    out = []
    for l in lengths:
        for m in kinds:
            if m == "attn_chunked":
                c = cfg.chunk_size
                calls = dict.fromkeys(min(c, l - j) for j in range(0, l, c))
            else:
                calls = (l,)
            out += [(LLM_BATCH, n, n, cfg.num_heads, cfg.resolved_head_dim, True,
                     cfg.window_size if m == "attn_local" else 0, cfg.attn_softcap)
                    for n in calls]
    return out


def serving_shapes(C, llm_groups) -> tuple:
    """(path, shape) of every call the serve phases make: K1's (B, Lq, Lkv, H,
    D, causal, window, softcap) and K2's (B, L, D). Each request's DiT runs
    over its latent tokens plus the prompt's; hunyuanvideo's encoder runs K1
    causally over the prompt, its KV heads repeated to the 32 query heads;
    each LLM's prefill runs it over each group of LLM_BATCH prompts
    (``llm_groups``: the padded length of each group, by arch). The DiT
    shapes of quickstart.HEAVY come last, on the path ``<pipeline> heavy``."""
    from repro_torch.launch import quickstart
    k1, k2 = [], []
    for name in PIPELINES:
        cfg = C.get(name)
        for res, sec in quickstart.REQUESTS[name]:
            k1.append((name, dit_k1_shape(cfg, res, sec)))
            k2.append((name, dit_k2_shape(cfg, res, sec)))
        enc = cfg.encoder
        if "attn:dense" in enc.layer_pattern:
            k1.append((name, (1, COND_LEN, COND_LEN, enc.num_heads, enc.resolved_head_dim,
                              True, 0, 0.0)))
    for arch, lengths in llm_groups.items():
        k1 += [(arch, shape) for shape in llm_k1_shapes(llm_config(C, arch), lengths)]
    for name in PIPELINES:
        cfg = C.get(name)
        for res, sec in quickstart.HEAVY[name]:
            k1.append((f"{name} heavy", dit_k1_shape(cfg, res, sec)))
            k2.append((f"{name} heavy", dit_k2_shape(cfg, res, sec)))
    return k1, k2


def dit_k1_shape(cfg, res: int, sec: float) -> tuple:
    """K1's shape in the DiT of one (res, sec) request: non-causal over its
    latent tokens and the prompt's."""
    h = cfg.dit.num_heads
    l = cfg.latent_tokens(res, sec) + COND_LEN
    return (1, l, l, h, cfg.dit.d_model // h, False, 0, 0.0)


def dit_k2_shape(cfg, res: int, sec: float) -> tuple:
    return (1, cfg.latent_tokens(res, sec) + COND_LEN, cfg.dit.d_model)


def table5_end_shapes(C) -> tuple:
    """The K1 and K2 shapes of the classes at Table 5's ends (LIGHT_END and
    quickstart.HEAVY), which the kernels first ran when every class came to
    be served; the kernel line sums them apart."""
    from repro_torch.launch import quickstart
    classes = list(LIGHT_END) + [(name, res, sec) for name in PIPELINES
                                 for res, sec in quickstart.HEAVY[name]]
    return ({dit_k1_shape(C.get(n), r, s) for n, r, s in classes},
            {dit_k2_shape(C.get(n), r, s) for n, r, s in classes})


def serve_launches(cfg, classes, num_steps=None) -> dict:
    """Each kernel's launches when ``classes`` are served one request each,
    every DDIM loop cut to ``num_steps`` where given: per request and step
    one K1 per DiT block and one K2 per block's two norms plus the final
    one; per request one K1 per layer of a causal encoder."""
    steps = len(classes) * (num_steps or cfg.num_steps)
    enc = cfg.encoder.num_layers if "attn:dense" in cfg.encoder.layer_pattern else 0
    layers = cfg.dit.num_layers
    return {"flash_attention": layers * steps + enc * len(classes),
            "adaln_rmsnorm": (2 * layers + 1) * steps, "ssm_scan": 0}


def fill_modulation(torch, pipe, seed: int) -> None:
    """AdaLN-Zero starts every block as the identity, which would hide the
    attention's output from the image: give mod/final_mod small values."""
    g = torch.Generator(device=pipe.dit.x_in.device).manual_seed(seed)
    with torch.no_grad():
        for w in [layer.mod for layer in pipe.dit.layers] + [pipe.dit.final_mod]:
            w.copy_(torch.randn(w.shape, generator=g, device=w.device) * 0.02)


def check_cut(torch, C, pl, name: str):
    """A two-layer cut of pipeline ``name`` at full width: card (bf16,
    kernels) vs CPU (float32, plain versions), same weights. It compares the
    encoder's output for one prompt, and one DiT forward's output (the
    predicted noise) for the same latents (a CUT_RES px image, or one second
    of video), timestep and conditioning on both sides."""
    import dataclasses
    full = C.get(name)
    cfg = dataclasses.replace(
        full, encoder=dataclasses.replace(full.encoder, num_layers=2),
        dit=dataclasses.replace(full.dit, num_layers=2))
    gpu = pl.build(cfg, "cuda", seed=1)
    fill_modulation(torch, gpu, seed=2)
    cpu = pl.Pipeline(dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, dtype=torch.float32),
        dit=dataclasses.replace(cfg.dit, dtype=torch.float32),
        decoder=dataclasses.replace(cfg.decoder, dtype=torch.float32)), "cpu").eval()
    with torch.no_grad():
        for pc, pg in zip(cpu.parameters(), gpu.parameters()):
            pc.copy_(pg.float().cpu())
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.encoder.vocab_size, (1, COND_LEN), generator=g)
    latents = torch.randn((1, cfg.latent_tokens(CUT_RES, 1.0), cfg.dit.latent_dim),
                          generator=g)
    t = torch.tensor([500.0])
    with torch.no_grad():
        want_c = pl.encode(cpu, toks)
        got_c = pl.encode(gpu, toks.cuda()).float().cpu()
        want_e = cpu.dit(latents, t, want_c)
        got_e = gpu.dit(latents.cuda(), t.cuda(), want_c.cuda()).float().cpu()
    out = {"encode_max_rel": ((got_c - want_c).abs().max() / want_c.abs().max()).item(),
           "dit_eps_rms_rel": ((got_e - want_e).pow(2).mean().sqrt()
                               / want_e.pow(2).mean().sqrt()).item()}
    out["dit_tokens"] = latents.shape[1] + COND_LEN
    for key, tol in (("encode_max_rel", ENC_TOL), ("dit_eps_rms_rel", EPS_TOL)):
        if not math.isfinite(out[key]) or out[key] > tol:
            raise RuntimeError(f"two-layer {name} cut, card vs CPU: {key} = {out[key]:.3g} "
                               f"above {tol}")
    del gpu, cpu
    torch.cuda.empty_cache()
    return out


def serve_pipeline_phase(torch, C, pl, ops, quickstart, Request, name: str, tag: str):
    """Build pipeline ``name`` on the card from a seed, fill its modulation,
    run each served shape once untimed, then serve its requests
    (quickstart.REQUESTS) counting the kernels' launches; where the pipeline
    has heavy classes, serve them on the same pipeline (``heavy_phase``)
    before it is freed. Returns the launches by path and one stage-time
    reading per request and stage."""
    cfg = C.get(name)
    t0 = time.perf_counter()
    pipe = pl.build(cfg, "cuda", seed=0)
    fill_modulation(torch, pipe, seed=1)
    reqs = [Request(name, res, sec) for res, sec in quickstart.REQUESTS[name]]
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    quickstart.warm(pipe, reqs)
    print(f"[{tag}] {name} built on the card ({sum(p.numel() for p in pipe.parameters())} "
          f"params) in {built:.1f} s, warmed at every served shape in "
          f"{time.perf_counter() - t0 - built:.1f} s", flush=True)
    launches, readings = serve_checked(torch, ops, quickstart, Request, cfg, pipe,
                                       quickstart.REQUESTS[name], tag)
    by_path = {name: launches}
    print(f"[{tag}] {name} phase: {time.perf_counter() - t0:.1f} s", flush=True)
    if quickstart.HEAVY[name]:
        by_path[f"{name} heavy"], got = heavy_phase(torch, ops, quickstart, Request, cfg, pipe)
        readings += got
    del pipe
    torch.cuda.empty_cache()
    return by_path, readings


def serve_checked(torch, ops, quickstart, Request, cfg, pipe, classes, tag: str,
                  num_steps=None):
    """Serve one request of each of ``classes`` through quickstart.serve,
    each DDIM loop cut to ``num_steps`` where given, counting the kernels'
    launches; check each output (shape (F, 16h, 16w, 3), finite, pixels in
    [-1, 1]) and the launches (``serve_launches``). Returns the launches and
    one reading per request and stage."""
    name = cfg.name
    reqs = [Request(name, res, sec) for res, sec in classes]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    recs = quickstart.serve(cfg, reqs, device="cuda", pipe=pipe, num_steps=num_steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    want = serve_launches(cfg, classes, num_steps)
    for rec in recs:
        out = rec["output"]
        res, sec = rec["resolution"], rec["seconds"]
        f, h, w = cfg.latent_grid(res, sec)
        shape = (f, 16 * h, 16 * w, 3)
        if tuple(out.shape) != shape or not torch.isfinite(out).all():
            raise RuntimeError(f"{name} request {res}px {sec}s: output {tuple(out.shape)} "
                               f"not finite of shape {shape}")
        if out.abs().max().item() > 1.0:
            raise RuntimeError(f"{name} request {res}px {sec}s: pixels outside [-1, 1]")
        steps = rec["num_steps"]
        ms, model = rec["stage_ms"], rec["predicted_ms"]
        print(f"[{tag}] {name} {res}px {sec:g}s L={cfg.latent_tokens(res, sec) + COND_LEN} "
              f"steps={steps} out={tuple(out.shape)} finite "
              f"mean={out.float().mean().item():.4f} std={out.float().std().item():.4f} "
              f"E: {ms['E']:.1f} ms (model {model['E']:.1f}) D: {ms['D']:.1f} ms "
              f"(model {model['D']:.1f}), {ms['D'] / steps:.1f} ms a step, measured / model "
              f"{ms['D'] / model['D']:.3f} C: {ms['C']:.1f} ms (model {model['C']:.1f}) "
              f"decision={rec['decision']}", flush=True)
    print(f"[{tag}] {name} served {len(recs)} requests in {wall:.2f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB, launches {launches}",
          flush=True)
    if launches != want:
        raise RuntimeError(f"{name}: kernel launches {launches}, expected {want}")
    readings = [{"pipeline": name, "resolution": rec["resolution"], "seconds": rec["seconds"],
                 "num_steps": rec["num_steps"], "stage": s, "ms": rec["stage_ms"][s]}
                for rec in recs for s in "EDC"]
    return launches, readings


def heavy_phase(torch, ops, quickstart, Request, cfg, pipe):
    """Phase 5d on a built pipeline: each class of quickstart.HEAVY once
    untimed at one DDIM step (``quickstart.warm``), then served with its loop
    cut to one step, then WHOLE_HEAVY's class served with all its steps.
    Returns the launches of both serves and their readings."""
    name = cfg.name
    t0 = time.perf_counter()
    heavy = quickstart.HEAVY[name]
    quickstart.warm(pipe, [Request(name, res, sec) for res, sec in heavy])
    print(f"[5d] {name} warmed at its {len(heavy)} heavy classes in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    one, readings = serve_checked(torch, ops, quickstart, Request, cfg, pipe, heavy, "5d",
                                  num_steps=1)
    whole, got = serve_checked(torch, ops, quickstart, Request, cfg, pipe,
                               (WHOLE_HEAVY[name],), "5d")
    print(f"[5d] {name} heavy phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return {k: one[k] + whole[k] for k in one}, readings + got


def llm_config(C, arch: str):
    """The config phases 3 and 8-8c serve: llama4 cut to LLAMA4_LAYERS
    layers, every other LLM whole."""
    import dataclasses
    cfg = C.get(arch)
    return dataclasses.replace(cfg, num_layers=LLAMA4_LAYERS) if arch == LLAMA4 else cfg


def llm_requests(serve_llm, cfg):
    """Phase 8's requests: chat and RAG prompts of 256..2048 tokens, drawn from
    a seed; phase 8b's (LONG_ARCHS) long-document prompts of 4352..6144;
    phase 8c's: llama4's of LLAMA4_PROMPTS tokens, internvl2's text prompts of
    256..2048 tokens behind 256 stub patch embeddings, musicgen's delayed
    (4, L) codec prompts of MUSICGEN_FRAMES frames."""
    import numpy as np
    from repro_torch.launch import serve_musicgen, serve_vlm
    if cfg.name == LLAMA4:
        rng = np.random.default_rng(0)
        return [serve_llm.GenRequest(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=n),
                                     max_new=LLM_MAX_NEW)
                for i, n in enumerate(LLAMA4_PROMPTS)]
    if cfg.modality == "vision":
        return serve_vlm.requests_from_seed(cfg, LLM_REQUESTS, LLM_LENGTHS, LLM_MAX_NEW)
    if cfg.modality == "audio_codec":
        return serve_musicgen.requests_from_seed(cfg, LLM_REQUESTS, MUSICGEN_FRAMES, LLM_MAX_NEW)
    lengths = LONG_LENGTHS if cfg.name in LONG_ARCHS else LLM_LENGTHS
    return serve_llm.requests_from_seed(cfg.vocab_size, LLM_REQUESTS, lengths, LLM_MAX_NEW)


def group_lengths(reqs) -> list:
    """The padded length of each ServeEngine group as the model sees it: its
    longest prompt, behind its vision prefix where it has one."""
    return [max(r.prompt.shape[-1] for r in reqs[i:i + LLM_BATCH])
            + (0 if reqs[i].prefix is None else reqs[i].prefix.shape[0])
            for i in range(0, len(reqs), LLM_BATCH)]


def scan_inputs(torch, gen, b, h, l, dk, dv, *, bonus, layout, dtype, floor=False,
                state=False):
    """K3's inputs in one of four layouts: "per-head" (rwkv6: every input per
    head); "zamba2" (as Mamba2 passes them, models/ssm.py: q and k shared
    across heads as stride-0 views, the decay per head and broadcast over K);
    "shared" (q, k and the decay all shared across heads); "transposed"
    (every input per head with a last stride other than 1, which the
    kernel's 16-byte staging cannot take)."""
    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    hq = h if layout in ("per-head", "transposed") else 1
    if layout == "transposed":
        q, k = (rn(b, h, dk, l).to(dtype).transpose(2, 3) for _ in range(2))
        v = rn(b, h, dv, l).to(dtype).transpose(2, 3)
    else:
        q, k = (rn(b, hq, l, dk).to(dtype).expand(b, h, l, dk) for _ in range(2))
        v = rn(b, h, l, dv).to(dtype)
    if floor:
        decay = torch.full((b, h, l, dk), math.exp(-5.4), device="cuda")
    elif layout == "transposed":
        decay = torch.exp(-torch.exp(rn(b, h, dk, l))).transpose(2, 3)
    else:
        decay = torch.exp(-torch.exp(rn(b, 1 if layout == "shared" else h, l,
                                        dk if layout == "per-head" else 1)))
    return (q, k, v, decay.expand(b, h, l, dk), rn(h, dk) if bonus else None,
            rn(b, h, dk, dv) if state else None)


def scan_agree(got, want):
    """(max |err| of the output, of the state, whether K3's limits hold)."""
    errs, ok = [], True
    for g, w in zip(got, want):
        d = (g.float() - w.float()).abs()
        rms = w.float().pow(2).mean().sqrt()
        rel = K3_REL[str(g.dtype).split(".")[-1]]
        ok &= bool((d <= K3_RMS * rms + rel * w.float().abs()).all().item())
        errs.append(d.max().item())
    return errs[0], errs[1], ok


def check_ssm_scan(torch, ref, ss, gen, records, serving_shapes):
    """``serving_shapes``: (path, B, L, H, bonus, layout) of every call phase 8
    makes: rwkv6's (B, 40, L, 64, 64) with the bonus, every input per head;
    zamba2's (B, 64, L, 64, 64) without it, q and k shared across heads and
    the decay per head (``scan_inputs``)."""
    main = [(path, (b, h, l, 64, 64, bonus, layout, torch.bfloat16, False))
            for path, b, l, h, bonus, layout in serving_shapes]
    timed = {shape: path for path, shape in main}
    # the reference's kernel-test shapes (tests/test_kernels.py), f32, with an
    # initial state; then the decay floor at L >= 64
    extra = [(b, h, l, dk, dv, bonus, "per-head", torch.float32, False)
             for b, h, l, dk, dv, bonus in [(2, 2, 100, 16, 32, False), (1, 3, 64, 32, 32, True),
                                            (2, 1, 33, 8, 8, True), (1, 2, 16, 64, 64, False),
                                            (1, 1, 7, 4, 4, True)]]
    # enough blocks for the kernel's narrower slices, with V = 40 ragged in them
    extra += [(8, 64, 70, 64, 40, True, "per-head", torch.float32, False)]
    extra += [(2, 3, 5 * ss.CHUNK + 7, 64, 64, bonus, "per-head", torch.bfloat16, True)
              for bonus in (False, True)]
    # q, k and the decay all shared across heads; rwkv6's heads on and beside
    # the edges of a chunk and of the ring of staged chunks; a layout that
    # takes the element-wise staging path
    extra += [(LLM_BATCH, 64, 854, 64, 64, False, "shared", torch.bfloat16, False)]
    extra += [(1, 40, l, 64, 64, True, "per-head", torch.bfloat16, False)
              for l in (ss.CHUNK - 1, ss.CHUNK, ss.CHUNK + 1, ss.STAGES * ss.CHUNK,
                        ss.STAGES * ss.CHUNK + 1)]
    extra += [(2, 4, 100, 64, 64, bonus, "transposed", torch.bfloat16, False)
              for bonus in (False, True)]
    out = []
    for shape in [m[1] for m in main] + extra:
        b, h, l, dk, dv, bonus, layout, dtype, floor = shape

        def make():
            return scan_inputs(torch, gen, b, h, l, dk, dv, bonus=bonus, layout=layout,
                               dtype=dtype, floor=floor, state=dtype == torch.float32)
        q, k, v, decay, u, s0 = make()
        got = ss.ssm_scan(q, k, v, decay, bonus=u, initial_state=s0)
        torch.cuda.synchronize()
        if not all(torch.isfinite(t).all() for t in got):
            raise RuntimeError(f"ssm_scan: non-finite output at {shape}")
        err, state_err, ok = scan_agree(got, ref.ssm_scan_ref(q, k, v, decay, u, s0))
        rec = {"shape": [b, h, l, dk, dv], "bonus": bonus, "layout": layout,
               "dtype": str(dtype).split(".")[-1], "floor": floor, "max_abs_err": err,
               "state_max_abs_err": state_err, "plan": ss.plan(q, k, v, decay)}
        if not ok:
            raise RuntimeError(f"ssm_scan disagrees with its plain version: {rec}")
        if floor:
            # cut where no staging chunk ends and carry the state: the same bits
            cut = ss.CHUNK + 5
            first = ss.ssm_scan(*(t[:, :, :cut] for t in (q, k, v, decay)), bonus=u)
            rest = ss.ssm_scan(*(t[:, :, cut:] for t in (q, k, v, decay)), bonus=u,
                               initial_state=first[1])
            if not (torch.equal(torch.cat([first[0], rest[0]], 2), got[0])
                    and torch.equal(rest[1], got[1])):
                raise RuntimeError(f"ssm_scan depends on where the sequence is cut: {rec}")
        cost = ss.cost(q, k, v, decay, bonus=u, initial_state=s0)
        nbytes = cost[1]
        rec["bound_ms"], rec["bound_by"] = roofline.kernel_bound_ms(ss, cost)
        if shape in timed:
            sets = ring(lambda: make()[:5], nbytes)

            def kernel(q, k, v, decay, u):
                return ss.ssm_scan(q, k, v, decay, bonus=u)

            def plain(q, k, v, decay, u):
                return ref.ssm_scan_ref(q, k, v, decay, u)

            rec["ms"] = device_ms(kernel, sets, 10)
            rec["plain_ms"] = device_ms(plain, sets[:1], 1)
            rec["library_ms"] = None       # no single PyTorch call computes the scan
            rec["main_path"] = timed[shape]
            shares(rec)
        print("K3 ssm_scan " + json.dumps(rec), flush=True)
        out.append(rec)
        del q, k, v, decay, got
        torch.cuda.empty_cache()
    records["ssm_scan"] = out


def llm_cut_config(C, arch: str):
    """Phase 7's cut at full width: zamba2-1.2b's 6-layer cycle (5 Mamba2
    layers, then attention), so K1 and K3 both run; llama4's dense half (a
    chunked and the global layer, both dense; its MoE layer has its own cut,
    ``check_moe_cut``); every other LLM's first 2 layers (gemma2's local and
    global one, deepseek-moe's dense and first MoE one); a window or chunk
    cut to CUT_WINDOW."""
    import dataclasses
    cfg = C.get(arch)
    cut = dataclasses.replace(cfg, num_layers=6 if arch == "zamba2-1.2b" else 2)
    if arch == LLAMA4:
        cut = dataclasses.replace(cut, layer_pattern=("attn_chunked:dense", "attn:dense"),
                                  chunk_size=CUT_WINDOW)
    if any(m == "attn_local" for m, _ in cfg.layer_kinds()):
        cut = dataclasses.replace(cut, window_size=CUT_WINDOW)
    return cut


def llm_cut_inputs(torch, cfg):
    """A CUT_PROMPT-token prompt per row (no multiple of any chunk or tile),
    and the tokens of CUT_DECODE decode steps. An audio model's prompt is
    delayed (B, K, CUT_PROMPT) codes, its steps (B, K, 1) frames."""
    from repro_torch.models import audio
    g = torch.Generator().manual_seed(7)
    k = (cfg.num_codebooks,) if cfg.modality == "audio_codec" else ()
    prompt = torch.randint(0, cfg.vocab_size, (CUT_BATCH,) + k + (CUT_PROMPT,), generator=g)
    steps = torch.randint(0, cfg.vocab_size, (CUT_DECODE, CUT_BATCH) + k + (1,), generator=g)
    if k:
        prompt = audio.apply_delay_pattern(prompt)
    return prompt, steps


def llm_cut_prefix(torch, cfg):
    """A vision model's prefix of stub patch embeddings for the cut (None
    for the others)."""
    from repro_torch.models import vlm
    if cfg.modality != "vision":
        return None
    return vlm.vision_stub_embeds(cfg, CUT_BATCH, torch.Generator().manual_seed(8))


def llm_cut_readout(torch, model, prompt, steps, prefix=None) -> dict:
    """One model's last-token logits, every layer's SSM state and K/V ring
    cache after the prompt (where it has such layers), and logits after the
    decode steps, as float32 on the CPU."""
    dev = model.embed.device
    tv = 0 if prefix is None else prefix.shape[1]
    logits, caches, offset = model.prefill(prompt.to(dev), tv + CUT_PROMPT + CUT_DECODE,
                                           None if prefix is None else prefix.to(dev))
    out = {"logits": logits.float().cpu()}
    for key, parts in (("ssm_state", ("ssm",)), ("kv_cache", ("k", "v"))):
        held = [c[p].flatten() for c in caches for p in parts if p in c]
        if held:
            out[key] = torch.cat(held).float().cpu()
    for i, tok in enumerate(steps):
        dec, caches = model.decode_step(tok.to(dev), caches, offset + i)
    out["decode_logits"] = dec.float().cpu()
    return out


def rms_rel(got, want) -> float:
    return ((got - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt()).item()


def copy_params(torch, dst, src) -> None:
    """Copy ``src``'s parameters into ``dst``'s (another device and dtype),
    slice by slice along dim 0 for a large one, so that no whole float32
    copy of an expert stack is made on either side."""
    with torch.no_grad():
        for pd, ps in zip(dst.parameters(), src.parameters()):
            step = max(1, (2 ** 28) // max(1, ps[0].numel())) if ps.dim() else 1
            if ps.dim() == 0 or ps.shape[0] <= step:
                pd.copy_(ps.to(pd.dtype).to(pd.device))
                continue
            for i in range(0, ps.shape[0], step):
                pd[i:i + step].copy_(ps[i:i + step].to(pd.dtype).to(pd.device))


def check_llm_cut(torch, C, tf, arch: str) -> dict:
    """The cut on the card (bf16, kernels) against the same weights on the
    CPU (float32, plain versions)."""
    import dataclasses
    cfg = llm_cut_config(C, arch)
    gpu = tf.build(cfg, "cuda", seed=11)
    cpu = tf.Transformer(dataclasses.replace(cfg, dtype=torch.float32), "cpu").eval()
    copy_params(torch, cpu, gpu)
    prompt, steps = llm_cut_inputs(torch, cfg)
    prefix = llm_cut_prefix(torch, cfg)
    want = llm_cut_readout(torch, cpu, prompt, steps, prefix)
    got = llm_cut_readout(torch, gpu, prompt, steps, prefix)
    out = {k: rms_rel(got[k], want[k]) for k in want}
    for k in out:
        tol = LLM_CUT_TOL[k]
        if not math.isfinite(out[k]) or out[k] > tol:
            raise RuntimeError(f"{arch} cut, card vs CPU: {k} = {out[k]:.3g} above {tol}")
    del gpu, cpu
    torch.cuda.empty_cache()
    return out


def expected_launches(cfg, lengths) -> dict:
    """Each kernel's launches when prefill groups of the padded ``lengths``
    (``group_lengths``) run through the model: K1 once per full or local
    attention layer and once per chunk of a chunked one, K3 once per SSM
    layer; decode runs neither."""
    kinds = [m for m, _ in cfg.layer_kinds()]
    per_group = [kinds.count("attn") + kinds.count("attn_local")
                 + kinds.count("attn_chunked") * -(-l // cfg.chunk_size) for l in lengths]
    return {"flash_attention": sum(per_group), "adaln_rmsnorm": 0,
            "ssm_scan": (kinds.count("mamba2") + kinds.count("rwkv6")) * len(lengths)}


def routes(moe, fn):
    """Run ``fn()`` with ``moe.route`` recording each call's (expert index,
    kept) on the CPU -> (fn's result, the records)."""
    seen = []
    real = moe.route

    def recorded(cfg, router, xg):
        out = real(cfg, router, xg)
        seen.append((out[1].cpu(), out[4].cpu()))
        return out
    moe.route = recorded
    try:
        return fn(), seen
    finally:
        moe.route = real


def topk_differ(got, want) -> tuple:
    """Per token of MoE calls recorded on two sides (``routes``): (its set of
    experts differs in some call, its experts are the same but one of them
    kept it on one side and dropped it on the other), flat boolean tensors
    in token order."""
    expert = kept = False
    for (gi, gk), (wi, wk) in zip(got, want):
        gi, go = gi.sort(-1)
        wi, wo = wi.sort(-1)
        expert = expert | (gi != wi).any(-1).reshape(-1)
        kept = kept | (gk.gather(-1, go) != wk.gather(-1, wo)).any(-1).reshape(-1)
    return expert, kept & ~expert


def moe_cut_config(C):
    """Phase 7's llama4 MoE cut: one ``attn_chunked:moe`` layer at full width
    with all 128 experts and the shared expert, its chunk cut to CUT_WINDOW."""
    import dataclasses
    return dataclasses.replace(C.get(LLAMA4), num_layers=1, layer_pattern=("attn_chunked:moe",),
                               chunk_size=CUT_WINDOW)


def host_available_bytes() -> int:
    """MemAvailable of /proc/meminfo."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def check_moe_cut(torch, C, tf, moe) -> dict:
    """llama4's MoE layer on the card (bf16, kernels) against the same
    weights on the CPU (float32 where the host has room for its 64.4 GB, else
    bf16), both fed the same bf16 hidden states: the layer's increment
    (output - input) at every token whose expert and kept status agree, by
    rms(err) / rms(ref); tokens whose expert differs must be at most
    MOE_FLIP_LIMIT of them."""
    import dataclasses
    cfg = moe_cut_config(C)
    gpu = tf.AttentionLayer(cfg, "attn_chunked", "cuda", ffn="moe")
    gpu.init_(torch.Generator(device="cuda").manual_seed(12))
    f32_bytes = 4 * sum(p.numel() for p in gpu.parameters())
    avail = host_available_bytes()
    cpu_dtype = torch.float32 if avail > 1.25 * f32_bytes else torch.bfloat16
    print(f"[7] llama4 MoE cut: {f32_bytes / 1e9:.1f} GB in float32, host has "
          f"{avail / 1e9:.1f} GB available: CPU side in {str(cpu_dtype).split('.')[-1]}",
          flush=True)
    cpu = tf.AttentionLayer(dataclasses.replace(cfg, dtype=cpu_dtype), "attn_chunked", "cpu",
                            ffn="moe")
    copy_params(torch, cpu, gpu)
    g = torch.Generator().manual_seed(13)
    x = torch.randn((CUT_BATCH, CUT_PROMPT, cfg.d_model), generator=g).to(torch.bfloat16)
    pos = torch.arange(CUT_PROMPT, dtype=torch.int32)[None].expand(CUT_BATCH, CUT_PROMPT)
    with torch.no_grad():
        want, want_r = routes(moe, lambda: cpu.prefill(
            x.to(cpu_dtype), pos, cpu.init_cache(CUT_BATCH, CUT_PROMPT, "cpu"))[0].float())
        got, got_r = routes(moe, lambda: gpu.prefill(
            x.to(cfg.dtype).cuda(), pos.cuda(),
            gpu.init_cache(CUT_BATCH, CUT_PROMPT, "cuda"))[0].float().cpu())
    expert, kept = topk_differ(got_r, want_r)
    same = ~(expert | kept)
    inc_got = (got - x.float()).reshape(-1, cfg.d_model)[same]
    inc_want = (want - x.float()).reshape(-1, cfg.d_model)[same]
    out = {"cpu_dtype": str(cpu_dtype).split(".")[-1], "tokens": int(expert.numel()),
           "expert_differs": int(expert.sum()), "kept_differs": int(kept.sum()),
           "increment": rms_rel(inc_got, inc_want)}
    del gpu, cpu
    gc.collect()
    torch.cuda.empty_cache()
    if not torch.isfinite(got).all() or out["expert_differs"] > MOE_FLIP_LIMIT * out["tokens"]:
        raise RuntimeError(f"llama4 MoE cut: {out}, more than {MOE_FLIP_LIMIT:.0%} of the "
                           "tokens changed expert, or non-finite")
    if not math.isfinite(out["increment"]) or out["increment"] > LLM_CUT_TOL["logits"]:
        raise RuntimeError(f"llama4 MoE cut, card vs CPU: {out} above {LLM_CUT_TOL['logits']}")
    return out


def decode_bound_ms(model) -> float:
    """A decode step's least time (``roofline.decode_bound_ms``)."""
    return roofline.decode_bound_ms(model)


def weights_per_token(cfg, model, skip) -> int:
    """The weights one token meets (``roofline.weights_per_token``)."""
    return roofline.weights_per_token(cfg, model, skip)


def attention_pairs(cfg, length: int) -> int:
    """The query-key pairs the masks keep (``roofline.attention_pairs``)."""
    return roofline.attention_pairs(cfg, length)


def prefill_bound_ms(cfg, model, length: int) -> float:
    """A prefill group's least time, LLM_BATCH x ``length`` tokens
    (``roofline.prefill_bound_ms``)."""
    return roofline.prefill_bound_ms(cfg, model, length, LLM_BATCH)


def moe_groups(cfg, moe, lengths) -> list:
    """Per prefill group of LLM_BATCH x ``lengths`` tokens: the MoE's routing
    group size s and the bytes of its gathered expert batch xe."""
    out = []
    for l in lengths:
        t = LLM_BATCH * l
        s = moe._group_size(t)
        xe = cfg.num_experts * (t // s) * moe.capacity(cfg, s) * cfg.d_model * 2
        out.append({"tokens": t, "s": s, "xe_bytes": xe})
    return out


def prefill_transient_gib(cfg, length: int) -> float:
    """The most memory one prefill layer holds beside the weights and the
    caches, reckoned from the shapes (bf16, LLM_BATCH x ``length`` tokens T):
    in an MoE layer, the residual, the norm's output, the gathered batch, the
    experts' gate and up products and the f32 SiLU of one; then beside the
    expert outputs the shared expert's own gate, up and f32 SiLU, the
    combine's f32 rows; in a dense layer, its FFN; in attention, q, k, v, the
    repeated K/V, the output and the f32 RoPE and norm copies of q."""
    d, dh, h = cfg.d_model, cfg.resolved_head_dim, cfg.num_heads
    t = LLM_BATCH * length
    act = t * d * 2
    attn = 2 * act + 4 * t * h * dh * 2 + 3 * t * h * dh * 4
    dense = 2 * act + 2 * t * cfg.d_ff * 2 + t * cfg.d_ff * 4
    moe_peak = 0
    if cfg.num_experts:
        from repro_torch.models import moe
        s = moe._group_size(t)
        slots = cfg.num_experts * (t // s) * moe.capacity(cfg, s)
        f = cfg.moe_d_ff
        experts = 3 * act + slots * d * 2 + 2 * slots * f * 2 + slots * f * 4
        shared = 3 * act + slots * d * 2 + 2 * t * d * 4 + 2 * t * f * 2 + t * f * 4
        moe_peak = max(experts, shared)
    return max(attn, dense, moe_peak) / 2 ** 30


def weights_gib(cfg) -> float:
    """The model's bf16 weights, from a build on the meta device."""
    from repro_torch.models import transformer
    model = transformer.Transformer(cfg, "meta")
    return sum(p.numel() * p.element_size() for p in model.parameters()) / 2 ** 30


def serve_llm_phase(torch, C, tf, ops, serve_llm, arch: str, tag: str = "8") -> dict:
    """Serve phase 8's (or 8b's, 8c's) requests on the model (``llm_config``),
    built on the card from a seed and freed after; returns the launches."""
    from repro_torch.models import moe
    cfg = llm_config(C, arch)
    t0 = time.perf_counter()
    resident = torch.cuda.memory_allocated() / 2 ** 30
    model = tf.build(cfg, "cuda", seed=0)
    reqs = llm_requests(serve_llm, cfg)
    serve_llm.warm(model, reqs)         # each group's shapes once, untimed
    finite = []
    lm_logits = model.lm_logits

    def checked(x):
        logits = lm_logits(x)
        finite.append(torch.isfinite(logits).all())
        return logits
    model.lm_logits = checked
    torch.cuda.synchronize()
    print(f"[{tag}] {arch} built on the card ({sum(p.numel() for p in model.parameters())} "
          f"params, {resident:.2f} GiB resident before) and warmed at every group's shape in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    recs = serve_llm.serve(cfg, reqs, device="cuda", model=model)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    lengths = group_lengths(reqs)
    groups = len(lengths)
    want = expected_launches(cfg, lengths)
    if not all(bool(f) for f in finite) or len(finite) != groups * (1 + LLM_MAX_NEW):
        raise RuntimeError(f"{arch}: non-finite logits while serving")
    shape = (LLM_MAX_NEW,) + ((cfg.num_codebooks,) if cfg.modality == "audio_codec" else ())
    for r in recs:
        toks = r["tokens"]
        if toks.shape != shape or not ((0 <= toks) & (toks < cfg.vocab_size)).all():
            raise RuntimeError(f"{arch} request {r['rid']}: tokens {toks} not of shape {shape} "
                               f"in [0, {cfg.vocab_size})")
    decode_bound = decode_bound_ms(model)
    routing = moe_groups(cfg, moe, lengths) if cfg.num_experts else [None] * groups
    for i, length, route in zip(range(0, len(recs), LLM_BATCH), lengths, routing):
        r = recs[i]
        print(f"[{tag}] {arch} group of {r['group_size']}, prompts "
              f"{[x['prompt_len'] for x in recs[i:i + LLM_BATCH]]} (L = {length}): prefill "
              f"{r['prefill_ms']:.1f} ms (bound {prefill_bound_ms(cfg, model, length):.1f}), "
              f"decode {r['decode_ms_per_token']:.2f} ms/token (bound {decode_bound:.2f})"
              + (f", MoE routing groups of s = {route['s']}, xe {route['xe_bytes'] / 2 ** 30:.2f}"
                 " GiB" if route else ""), flush=True)
    print(f"[{tag}] {arch} served {len(recs)} requests in {wall:.2f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB, launches {launches}",
          flush=True)
    if launches != want:
        raise RuntimeError(f"{arch}: kernel launches {launches}, expected {want}")
    # the wrapped lm_logits holds the model in a cycle: free it before the next
    del model.lm_logits, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def out_path(name: str) -> str:
    """A file under the checkout's chiprun_out/ for output too long to print."""
    d = os.path.join(ROOT, "chiprun_out")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, name)


def calibration_phase(readings: list) -> None:
    """Each served request's stage time beside the profiler's prediction
    under H100_SXM (a Diffuse cut to fewer steps beside the prediction scaled
    to them); fails if a fitted Diffuse reading leaves the band. The heavy
    classes' readings are reported, not held to the band: no knob was
    fitted to them."""
    from repro_torch.core.profiler import H100_SXM
    from repro_torch.launch import calibrate
    with open(out_path("stage_times.json"), "w") as f:
        json.dump(readings, f, indent=1)
    for row in calibrate.table(H100_SXM, readings):
        print(f"[5c] {row['pipeline']} {row['resolution']}px {row['seconds']:g}s "
              f"{row['num_steps']} steps {row['stage']}: measured {row['ms']:.2f} ms, "
              f"predicted {row['predicted_ms']:.2f} ms, measured / predicted "
              f"{row['measured_over_predicted']:.3f}"
              + (" (fitted)" if row["fitted"] else ""), flush=True)
    print(f"[5c] stage readings {json.dumps(readings)}", flush=True)
    bad = calibrate.outside_band(H100_SXM, readings)
    if bad:
        raise RuntimeError(f"Diffuse readings outside {calibrate.BAND} x the H100_SXM "
                           f"prediction: {bad}")


def h2d_bandwidth(torch, nbytes: int = 512 * 2 ** 20, reps: int = 5) -> float:
    """Bytes/s of the best of ``reps`` copies of a pinned host buffer to the card."""
    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    dst.copy_(src, non_blocking=True)
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        dst.copy_(src, non_blocking=True)
        e1.record()
        torch.cuda.synchronize()
        best = min(best, e0.elapsed_time(e1) / 1e3)
    del src, dst
    return nbytes / best


def nccl_build_s(torch) -> float:
    """Seconds to build an NCCL communicator at world size 1 and finish its
    first all-reduce: a lower bound on a group's build across GPUs."""
    import socket
    import torch.distributed as dist
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0)
    try:
        x = torch.ones(1, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(x)
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        if x.item() != 1.0:
            raise RuntimeError(f"NCCL all-reduce at world size 1 gave {x.item()}")
    finally:
        dist.destroy_process_group()
    return took


def dispatch_round_s(C, quickstart, Request, rounds: int = 20) -> tuple:
    """Median host seconds of one Dispatcher.dispatch round as the served
    path makes it (one pending request on the one-chip plan, a fresh
    dispatcher), over every served class; and, for scale, the median round
    of a 128-chip flux plan with 64 pending requests of its dynamic trace."""
    from repro_torch.core import workloads
    from repro_torch.core.dispatcher import Dispatcher
    from repro_torch.core.orchestrator import Orchestrator
    from repro_torch.core.profiler import H100_SXM, Profiler

    def median_round(prof, plan, pending) -> float:
        idle = set(range(plan.num_units))
        free = {g: 0.0 for g in idle}
        times = []
        for _ in range(rounds):
            disp = Dispatcher(prof)
            t0 = time.perf_counter()
            if not disp.dispatch(pending, plan, idle, free, 0.0):
                raise RuntimeError("a dispatch round placed no request")
            times.append(time.perf_counter() - t0)
        return sorted(times)[len(times) // 2]

    served = []
    for name in PIPELINES:
        prof = Profiler(C.get(name), hw=H100_SXM)
        reqs = [Request(name, res, sec) for res, sec in quickstart.REQUESTS[name]]
        for r in reqs:
            r.deadline = 2.5 * prof.pipeline_time(r)
        plan = Orchestrator(prof, num_chips=1).generate(reqs)
        served += [median_round(prof, plan, [r]) for r in reqs]
    prof = Profiler(C.get("flux"), hw=H100_SXM)
    trace = workloads.make_trace("flux", "dynamic", 600.0, prof)
    cluster = median_round(prof, Orchestrator(prof, num_chips=128).generate(trace[:64]),
                           trace[:64])
    return sorted(served)[len(served) // 2], cluster


def host_constants_phase(torch, C, quickstart, Request) -> dict:
    """Measure on this machine what sets H100_SXM's host constants, and
    print each beside the constant."""
    from repro_torch.core.profiler import H100_SXM as hw
    bw = h2d_bandwidth(torch)
    build = nccl_build_s(torch)
    served, cluster = dispatch_round_s(C, quickstart, Request)
    out = {"host_bw": bw, "comm_group_init": build, "dispatch_overhead": served,
           "dispatch_round_128_chips": cluster}
    print(f"[5c] pinned host-to-device copy of 512 MiB: {bw / 1e9:.2f} GB/s "
          f"(H100_SXM.host_bw {hw.host_bw / 1e9:.2f} GB/s)", flush=True)
    print(f"[5c] NCCL communicator build + first all-reduce at world size 1: "
          f"{build * 1e3:.2f} ms, a lower bound (H100_SXM.comm_group_init "
          f"{hw.comm_group_init * 1e3:.2f} ms)", flush=True)
    print(f"[5c] one Dispatcher.dispatch round, served path: {served * 1e3:.4f} ms "
          f"(H100_SXM.dispatch_overhead {hw.dispatch_overhead * 1e3:.4f} ms); 128-chip "
          f"flux plan, 64 pending: {cluster * 1e3:.3f} ms", flush=True)
    print(f"[5c] inter-node bandwidth: H100_SXM.inter_node_bw "
          f"{hw.inter_node_bw / 1e9:.2f} GB/s (ConnectX-7 data sheet, not measured)",
          flush=True)
    return out


# phase 9's cells: chip counts, and the dynamic workload's duration
CLUSTER_CHIPS = (128, 16)
CLUSTER_DURATION = 600.0
SCHEDULERS = ("B1", "B2", "B3", "B4", "B5", "B6")


def cluster_phase() -> list:
    """The simulated H100 cluster through ``launch.serve.main``; a second
    trident run of each cell must give the same deterministic fields."""
    import contextlib
    import dataclasses
    import io
    from repro_torch.core import workloads
    from repro_torch.launch import serve
    rows = []
    for name in PIPELINES:
        for chips in CLUSTER_CHIPS:
            # the same load per chip as the workload's 128-chip rate
            rate = workloads.RATES[name] * chips / 128
            argv = ["--pipeline", name, "--workload", "dynamic", "--duration",
                    str(CLUSTER_DURATION), "--chips", str(chips), "--rate", repr(rate)]
            t0 = time.perf_counter()
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                results = serve.main(argv + ["--baselines", ",".join(SCHEDULERS)])
            wall = time.perf_counter() - t0
            for line in text.getvalue().splitlines():
                print(f"[9] {chips} chips: {line}", flush=True)
            with contextlib.redirect_stdout(io.StringIO()):
                again = serve.main(argv)[0]
            first = dataclasses.asdict(results[0])
            second = dataclasses.asdict(again)
            first.pop("solver_ms")
            second.pop("solver_ms")
            if first != second:
                diff = sorted(k for k in first if first[k] != second[k])
                raise RuntimeError(f"{name} at {chips} chips: a second trident run differs "
                                   f"in {diff}")
            for r in results:
                row = {"pipeline": name, "chips": chips, "rate": rate,
                       "scheduler": r.scheduler, "oom": r.oom, "n_requests": r.n_requests,
                       "n_finished": r.n_finished, "slo_attainment": r.slo_attainment,
                       "mean_latency": r.mean_latency, "p95_latency": r.p95_latency,
                       "placement_switches": max(0, len(r.placement_switches) - 1),
                       "vr_histogram": r.vr_histogram, "solver_ms": r.solver_ms,
                       "sched_wakeups": r.sched_wakeups}
                print(f"[9] {json.dumps(row)}", flush=True)
                rows.append(row)
            print(f"[9] {name} at {chips} chips: 7 schedulers in {wall:.2f} s of host time, "
                  f"trident repeated bit-equal", flush=True)
    with open(out_path("cluster.json"), "w") as f:
        json.dump(rows, f, indent=1)
    return rows


# phase 10's scenarios: serve_fleet's arguments, the profiler's constant
# set, its own pool (what --rate-scale is relative to), the trace's seconds,
# and the mode run twice.  The predictive scenario's CI size runs 960 s; cut
# to 480 s (four periods of 120 s) because its 960 s took 385 s of host time
# on the card's machine (its ILP solves grow with the backlog), over phase
# 10's 180 s.  The lending scenario runs 600 s (three 60 s bursts after a
# 180 s head); cut to 300 s, which keeps the head and the 60 s burst and
# calm spans but only the first burst, because its host time grows with
# each burst's backlog: on a CPU where a 300 s run takes 1.2 s, 420 s (two
# bursts) took 9-12.5 s and 600 s took 19 s.  On H100_SXM no unit on a
# lost node holds work when the storm lands, so the elastic CI size runs a
# second time on the reference's constants, where they do and the
# drain-unaware arm must requeue them.
FLEET_SCENARIOS = (
    ("shared", "h100", ["--modes", "static,proportional,adaptive,predictive"], 512,
     600.0, "adaptive"),
    ("predictive", "h100", ["--smoke"], 128, 480.0, "predictive"),
    ("cross_batch", "h100", ["--smoke"], 64, 600.0, "batching"),
    ("lending", "h100", [], 256, 300.0, "adaptive+lending"),
    ("elastic", "h100", ["--smoke"], 128, 480.0, "drain_aware"),
    ("elastic", "reference", ["--smoke"], 128, 480.0, "drain_aware"),
)
FLEET_CHIPS = {"shared": 128}     # else the scenario's CI-sized pool


def same_result(first, second, what: str) -> None:
    """Fail unless two runs gave every field of the result the same."""
    import dataclasses
    a, b = dataclasses.asdict(first), dataclasses.asdict(second)
    if a != b:
        diff = sorted(k for k in a if a[k] != b[k])
        raise RuntimeError(f"{what}: a second run differs in {diff}")


def same_run(first, second, what: str) -> None:
    """``same_result``, and the same recovery-window P95 where the scenario
    has one."""
    same_result(first.result, second.result, what)
    if first.recovery != second.recovery:
        raise RuntimeError(f"{what}: a second run differs in recovery_p95_s")


def check_fleet_run(run, hw: str) -> None:
    """Fail if a Diffuse stage ran on a borrowed unit, or if the elastic
    scenario's drain-unaware arm on the reference's constants (where the
    lost nodes hold work when the storm lands) lost nodes and requeued
    nothing."""
    r = run.result
    what = f"{run.scenario}/{run.mode} on {hw}"
    if r.borrowed_stage_runs.get("D", 0):
        raise RuntimeError(f"{what}: {r.borrowed_stage_runs['D']} Diffuse runs on "
                           "borrowed units")
    if (run.scenario == "elastic" and run.mode == "drain_unaware" and hw == "reference"
            and r.nodes_lost and not r.requeued_requests):
        raise RuntimeError(f"{what}: {r.nodes_lost} nodes lost and nothing requeued")


def fleet_row(run, hw: str, chips: int, duration: float) -> dict:
    r = run.result
    return {"scenario": run.scenario, "mode": run.mode, "hw": hw, "chips": chips,
            "duration_s": duration,
            "slo_pct": r.slo_attainment * 100, "mean_s": r.mean_latency,
            "p95_s": r.p95_latency, "goodput_rps": r.goodput,
            "repartitions": len(r.repartitions) - 1,
            "predictive_repartitions": r.predictive_repartitions,
            "prewarm_units": r.prewarm_units,
            "cross_lane_merges": r.cross_lane_merges,
            "loans": r.loans, "borrowed_unit_seconds": r.borrowed_unit_seconds,
            "borrowed_stage_runs": r.borrowed_stage_runs,
            "diffuse_runs_on_borrowed_units": r.borrowed_stage_runs.get("D", 0),
            "nodes_lost": r.nodes_lost, "requeued_requests": r.requeued_requests,
            "drained_units": r.drained_units, "quarantined_units": r.quarantined_units,
            "elastic_prewarm_chips": r.elastic_prewarm_chips,
            "recovery_p95_s": run.recovery[0] if run.recovery else None,
            "wakeups": r.sched_wakeups, "host_s": run.wall_s}


def fleet_argv(cell, chips=None, duration=None) -> tuple:
    """(pool size, trace seconds, serve_fleet arguments) of one of phase
    10's scenario cells, at ``chips`` (default: its own, the load per chip
    kept) and ``duration`` seconds (default: its own)."""
    from repro_torch.launch import serve_fleet
    scenario, hw, argv, own_chips, seconds, _ = cell
    n = chips or FLEET_CHIPS.get(scenario, own_chips)
    # a pool holds at least one node of 8 chips per pipeline
    n = max(n, 8 * len(serve_fleet.SCENARIO_PIPELINES[scenario]))
    seconds = duration or seconds
    return n, seconds, ["--scenario", scenario, "--hw", hw] + argv + [
        "--chips", str(n), "--rate-scale", repr(n / own_chips), "--duration", repr(seconds)]


def fleet_phase(chips=None, duration=None) -> tuple:
    """The simulated H100 fleet through ``launch.serve_fleet.main``, each
    scenario at ``chips`` (default: its own, the load per chip kept) and
    ``duration`` seconds (default: its own); a second run of one mode of
    each scenario must give the same ``FleetResult``, and every run must
    pass ``check_fleet_run``.  Returns the rows and the runs by cell."""
    import contextlib
    import io
    from repro_torch.launch import serve_fleet
    rows, by_cell = [], {}
    t_all = time.perf_counter()
    for cell in FLEET_SCENARIOS:
        scenario, hw, _, _, _, rerun = cell
        n, seconds, argv = fleet_argv(cell, chips, duration)
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            runs = serve_fleet.main(argv)
            again = serve_fleet.main(argv + ["--modes", rerun])
        by_cell[scenario, hw] = runs
        for line in text.getvalue().splitlines():
            print(f"[10] {line}", flush=True)
        first = next(r for r in runs if r.mode == rerun)
        same_run(first, again[0], f"{scenario}/{rerun} on {hw}")
        for run in runs + again:
            check_fleet_run(run, hw)
        for run in runs:
            row = fleet_row(run, hw, n, seconds)
            print(f"[10] {json.dumps(row)}", flush=True)
            rows.append(row)
        print(f"[10] {scenario} on {hw} at {n} chips: {len(runs)} modes, {rerun} "
              f"repeated bit-equal", flush=True)
        if scenario == "lending":
            # the broker borrows only for a hosted stage worth lend_min_stage_s
            worth = serve_fleet.lending_stage_worth(serve_fleet.HARDWARE[hw])
            print(f"[10] lending gate on {hw}, largest hosted stage s per request: "
                  f"{json.dumps(worth)} (lend_min_stage_s "
                  f"{serve_fleet.FleetConfig.lend_min_stage_s})", flush=True)
    print(f"[10] fleet phase: {time.perf_counter() - t_all:.1f} s of host time",
          flush=True)
    with open(out_path("fleet.json"), "w") as f:
        json.dump(rows, f, indent=1)
    return rows, by_cell


# phase 11's cells.  (b): the scenarios phase 10 cuts, at their own sizes.
# (c): the scale tier's smoke size, whose simulated fields on the reference's
# constants are the reference's (its ``benchmarks/e2e.py --scale`` gives the
# same on a CPU).  (d): trident with cross-node SP.
UNCUT_SCENARIOS = (("lending", [], 256, 600.0), ("predictive", ["--smoke"], 128, 960.0))
SCALE_REFERENCE = {"n_requests": 100361, "n_finished": 100361, "slo": 0.991630214924124,
                   "sched_wakeups": 6703, "repartitions": 1}
CROSS_NODE_ARGV = ["--pipeline", "hunyuanvideo", "--workload", "dynamic", "--duration",
                   "600", "--chips", "128"]


def fast_row(run, hw: str, chips: int, duration: float, base=None) -> dict:
    """``fleet_row`` with the switches on, the requests served and finished,
    and the phase-10 run's host seconds where there is one."""
    row = fleet_row(run, hw, chips, duration)
    row.update(fast=True, n_requests=run.result.n_requests, n_finished=run.result.n_finished,
               phase10_host_s=base.wall_s if base is not None else None)
    return row


def fast_phase(phase10: dict, chips=None, duration=None) -> list:
    """Phase 11 (the module docstring): the host-path switches on phase 10's
    cells (``phase10``: ``fleet_phase``'s runs by cell, at the same ``chips``
    and ``duration``), the uncut scenarios, the scale tier and cross-node
    SP."""
    import contextlib
    import io
    from repro_torch.launch import scale, serve, serve_fleet
    rows = []
    t_all = time.perf_counter()
    for cell in FLEET_SCENARIOS:
        scenario, hw, _, _, _, rerun = cell
        n, seconds, argv = fleet_argv(cell, chips, duration)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            runs = serve_fleet.main(argv + ["--fast"])
            again = serve_fleet.main(argv + ["--fast", "--modes", rerun])
        wall = time.perf_counter() - t0
        same_run(next(r for r in runs if r.mode == rerun), again[0],
                 f"{scenario}/{rerun} on {hw} with --fast")
        base = {r.mode: r for r in phase10[scenario, hw]}
        for run in runs + again:
            check_fleet_run(run, hw)
            b = base[run.mode].result
            got = (run.result.n_requests, run.result.n_finished)
            if got != (b.n_requests, b.n_finished):
                raise RuntimeError(f"{scenario}/{run.mode} on {hw} with --fast: "
                                   f"{got[0]} requests, {got[1]} finished; phase 10 "
                                   f"{b.n_requests}, {b.n_finished}")
        for run in runs:
            row = fast_row(run, hw, n, seconds, base[run.mode])
            print(f"[11] {json.dumps(row)}", flush=True)
            rows.append(row)
        print(f"[11] {scenario} on {hw} with --fast: {len(runs)} modes in {wall:.2f} s of "
              f"host time, {rerun} repeated bit-equal, requests conserved", flush=True)
    for scenario, argv, n, seconds in UNCUT_SCENARIOS:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            runs = serve_fleet.main(["--scenario", scenario, "--fast",
                                     "--duration", repr(seconds)] + argv)
        wall = time.perf_counter() - t0
        for run in runs:
            check_fleet_run(run, "h100")
            if run.result.n_requests != runs[0].result.n_requests:
                raise RuntimeError(f"uncut {scenario}: the modes served different traces")
            row = fast_row(run, "h100", n, seconds)
            row.update(cell="uncut")
            print(f"[11] {json.dumps(row)}", flush=True)
            rows.append(row)
        print(f"[11] uncut {scenario} with --fast: {len(runs)} modes in {wall:.2f} s of "
              "host time", flush=True)
    for hw in ("reference", "h100"):
        with contextlib.redirect_stdout(io.StringIO()):
            run = scale.main(["--hw", hw])
        print(f"[11] {json.dumps({'cell': 'scale', **run})}", flush=True)
        rows.append({"cell": "scale", **run})
        if hw == "reference":
            got = {k: run[k] for k in SCALE_REFERENCE}
            if got != SCALE_REFERENCE:
                raise RuntimeError(f"scale tier on the reference's constants: {got}, "
                                   f"expected {SCALE_REFERENCE}")
    for cross in (True, False):
        with contextlib.redirect_stdout(io.StringIO()):
            r = serve.main(CROSS_NODE_ARGV + (["--cross-node-sp"] if cross else []))[0]
        row = {"cell": "cross_node_sp" if cross else "node_sp", "pipeline": r.pipeline,
               "chips": 128, "slo_attainment": r.slo_attainment,
               "mean_latency": r.mean_latency, "p95_latency": r.p95_latency,
               "n_requests": r.n_requests, "n_finished": r.n_finished,
               "vr_histogram": r.vr_histogram, "degree_histogram": r.degree_histogram}
        print(f"[11] {json.dumps(row)}", flush=True)
        rows.append(row)
    print(f"[11] fast-path phase: {time.perf_counter() - t_all:.1f} s of host time",
          flush=True)
    with open(out_path("fast.json"), "w") as f:
        json.dump(rows, f, indent=1)
    return rows


# phase 12: the committed BENCH files the event smoke on the reference's
# constants is held to, and their fields that no wall clock moves
EVENT_SMOKE_BENCH = {"event": "BENCH_event_sim.json", "unified": "BENCH_unified_clock.json"}
EVENT_SMOKE_FIELDS = ("scenarios", "sched_wakeups_event", "sched_wakeups_tick", "metrics_match")


def figures_phase() -> list:
    """Phase 12, on the host: the paper's figure scripts
    (``repro_torch.benchmarks.run``'s modules) in quick mode on
    ``H100_SXM``, every row written to ``chiprun_out/figures_h100.csv`` and
    printed as ``name = value`` (simulated numbers); then the event-vs-tick
    smoke set on the reference's constants, held to the committed
    EVENT_SMOKE_BENCH files in EVENT_SMOKE_FIELDS (its clock parity must
    hold)."""
    from repro_torch.benchmarks import common, e2e
    from repro_torch.benchmarks import run as bench
    from repro_torch.core.profiler import H100_SXM, REFERENCE_HW
    out = []
    with open(out_path("figures_h100.csv"), "w") as f:
        f.write(f"# simulated: the profiler's {H100_SXM.name} constants, not measured\n")
        for name in bench.MODULES:
            t0 = time.perf_counter()
            rows = bench.run_module(name, quick=True, hw=H100_SXM)
            common.emit(rows, file=f)
            for row in rows:
                print(f"[12] {row[0]} = {row[1]}", flush=True)
            print(f"[12] {name}: {len(rows)} rows, simulated on {H100_SXM.name}, in "
                  f"{time.perf_counter() - t0:.1f} s of host time", flush=True)
            out += rows
    paths = {k: out_path(base.replace(".json", ".torch_reference_smoke.json"))
             for k, base in EVENT_SMOKE_BENCH.items()}
    t0 = time.perf_counter()
    rows = e2e.run_smoke(bench_path=paths["event"], unified_bench_path=paths["unified"],
                         hw=REFERENCE_HW, repeats=1)
    for key, base in EVENT_SMOKE_BENCH.items():
        with open(paths[key]) as f:
            got = json.load(f)
        with open(os.path.join(ROOT, base)) as f:
            want = json.load(f)
        diff = [k for k in EVENT_SMOKE_FIELDS if got[k] != want[k]]
        if diff or got["metrics_match"] is not True:
            raise RuntimeError(f"event smoke on the reference's constants: {diff} differ from "
                               f"{base} ({ {k: got[k] for k in diff} })")
    speed = next(r for r in rows if r[0].endswith("speedup_event_vs_tick"))
    print(f"[12] event smoke on the reference's constants: wake-ups "
          f"{got['sched_wakeups_event']} event / {got['sched_wakeups_tick']} tick, metrics "
          f"match, as the committed {', '.join(EVENT_SMOKE_BENCH.values())}; event clock "
          f"{speed[1]}x the tick clock ({speed[2]['wall_event_s']} / "
          f"{speed[2]['wall_tick_s']} s of host time) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


# phase 13: training on the card. (a) the example's 100m preset; (b) one
# forward and backward of full-width 2-layer cuts, bf16 on the card against
# the same weights in float32 on the CPU; (c) full-width trainers through
# launch/train.py. The training pass runs the reference's training math, no
# kernel: the phase must add no K1 and no K3 launch.
TRAIN_EXAMPLE_ARGV = ("--preset", "100m", "--steps", "200")
TRAIN_CUT_ARCHS = ("yi-9b", "deepseek-moe-16b", "rwkv6-3b")
TRAIN_CUT_TOKENS = 256              # (b)'s batch: one sequence (phase 7's 1100, cut for time)
# (b)'s readings, bf16 card vs f32 CPU: the loss, the mean NLL and the aux
# loss by |err| / |ref|, each parameter's gradient by rms(err) / rms(ref)
# (the worst one is read). The loss's limit sits below the deepseek cut's
# aux / loss (~9e-4), so a loss without its aux term fails
# (tests/test_torch_smoke_checks.py holds the limits against bf16 rounding
# and faults on the CPU)
TRAIN_CUT_TOL = {"loss": 4e-4, "nll": 4e-4, "aux": 4e-2, "grad": 4e-2}
# a bf16 router near-tie among deepseek's 64 experts (top-6) changes a
# token's set of experts on the card; such tokens are left out of (b)'s
# losses, and at most this share of them may change
TRAIN_FLIP_LIMIT = 0.1
# (c): (arch, layers: None = whole) at TRAIN_BATCH x TRAIN_SEQ tokens a step
TRAINERS = (("yi-9b", 8), ("deepseek-moe-16b", 4), ("rwkv6-3b", None))
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 10, 4, 2048


def train_cut_side(loop, moe, model, batch) -> tuple:
    """One side's training pass of the cut, with the MoE's routing recorded
    -> (per-token NLL (B, L), aux, records)."""
    (logits, aux), seen = routes(moe, lambda: model.train_forward(batch["tokens"]))
    return loop.token_nll(model.cfg, logits, batch["labels"]), aux, seen


def train_cut_backward(torch, model, nll, aux, keep) -> dict:
    """The loss over the kept tokens (``loop.loss_fn``'s mean NLL plus aux)
    backward -> its readings: loss, nll, aux (floats) and every parameter's
    gradient (float32 on the CPU; zeros where none)."""
    mean = nll.reshape(-1)[keep.to(nll.device)].mean()
    loss = mean + aux
    loss.backward()
    grads = {n: (torch.zeros(p.shape) if p.grad is None else p.grad.float().cpu())
             for n, p in model.named_parameters()}
    return {"loss": loss.item(), "nll": mean.item(), "aux": aux.detach().item(), "grads": grads}


def train_cut_readings(got: dict, want: dict) -> dict:
    """(b)'s readings of one side against the other (``train_cut_backward``'s
    dicts): the loss's, NLL's and aux's |err| / |ref| (|err| where the ref
    is 0), and the worst parameter's gradient rms(err) / rms(ref) with its
    name (0 where both are zero, inf where only the ref is)."""
    def rel(g, w):
        return abs(g - w) / abs(w) if w else abs(g)
    grad = {}
    for n, w in want["grads"].items():
        ref_rms = w.pow(2).mean().sqrt().item()
        err = (got["grads"][n] - w).pow(2).mean().sqrt().item()
        r = err / ref_rms if ref_rms else (0.0 if err == 0 else math.inf)
        grad[n] = r if math.isfinite(r) else math.inf
    name = max(grad, key=grad.get)
    return {"loss": rel(got["loss"], want["loss"]), "nll": rel(got["nll"], want["nll"]),
            "aux": rel(got["aux"], want["aux"]), "grad": grad[name], "worst_grad": name}


def check_train_readings(what: str, readings: dict) -> None:
    for key, tol in TRAIN_CUT_TOL.items():
        if not math.isfinite(readings[key]) or readings[key] > tol:
            raise RuntimeError(f"{what}, card vs CPU: {key} = {readings[key]:.3g} above {tol} "
                               f"({readings})")


def check_train_cut(torch, C, tf, loop, moe, pipeline, arch: str) -> dict:
    """The 2-layer cut's training pass and backward on the card (bf16)
    against the same weights on the CPU (float32) on one batch of
    TRAIN_CUT_TOKENS tokens; tokens whose experts differ (or that one side
    kept and the other dropped) are left out of both losses."""
    import dataclasses
    cfg = dataclasses.replace(C.get(arch), num_layers=2)
    gpu = tf.build(cfg, "cuda", seed=14).requires_grad_(True)
    cpu = tf.Transformer(dataclasses.replace(cfg, dtype=torch.float32), "cpu")
    copy_params(torch, cpu, gpu)
    cpu.requires_grad_(True)
    batch = pipeline.synthetic_batch(cfg, pipeline.DataConfig(1, TRAIN_CUT_TOKENS), 0)
    sides = {}
    for name, model in (("card", gpu), ("cpu", cpu)):
        sides[name] = train_cut_side(loop, moe, model,
                                     pipeline.to_tensors(batch, model.embed.device))
    if sides["card"][2]:
        expert, kept = topk_differ(sides["card"][2], sides["cpu"][2])
    else:
        expert = kept = torch.zeros(TRAIN_CUT_TOKENS, dtype=torch.bool)
    keep = ~(expert | kept)
    got = train_cut_backward(torch, gpu, sides["card"][0], sides["card"][1], keep)
    want = train_cut_backward(torch, cpu, sides["cpu"][0], sides["cpu"][1], keep)
    out = {"tokens": TRAIN_CUT_TOKENS, "expert_differs": int(expert.sum()),
           "kept_differs": int(kept.sum()), "loss_card": got["loss"], "loss_cpu": want["loss"],
           **train_cut_readings(got, want)}
    del gpu, cpu, sides, got, want
    gc.collect()
    torch.cuda.empty_cache()
    if out["expert_differs"] > TRAIN_FLIP_LIMIT * out["tokens"]:
        raise RuntimeError(f"{arch} train cut: {out}: too many tokens changed expert")
    check_train_readings(f"{arch} train cut", out)
    return out


def check_restore(torch, saved: dict, restored: dict) -> None:
    """Every tensor of a checkpointed train state (``checkpoint.state_tree``:
    parameters, moments, step) comes back bit-equal, and the moments the
    run wrote are not all zero."""
    if set(saved) != set(restored):
        raise RuntimeError(f"restore: keys differ: {sorted(set(saved) ^ set(restored))}")
    for k, t in saved.items():
        r = restored[k]
        if r.dtype != t.dtype or r.shape != t.shape or not torch.equal(r.cpu(), t.cpu()):
            raise RuntimeError(f"restore: {k} differs from what was saved")
    if not any(bool(t.abs().sum() > 0) for k, t in saved.items() if k.startswith("nu.")):
        raise RuntimeError("restore: the saved state has no moments")


def train_memory_gib(cfg, batch: int, seq: int) -> dict:
    """A trainer's memory, reckoned from the shapes
    (``roofline.train_memory_gib``)."""
    return roofline.train_memory_gib(cfg, batch, seq)


def train_bound_ms(cfg, batch: int, seq: int) -> tuple:
    """A train step's least time -> (ms, bound_by)
    (``roofline.train_bound_ms``)."""
    return roofline.train_bound_ms(cfg, batch, seq)


def train_phase(torch, C, tf, ops, moe) -> list:
    """Phase 13 -> one record per trainer of (c)."""
    import dataclasses
    from repro_torch.data import pipeline
    from repro_torch.launch import train, train_llm
    from repro_torch.training import checkpoint, loop
    before = dict(ops.LAUNCHES)
    print(f"[13] launches before: {json.dumps(before)}", flush=True)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train_llm_100m.pt")
        state, history, _ = train_llm.main(list(TRAIN_EXAMPLE_ARGV) + ["--ckpt", path])
        first, last = history[0], history[-1]
        if not last["loss"] < first["loss"]:
            raise RuntimeError(f"[13] the example's loss did not fall: {first} -> {last}")
        fresh = loop.init_state(state.model.cfg, seed=1, device="cuda")
        fresh = checkpoint.restore_state(path, fresh)
        check_restore(torch, checkpoint.state_tree(state), checkpoint.state_tree(fresh))
    ms = (last["wall"] - first["wall"]) / (last["step"] - first["step"]) * 1e3
    print(f"[13a] train_llm --preset 100m: loss {first['loss']:.4f} -> {last['loss']:.4f} in "
          f"{last['step'] + 1} steps, {ms:.2f} ms per step (host clock, steps "
          f"{first['step']}-{last['step']}); checkpoint restored bit-equal "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    del state, fresh
    gc.collect()
    torch.cuda.empty_cache()

    for arch in TRAIN_CUT_ARCHS:
        t0 = time.perf_counter()
        cut = check_train_cut(torch, C, tf, loop, moe, pipeline, arch)
        print(f"[13b] {arch} 2-layer train cut, card vs CPU: {json.dumps(cut)} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)

    records = []
    for arch, layers in TRAINERS:
        cfg = C.get(arch) if layers is None else dataclasses.replace(C.get(arch),
                                                                     num_layers=layers)
        mem = train_memory_gib(cfg, TRAIN_BATCH, TRAIN_SEQ)
        gib = {k: round(v, 2) for k, v in mem.items() if k != "params"}
        print(f"[13c] {arch} {cfg.num_layers} layers, {mem['params'] / 1e9:.2f} B params, "
              f"reckoned GiB: {json.dumps(gib)} of the card's ~{CARD_GIB:.0f}", flush=True)
        argv = ["--arch", arch, "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
                "--seq", str(TRAIN_SEQ), "--log-every", str(TRAIN_STEPS)]
        if layers is not None:
            argv += ["--layers", str(layers)]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, rows = train.main(argv)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if int(state.opt.step) != TRAIN_STEPS or len(rows) != TRAIN_STEPS:
            raise RuntimeError(f"[13c] {arch}: step {int(state.opt.step)} after {len(rows)} rows")
        bad = [r for r in rows if not (math.isfinite(r["loss"])
                                       and math.isfinite(r["grad_norm"]))]
        if bad:
            raise RuntimeError(f"[13c] {arch}: non-finite steps {bad}")
        steady = [r["ms"] for r in rows[1:]]
        ms = sum(steady) / len(steady)
        bound, bound_by = train_bound_ms(cfg, TRAIN_BATCH, TRAIN_SEQ)
        rec = {"arch": arch, "layers": cfg.num_layers, "params": mem["params"],
               "tokens_per_step": TRAIN_BATCH * TRAIN_SEQ, "first_step_ms": rows[0]["ms"],
               "ms_per_step": ms, "min_ms": min(steady), "max_ms": max(steady),
               "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / ms * 1e3, "bound_ms": bound,
               "bound_by": bound_by, "bound_share": bound / ms, "peak_gib": peak,
               "reckoned_gib": mem["total"], "loss_first": rows[0]["loss"],
               "loss_last": rows[-1]["loss"], "grad_norm_last": rows[-1]["grad_norm"]}
        records.append(rec)
        print(f"[13c] {json.dumps(rec)} ({time.perf_counter() - t0:.1f} s)", flush=True)
        del state, rows
        gc.collect()
        torch.cuda.empty_cache()

    after = dict(ops.LAUNCHES)
    print(f"[13] launches after: {json.dumps(after)}", flush=True)
    for name in ("flash_attention", "ssm_scan"):
        if after[name] != before[name]:
            raise RuntimeError(f"[13] training launched {name} "
                               f"{after[name] - before[name]} times")
    return records


# phase 14: sharding on the card. Worlds of 2 and 4 ranks (shard_check.World)
# share the one card over gloo, which carries CUDA tensors through the host
# (NCCL does not put two ranks on one card): the host seconds printed are
# gloo's, and time nothing on the card. (a) Ulysses attention through K1 at
# sd3's and flux's attention widths (non-causal, a 1024 px latent grid) and
# yi-9b's (causal, GQA expanded), bf16, its gathered output held against K1
# unsharded on the same inputs within K1's limits and against the plain
# version on ``k1_rows``; (b) the chunk-parallel scan through K3 at rwkv6's
# width (strict read with the bonus) and zamba2's (inclusive, q and k shared
# across heads), each also at the decay floor, held against K3 unsharded
# within K3's limits (and finite); (c) one sharded train step of full-width
# 2-layer cuts (float32, TF32 off) against the unsharded step on the card:
# the loss and aux loss within SP_LOSS_TOL, the gradient norm within
# SP_GNORM_TOL, every parameter that was not all zeros before the step
# within SP_PARAM_TOL of its rms, every parameter's step (its value minus
# its start: after one step at the warmup's lr, lr * g / (|g| + eps) plus
# the decay, which a parameter's value hides) within SP_UPDATE_TOL in rms
# of the step's rms, and every AdamW moment element within SP_PARAM_TOL of
# its own value plus the tensor's rms and of the tensor's largest value.
# The steps' largest element is printed, not held: near |g| ~ eps AdamW
# turns a gradient's rounding into a change of the order of the step (the
# card moved deepseek-moe's layers.0.ln1 by 2.2e-4 of its step). (c) runs
# at world size 1 under NCCL on a 1x1 mesh (SP_TRAIN_WHY): the same code,
# its placements and redistributions, with nothing to send.
SP_WORLDS = (4, 2)
SP_ATTN = (("sd3", 1, 4096, 24, 64, False), ("flux", 1, 4096, 24, 128, False),
           ("yi-9b", 2, 2048, 32, 128, True))
SP_SCAN = (("rwkv6-3b", 1, 40, 2048, 64, True, "per-head"),
           ("zamba2-1.2b", 1, 64, 2048, 64, False, "zamba2"))
SP_TRAIN = (("yi-9b", (1, 1), ("zero",)), ("yi-9b", (1, 1), ()),
            ("deepseek-moe-16b", (1, 1), ("fsdp",)))
SP_TRAIN_BACKEND = "nccl"
SP_TRAIN_WHY = ("in torch 2.11 gloo's functional all-gather on CUDA tensors (DTensor's "
                "Shard -> Replicate: ZeRO's updates, FSDP's weights, the vocab-sharded "
                "table) ends the rank with SIGSEGV, where the same all-gather called "
                "directly runs (`python -m repro_torch.launch.gloo_probe`); "
                "ranks on the CPU run the sharded step on 2x1, 1x2 and 2x2 meshes "
                "(tests/test_torch_sharding.py)")
SP_TRAIN_LAYERS, SP_TRAIN_BATCH, SP_TRAIN_SEQ = 2, 2, 1024
SP_LOSS_TOL, SP_GNORM_TOL, SP_PARAM_TOL, SP_UPDATE_TOL = 1e-5, 1e-4, 1e-4, 1e-3


def sharding_cases(sc, world: int) -> tuple:
    """Phase 14's (Ulysses, scan, train) cases for a world of ``world`` ranks:
    (a) and (b) in the worlds of SP_WORLDS, (c) in the world of one."""
    attn = [sc.AttnCase(name, b, l, h, d, causal=causal, dtype="bfloat16", seed=140 + i)
            for i, (name, b, l, h, d, causal) in enumerate(SP_ATTN)]
    scan = [sc.ScanCase(name + (" floor" if floor else ""), b, h, l, k, k, bonus, layout=layout,
                        floor=floor, dtype="bfloat16", seed=150 + 2 * i + floor)
            for i, (name, b, h, l, k, bonus, layout) in enumerate(SP_SCAN)
            for floor in (False, True)]
    train = [sc.TrainCase(arch, mesh, opts, smoke=False, layers=SP_TRAIN_LAYERS,
                          batch=SP_TRAIN_BATCH, seq=SP_TRAIN_SEQ, steps=1, dtype="float32")
             for arch, mesh, opts in SP_TRAIN]
    return ([], [], train) if world == 1 else (attn, scan, [])


def sharded_attention_row(ops, ref, sc, case, got, world: int, seconds: float, kernel,
                          device: str = "cuda"):
    """(a)'s check of one gathered Ulysses output ``got`` (CPU) against
    ``kernel`` (K1's wrapper; on the CPU, ``ops.flash_attention``'s plain
    version) on the case's inputs on ``device`` -> its row; raises where
    K1's limits fail."""
    q, k, v = sc.attn_inputs(case, device)
    got = got.to(device)
    want = kernel(q, k, v, causal=case.causal)
    err, rel, ok = k1_agree(got, want)
    rows = k1_rows(case.l, case.seed)
    mask = ops.attention_mask(case.l, case.l, 0, q.device) if case.causal else None
    p_err, p_rel, p_ok = k1_subset_agree(ref, got, q, k, v, rows, mask)
    row = {"check": "ulysses", "case": case.name, "world": world, "mesh": f"1x{world}",
           "backend": "gloo", "shape": [case.b, case.l, case.h, case.d], "causal": case.causal,
           "max_abs_err": err, "rms_rel": rel, "plain_rows": len(rows),
           "plain_max_abs_err": p_err, "plain_rms_rel": p_rel, "host_s": seconds}
    if not (ok and p_ok):
        raise RuntimeError(f"[14] Ulysses {case.name} at {world} ranks off K1's limits: {row}")
    return row


def sharded_scan_row(torch, sc, case, got, world: int, seconds: float, kernel,
                     device: str = "cuda"):
    """(b)'s check of one chunk-parallel scan's (output, final state) ``got``
    (CPU) against ``kernel`` (K3's wrapper; on the CPU, ``ops.linear_scan``'s
    plain version) on the case's inputs on ``device`` -> its row; raises
    where K3's limits fail or a value is not finite."""
    q, k, v, decay, bonus = sc.scan_inputs(case, device)
    want = kernel(q, k, v, decay, bonus=bonus)
    out = (got[0].to(device), got[1].to(device))
    e_out, e_state, ok = scan_agree(out, want)
    finite = all(bool(torch.isfinite(t).all()) for t in out)
    row = {"check": "scan", "case": case.name, "world": world, "mesh": f"1x{world}",
           "backend": "gloo", "shape": [case.b, case.h, case.l, case.k, case.v],
           "bonus": case.bonus, "floor": case.floor, "max_abs_err": e_out,
           "state_max_abs_err": e_state, "finite": finite, "host_s": seconds}
    if not (ok and finite):
        raise RuntimeError(f"[14] scan {case.name} at {world} ranks off K3's limits: {row}")
    return row


def sharded_train_row(row: dict) -> dict:
    """(c)'s check of one ``shard_check.train_ranks`` row -> its printed
    row; raises where a limit fails."""
    out = {"check": "train", "arch": row["arch"], "world": row["world"], "mesh": row["mesh"],
           "opts": row["opts"], "backend": row["backend"], "loss_rel": row["loss"],
           "aux_rel": row["aux"], "grad_norm_rel": row["grad_norm"],
           "param_err_over_rms": row["params"], "worst_param": row["worst_params"],
           "update_rms_err_over_rms": row["updates"], "worst_update": row["worst_updates"],
           "update_max_err_over_rms": row["updates_max"], "lr": row["steps"][-1]["want"]["lr"],
           "moment_err_over_own": row["moments"], "worst_moment": row["worst_moments"],
           "moment_err_over_max": row["moments_of_max"], "topk_differ": row["topk_differ"],
           "tokens": row["tokens"], "groups": row["groups"],
           "loss": row["steps"][0]["got"]["loss"], "host_s": row["host_s"]}
    if any(row["launches"][name] for name in ("flash_attention", "ssm_scan")):
        raise RuntimeError(f"[14] the sharded train step launched a kernel: {row['launches']}")
    if not (max(row["loss"], row["aux"]) <= SP_LOSS_TOL and row["grad_norm"] <= SP_GNORM_TOL
            and row["params"] <= SP_PARAM_TOL and row["updates"] <= SP_UPDATE_TOL
            and max(row["moments"], row["moments_of_max"]) <= SP_PARAM_TOL):
        raise RuntimeError(f"[14] sharded train step off its limits: {out}")
    return out


def sharding_memory_gib(cfg, mesh: tuple, opts: tuple) -> dict:
    """(c)'s memory on the card, reckoned from the shapes and the partition
    rules before it holds it: rank 0's unsharded step (weights, grads, two
    f32 moments, activations, and the weights' start, which it keeps to
    measure the step) and the weights and moments it keeps after;
    then each rank at its peak, the larger of building the full state and
    sharding it, and the step (its shards, the weights gathered whole, the
    full-size pending gradients, activations); the total of both worlds'
    peaks."""
    import torch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer
    from repro_torch.sharding import partition
    from repro_torch.training.optimizer import AdamWState
    mem = train_memory_gib(cfg, SP_TRAIN_BATCH, SP_TRAIN_SEQ)
    params = dict(transformer.Transformer(cfg, "meta").named_parameters())
    shape = mesh_lib.MeshShape(mesh_lib.AXES, tuple(mesh))
    tree = partition.StateTree(params, AdamWState(step=torch.empty(()), mu=params, nu=params))
    zero = bool({"zero", "fsdp"} & set(opts))
    spec = partition.validate_divisibility(partition.state_specs(
        cfg, tree, zero_mesh=shape if zero else None, fsdp="fsdp" in opts), tree, shape)
    sizes = shape.shape

    def share(s) -> int:
        n = 1
        for ax in s:
            for a in (() if ax is None else (ax,) if isinstance(ax, str) else ax):
                n *= sizes[a]
        return n
    shards = sum(p.numel() * (p.element_size() / share(spec.params[n])
                              + 4 / share(spec.opt.mu[n]) + 4 / share(spec.opt.nu[n]))
                 for n, p in params.items()) / 2 ** 30
    full = mem["weights"] + mem["moments"]
    act = mem["remat_saved"] + mem["transient"]
    per_rank = max(full + shards, shards + mem["weights"] + mem["grads"] + act)
    world = shape.size
    unsharded = full + mem["weights"] + mem["grads"] + act
    return {"unsharded": unsharded, "kept": full, "shards": shards, "per_rank": per_rank,
            "total": max(unsharded, full + world * per_rank)}


def sharding_phase(torch, C, ops, ref, fa, ss) -> dict:
    """Phase 14 -> the K1 and K3 launches of the ranks' sharded calls."""
    from repro_torch.launch import shard_check as sc
    launches = {"flash_attention": 0, "adaln_rmsnorm": 0, "ssm_scan": 0}
    print(f"[14] (c) runs at world size 1 under {SP_TRAIN_BACKEND} on a 1x1 mesh: "
          f"{SP_TRAIN_WHY}", flush=True)
    for arch, mesh, opts in SP_TRAIN:
        cfg = sc.case_config(sc.TrainCase(arch, mesh, opts, smoke=False, layers=SP_TRAIN_LAYERS,
                                          dtype="float32"))
        gib = {k: round(v, 2) for k, v in sharding_memory_gib(cfg, mesh, opts).items()}
        print(f"[14] {arch} {SP_TRAIN_LAYERS} layers f32 on {'x'.join(map(str, mesh))} "
              f"{','.join(opts) or '-'}: reckoned GiB {json.dumps(gib)} of the card's "
              f"~{CARD_GIB:.0f}", flush=True)
        if gib["total"] > CARD_GIB:
            raise RuntimeError(f"[14] {arch} on {mesh} {opts} would not fit the card: {gib}")
    for world in SP_WORLDS + (1,):
        attn, scan, train = sharding_cases(sc, world)
        t0 = time.perf_counter()
        res = sc.run(world, sc.suite_ranks, attn, scan, train, device="cuda", threads=0,
                     timeout=900, backend="gloo" if world > 1 else SP_TRAIN_BACKEND)
        print(f"[14] world of {world} rank(s) on one card ran in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        first = res[0]
        for part in ("ulysses", "scan"):
            for r in res:
                for name, n in r[part]["launches"].items():
                    launches[name] += n
        for case, got, secs in zip(attn, first["ulysses"]["outputs"],
                                   first["ulysses"]["seconds"]):
            row = sharded_attention_row(ops, ref, sc, case, got, world, secs, fa.flash_attention)
            print(f"[14] {json.dumps(row)}", flush=True)
        for case, got, secs in zip(scan, first["scan"]["outputs"], first["scan"]["seconds"]):
            row = sharded_scan_row(torch, sc, case, got, world, secs, ss.ssm_scan)
            print(f"[14] {json.dumps(row)}", flush=True)
        for row in first["train"]:
            print(f"[14] {json.dumps(sharded_train_row(row))}", flush=True)
        del res, first
        gc.collect()
        torch.cuda.empty_cache()
    want = {"flash_attention": len(SP_ATTN) * sum(SP_WORLDS),
            "ssm_scan": 2 * 2 * len(SP_SCAN) * sum(SP_WORLDS)}
    print(f"[14] launches of the ranks' sharded calls: {json.dumps(launches)} "
          f"(expected {json.dumps(want)})", flush=True)
    for name, n in want.items():
        if launches[name] != n:
            raise RuntimeError(f"[14] {name} launched {launches[name]} times, not {n}")
    return launches


KERNELS = (("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:85"),
           ("adaln_rmsnorm", "src/repro_torch/csrc/adaln_rmsnorm.cu",
            "src/repro/kernels/adaln_rmsnorm.py:33"),
           ("ssm_scan", "src/repro_torch/csrc/ssm_scan.cu",
            "src/repro/kernels/ssm_scan.py:80"))


# phase 15: the dry run's combinations (arch, shape, multi-pod, --opt), its
# host-time budget, and the counted steps' DiT resolution. long_500k is a
# decode shape, whose recurrence is plain torch: rwkv6's prefill counts K3
DRYRUN_CASES = (("yi-9b", "decode_32k", False, ()),
                ("deepseek-moe-16b", "train_4k", False, ("zero",)),
                ("rwkv6-3b", "long_500k", True, ()), ("rwkv6-3b", "prefill_32k", False, ()))
DRYRUN_PIPELINE = "sd3"
DRYRUN_HOST_S = 120
COUNTED_DIT_RES = 512


def known_answers_phase(torch) -> dict:
    """Phase 15 (a): the counter's known answers on this torch. A (4096,
    4096) bf16 product of Shard(0) by Shard(1) operands on a fake 16x16
    world counts 2 * 256 * 256 * 4096 FLOPs per device on its first call and
    on its second (DTensor's propagation on global shapes, first call only,
    is not counted); an all-reduce of a (16, 16) f32 over 4 ranks and an
    all-gather into (16, 16) over 2 count 2 * 3/4 * 1024 + 1/2 * 1024 =
    2048 wire bytes."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.roofline import counts
    want = 2 * 256 * 256 * 4096
    with counts.fake_world(256):
        mesh = mesh_lib.build(mesh_lib.make_production_mesh(), "cpu")
        a = torch.empty((4096, 4096), dtype=torch.bfloat16, device="meta")
        x = DTensor.from_local(a[:256], mesh, [Shard(0), Replicate()], run_check=False,
                               shape=a.shape, stride=a.stride())
        w = DTensor.from_local(a[:, :256], mesh, [Replicate(), Shard(1)], run_check=False,
                               shape=a.shape, stride=a.stride())
        flops = [counts.count(lambda: x @ w)[1].flops for _ in range(2)]
    with counts.fake_world(4):
        pair = mesh_lib.build(mesh_lib.MeshShape(("data", "model"), (2, 2)), "cpu")
        _, coll = counts.count(lambda: (
            funcol.all_reduce(torch.empty((16, 16), device="meta"), "sum", dist.group.WORLD),
            funcol.all_gather_tensor(torch.empty((8, 16), device="meta"), 0, (pair, 1))))
    out = {"product_flops": flops, "want": want, "wire_bytes": coll.collective_wire_bytes,
           "counts": coll.collective_counts}
    print(f"[15a] known answers: {json.dumps(out)}", flush=True)
    if flops != [want, want] or coll.collective_wire_bytes != 2048 \
            or coll.collective_counts != {"all-reduce": 1, "all-gather": 1}:
        raise RuntimeError(f"the counter's known answers do not hold: {out}")
    return out


def dry_row(rec: dict) -> str:
    """One dry-run record as a row: the three terms, the bottleneck, the
    useful share, the peak and the host seconds."""
    return (f"{rec['arch']} {rec['shape']} {rec['mesh']} {','.join(rec.get('opts', []))}: "
            f"compute {rec['t_compute_s'] * 1e3:.2f} ms, memory {rec['t_memory_s'] * 1e3:.2f} ms, "
            f"collective {rec['t_collective_s'] * 1e3:.2f} ms -> {rec['bottleneck']}, useful "
            f"{rec['useful_ratio']:.3f}, peak {rec['peak_mem_per_device'] / 2 ** 30:.2f} GiB, "
            f"flops {rec['hlo_flops_per_device']:.4e}, bytes {rec['hlo_bytes_per_device']:.4e}, "
            f"wire {rec['coll_wire_bytes_total']:.4e} {json.dumps(rec['coll_counts'])}, kernels "
            f"{json.dumps(rec['kernel_calls'])}, replicated {json.dumps(rec['replicated_calls'])}, "
            f"{rec['t_trace_s']} s")


def dryrun_phase() -> list:
    """Phase 15 (b): the dry run (``launch/dryrun``, ``launch/dryrun_pipeline``)
    of DRYRUN_CASES and DRYRUN_PIPELINE's stages, on ``meta`` over fake
    worlds; fails if any record is an error."""
    from repro_torch.core.profiler import H100_SXM
    from repro_torch.launch import dryrun, dryrun_pipeline
    t0 = time.perf_counter()
    print("[15b] " + dryrun.NODE_NOTE.format(hw=H100_SXM.name, n=H100_SXM.link_domain_chips,
                                             mesh="16x16 and 2x16x16"), flush=True)
    recs = [dryrun.run_one(a, s, multi_pod=mp, verbose=False, opts=frozenset(o))
            for a, s, mp, o in DRYRUN_CASES]
    recs += dryrun_pipeline.run_case(DRYRUN_PIPELINE, verbose=False)
    seconds = time.perf_counter() - t0
    with open(out_path("dryrun.jsonl"), "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    for r in recs:
        if r["status"] != "ok":
            raise RuntimeError(f"dry run {r['arch']} {r['shape']} {r['mesh']}: {r['status']} "
                               f"{r.get('error', r.get('reason'))}")
        print(f"[15b] {dry_row(r)}", flush=True)
    print(f"[15b] dry run took {seconds:.1f} s of host time (budget {DRYRUN_HOST_S} s)",
          flush=True)
    return recs


def counted_step(torch, ops, name: str, build, device: str = "cuda") -> dict:
    """Phase 15 (c) for one step: ``build(device)`` -> (fn, args). The step
    runs untimed, then timed (CUDA events), then under the counter; the
    same step built on ``meta`` must count the same FLOPs, bytes and kernel
    calls, and the kernel calls must be ``ops.LAUNCHES``' increase. Prints
    the time, the roofline bound on H100_SXM, the share and the reckoned
    peak beside the allocator's."""
    from repro_torch import device as _device
    from repro_torch.roofline import counts
    dev = torch.device(device)
    fn, args = build(dev)
    with torch.no_grad():
        fn(*args)                                    # untimed: the shapes' first run
        with _device.StageTimer(dev) as timer:
            fn(*args)
        ms = timer.ms()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        before = dict(ops.LAUNCHES)
        _, mc = counts.count(fn, *args)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launched = {k: ops.LAUNCHES[k] - before[k] for k in before if ops.LAUNCHES[k] != before[k]}
        allocated = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
    del fn, args
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    mfn, margs = build(torch.device("meta"))
    with torch.no_grad():
        _, meta = counts.count(mfn, *margs)
    roof = roofline.Roofline.from_costs(name, "", "1", 1, mc, 0.0)
    rec = {"step": name, "ms": ms, "bound_ms": roof.t_bound * 1e3, "bottleneck": roof.bottleneck,
           "share": roof.t_bound * 1e3 / ms, "flops": mc.flops, "hbm_bytes": mc.hbm_bytes,
           "kernel_calls": mc.kernel_calls, "launched": launched,
           "reckoned_peak_gib": mc.peak_bytes / 2 ** 30,
           "allocated_peak_gib": None if allocated is None else allocated / 2 ** 30,
           "meta": {"flops": meta.flops, "hbm_bytes": meta.hbm_bytes,
                    "kernel_calls": meta.kernel_calls}}
    print(f"[15c] {json.dumps(rec)}", flush=True)
    if (mc.flops, mc.hbm_bytes, mc.kernel_calls) != (meta.flops, meta.hbm_bytes,
                                                     meta.kernel_calls):
        raise RuntimeError(f"{name}: the card's counts differ from meta's: {rec}")
    if dev.type == "cuda" and mc.kernel_calls != launched:
        raise RuntimeError(f"{name}: counted kernel calls {mc.kernel_calls}, launched {launched}")
    return rec


def counted_steps_phase(torch, C, ops, serve_llm) -> dict:
    """Phase 15 (c): one yi-9b prefill group at phase 8's first shape and one
    sd3 DiT step at COUNTED_DIT_RES px, each counted on the card and on
    ``meta``; returns the kernels' launches."""
    from repro_torch.models import diffusion
    from repro_torch.models import transformer as tf
    cfg = llm_config(C, "yi-9b")
    length = group_lengths(llm_requests(serve_llm, cfg))[0]

    def yi_prefill(dev):
        model = tf.Transformer(cfg, dev)
        if dev.type != "meta":
            model.init_(torch.Generator(device=dev).manual_seed(0))
        tokens = torch.zeros((LLM_BATCH, length), dtype=torch.int64, device=dev)
        if dev.type != "meta":
            tokens.random_(0, cfg.vocab_size, generator=torch.Generator(device=dev).manual_seed(1))
        return (lambda m, t: m.prefill(t, length + LLM_MAX_NEW)), (model.eval(), tokens)

    pcfg = C.get("sd3")
    lt = pcfg.latent_tokens(COUNTED_DIT_RES)

    def dit_step(dev):
        dit = diffusion.DiT(pcfg.dit, dev)
        x = torch.zeros((1, lt, pcfg.dit.latent_dim), device=dev)
        cond = torch.zeros((1, 77, pcfg.dit.cond_dim), device=dev)
        if dev.type != "meta":
            g = torch.Generator(device=dev).manual_seed(2)
            dit.init_(g)
            x.normal_(generator=g)
            cond.normal_(generator=g)
        t = torch.full((1,), 500.0, device=dev)
        return (lambda m, xx, tt, cc: m(xx, tt, cc)), (dit.eval(), x, t, cond)

    launches = {k: 0 for k in ops.LAUNCHES}
    for name, build in ((f"yi-9b prefill {LLM_BATCH} x {length}", yi_prefill),
                        (f"sd3 DiT step {COUNTED_DIT_RES} px (L = {lt} + 77)", dit_step)):
        rec = counted_step(torch, ops, name, build)
        for k, n in rec["launched"].items():
            launches[k] += n
    return launches


def kernel_records(records: dict, by_path: dict) -> list:
    """The kernels line: per kernel, its launches on the main path (by path),
    its largest error, and its ms, plain ms, bound ms and library ms summed
    over one call at each shape the serve phases give it. The library time
    sums the shapes that have a library call and names those that have none
    (``library_missing``); null where no shape has one. The plain time sums
    the shapes timed whole and names those timed on a subset of their rows
    (``plain_missing``). ``sums`` splits the four sums between the shapes of
    Table 5's ends (``table5_end_shapes``) and the others."""
    kernels = []
    for name, source, replaces in KERNELS:
        rows = [r for r in records[name] if r.get("main_path")]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(counts[name] for counts in by_path.values()),
            "launches_by_path": {path: counts[name] for path, counts in by_path.items()},
            "max_abs_err": max(r["max_abs_err"] for r in records[name]),
            # one call at each shape the serve phases give the kernel
            "shapes": [r["shape"] for r in rows],
            **time_sums(rows),
            "bound_by": rows[-1]["bound_by"],
            "sums": {"table5_ends": time_sums([r for r in rows if r.get("table5_end")]),
                     "others": time_sums([r for r in rows if not r.get("table5_end")])},
            "ms_by_path": ms_by(rows, lambda r: r["main_path"]),
            # K1's record shape is (B, Lq, Lkv, H, D)
            "ms_by_head_dim": (ms_by(rows, lambda r: str(r["shape"][4]))
                               if name == "flash_attention" else None),
        })
    return kernels


def time_sums(rows) -> dict:
    """ms, plain ms, bound ms and library ms summed over timed records, with
    the shapes that have no whole plain time or no library call."""
    lib = [r["library_ms"] for r in rows if r["library_ms"] is not None]
    plain = [r["plain_ms"] for r in rows if r["plain_ms"] is not None]
    return {"ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(plain) if plain else None,
            "plain_missing": [r["shape"] for r in rows if r["plain_ms"] is None] or None,
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "library_ms": sum(lib) if lib else None,
            "library_missing": ([r["shape"] for r in rows if r["library_ms"] is None] if lib
                                else None)}


def ms_by(rows, key) -> dict:
    """The summed ms of timed records grouped by ``key(record)``."""
    out = {}
    for r in rows:
        out[key(r)] = out.get(key(r), 0.0) + r["ms"]
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import adaln_rmsnorm as ar
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssm_scan as ss
    import repro_torch.configs as C
    from repro_torch.core.request import Request
    from repro_torch.launch import quickstart, serve_llm
    from repro_torch.models import moe
    from repro_torch.models import pipeline as pl
    from repro_torch.models import transformer as tf

    t_all = time.perf_counter()
    marks = [t_all]

    def lap(tag: str) -> None:
        """Print the seconds phase ``tag`` took."""
        now = time.perf_counter()
        print(f"[{tag}] phase took {now - marks[-1]:.1f} s", flush=True)
        marks.append(now)

    card = smi()
    print(f"[1] card: {card}; torch {torch.__version__} cuda {torch.version.cuda} "
          f"cudnn {torch.backends.cudnn.version()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    _build.library()
    print(f"[2] kernels built and loaded in {time.perf_counter() - marks[-1]:.1f} s", flush=True)
    print(f"[2] K1 ptxas: {k1_build_report(_build)}", flush=True)
    print(f"[2] K2 ptxas: {k2_build_report(_build)}", flush=True)
    print(f"[2] K3 ptxas: {k3_build_report(_build)}", flush=True)
    lap("2")

    gen = torch.Generator(device="cuda").manual_seed(0)
    records = {}
    llm_groups = {arch: group_lengths(llm_requests(serve_llm, llm_config(C, arch)))
                  for arch in LLM_ARCHS + ATTN_ARCHS + ZOO_ARCHS}
    k1_shapes, k2_shapes = serving_shapes(C, llm_groups)
    k1_ends, k2_ends = table5_end_shapes(C)
    check_flash_attention(torch, ops, ref, fa, gen, records, k1_shapes, k1_ends)
    check_adaln_rmsnorm(torch, ref, ar, gen, records, k2_shapes, k2_ends)
    print("[3] kernels agree with their plain versions", flush=True)
    lap("3")

    for name in PIPELINES:
        t0 = time.perf_counter()
        cut = check_cut(torch, C, pl, name)
        print(f"[4] two-layer {name} cut, card vs CPU: {json.dumps(cut)} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    lap("4")

    by_path, readings = {}, []
    for name in PIPELINES:
        paths, got = serve_pipeline_phase(torch, C, pl, ops, quickstart, Request, name,
                                          "5" if name == "sd3" else "5b")
        by_path.update(paths)
        readings += got
    lap("5-5d")
    calibration_phase(readings)
    host_constants_phase(torch, C, quickstart, Request)
    lap("5c")

    check_ssm_scan(torch, ref, ss, gen, records,
                   [(arch, LLM_BATCH, l, C.get(arch).resolved_ssm_heads, arch == "rwkv6-3b",
                     "per-head" if arch == "rwkv6-3b" else "zamba2")
                    for arch in LLM_ARCHS for l in llm_groups[arch]])
    print("[6] ssm_scan agrees with its plain version", flush=True)
    lap("6")

    for arch in LLM_ARCHS + ATTN_ARCHS + ZOO_ARCHS:
        t0 = time.perf_counter()
        cut = check_llm_cut(torch, C, tf, arch)
        print(f"[7] {arch} cut, card vs CPU, rms err / rms: {json.dumps(cut)} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    cut = check_moe_cut(torch, C, tf, moe)
    print(f"[7] {LLAMA4} MoE layer, card vs CPU: {json.dumps(cut)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    lap("7")

    for arch in LLM_ARCHS + ATTN_ARCHS:
        by_path[arch] = serve_llm_phase(torch, C, tf, ops, serve_llm, arch,
                                        "8b" if arch in LONG_ARCHS else "8")
    lap("8-8b")
    cfg = llm_config(C, LLAMA4)
    print(f"[8c] {LLAMA4} cut to {LLAMA4_LAYERS} layers: {weights_gib(cfg):.1f} GiB of weights, "
          f"largest prefill transient {prefill_transient_gib(cfg, max(LLAMA4_PROMPTS)):.1f} GiB "
          f"(reckoned), of the card's ~{CARD_GIB:.0f}", flush=True)
    for arch in ZOO_ARCHS:
        by_path[arch] = serve_llm_phase(torch, C, tf, ops, serve_llm, arch, "8c")
    lap("8c")
    train_phase(torch, C, tf, ops, moe)
    lap("13")
    by_path["14 sharding"] = sharding_phase(torch, C, ops, ref, fa, ss)
    lap("14")
    known_answers_phase(torch)
    dryrun_phase()
    ops.reset_launches()
    by_path["15 counted"] = counted_steps_phase(torch, C, ops, serve_llm)
    lap("15")

    cluster_phase()
    lap("9")
    _, phase10 = fleet_phase()
    lap("10")
    fast_phase(phase10)
    lap("11")
    figures_phase()
    lap("12")

    kernels = kernel_records(records, by_path)
    for k in kernels:
        sums = k["sums"]
        print(f"[sums] {k['name']}: shapes of Table 5's ends "
              f"{json.dumps(sums['table5_ends'])}; the others {json.dumps(sums['others'])}",
              flush=True)
    print(f"total {time.perf_counter() - t_all:.1f} s", flush=True)
    print(smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
