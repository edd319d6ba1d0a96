"""Run the sharded paths on a world of ranks and hold them against their
unsharded runs: Ulysses attention, the chunk-parallel scan and the sharded
train step.

``run(world, fn, *args, device=...)`` (or ``World``, which starts a world
and lets the caller wait for it later) starts ``world`` processes (the
``spawn`` start method), joins them into a ``torch.distributed`` world over
gloo with a ``file://`` rendezvous in a fresh temporary directory (no port
is taken), calls ``fn(rank, world, device, *args)`` on each and returns
every rank's result, in rank order. On ``cuda`` every rank runs on
``cuda:0``: gloo carries CUDA tensors through the host, so several ranks
can share one card, which NCCL does not allow. A rank that raises stops
the run; every process is ended before ``run`` returns or raises.

The rank functions:

* ``ulysses_ranks`` — each case's q/k/v drawn from its seed on every rank,
  sharded along L, through ``sequence_parallel.ulysses_attention``; rank 0
  returns each gathered output;
* ``scan_ranks`` — the same for ``scan_chunk_parallel`` (output gathered
  along L, and the final state);
* ``train_ranks`` — each case's model trained ``steps`` steps unsharded (on
  rank 0) and sharded on its mesh from the same seed (or the same given
  state); returns the relative errors of the loss and gradient norm, the
  largest errors of the parameters, of their updates and of the moments,
  and the tokens whose set of experts differs.

Each also returns the rank's kernel launches (``ops.LAUNCHES``).
"""
from __future__ import annotations

import dataclasses
import math
import os
import pickle
import queue as _queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.kernels.ssm_scan import MAX_NEG_LOGW


def _entry(rank: int, world: int, path: str, device: str, backend: str, threads: int,
           fn: Callable, args: tuple, results) -> None:
    import faulthandler

    import torch.distributed as dist

    faulthandler.enable()           # a rank that dies in native code says where
    try:
        if threads:
            torch.set_num_threads(threads)
        if device == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(backend, init_method=f"file://{path}", world_size=world,
                                rank=rank)
        try:
            out = fn(rank, world, torch.device(device), *args)
        finally:
            dist.destroy_process_group()
        # pickled here: the queue's own pickler would share tensors by file
        # descriptor, which dies with the rank
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


class World:
    """``fn(rank, world, device, *args)`` started on ``world`` ranks (every
    rank on ``device``, joined over ``backend``: gloo, or nccl for a world
    of one rank per card; ``threads`` intra-op threads each, 0 = torch's
    default). ``wait()`` -> every rank's result, in rank order; ``close()``
    ends every process still running. Several worlds may run at once."""

    def __init__(self, world: int, fn: Callable, *args, device: str = "cpu", threads: int = 1,
                 timeout: float = 900.0, backend: str = "gloo"):
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.world, self.timeout = world, timeout
        self.tmp = tempfile.mkdtemp(prefix="shard-check-")
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=_entry, daemon=True,
                                  args=(r, world, os.path.join(self.tmp, "rendezvous"), device,
                                        backend, threads, fn, args, self.results))
                      for r in range(world)]
        self.start = time.monotonic()
        try:
            for p in self.procs:
                p.start()
        except BaseException:
            self.close()
            raise

    def wait(self) -> List[Any]:
        got: Dict[int, Any] = {}
        deadline = self.start + self.timeout
        try:
            while len(got) < self.world:
                try:
                    rank, ok, out = self.results.get(
                        timeout=max(1.0, min(10.0, deadline - time.monotonic())))
                except _queue.Empty:
                    dead = [p for p in self.procs if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"a rank died with exit code {dead[0].exitcode}")
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"the world of {self.world} ranks did not finish "
                                           f"in {self.timeout} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {self.world} failed:\n{out}")
                got[rank] = pickle.loads(out)
            for p in self.procs:
                p.join(timeout=60)
            return [got[r] for r in range(self.world)]
        finally:
            self.close()

    def close(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.terminate()
        for p in self.procs:
            if p.pid is not None:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
        shutil.rmtree(self.tmp, ignore_errors=True)


def run(world: int, fn: Callable, *args, device: str = "cpu", threads: int = 1,
        timeout: float = 900.0, backend: str = "gloo") -> List[Any]:
    """``World(...).wait()``: every rank's result, in rank order."""
    return World(world, fn, *args, device=device, threads=threads, timeout=timeout,
                 backend=backend).wait()


def _launches() -> Dict[str, int]:
    from repro_torch.kernels import ops
    return dict(ops.LAUNCHES)


def _delta(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in _launches().items()}


def _model_mesh(world: int, device: torch.device):
    from repro_torch.launch import mesh as mesh_lib
    return mesh_lib.build(mesh_lib.MeshShape(mesh_lib.AXES, (1, world)), device.type)


@dataclasses.dataclass(frozen=True)
class AttnCase:
    """One Ulysses call: q/k/v (B, L, H, D) N(0, 1) from ``seed``."""
    name: str
    b: int
    l: int
    h: int
    d: int
    causal: bool = False
    softcap: float = 0.0
    dtype: str = "float32"
    seed: int = 0


def attn_inputs(case: AttnCase, device) -> tuple:
    from repro_torch import device as _device
    gen = _device.generator(torch.device(device), case.seed)
    dt = getattr(torch, case.dtype)
    return tuple(torch.randn((case.b, case.l, case.h, case.d), generator=gen,
                             device=device).to(dt) for _ in range(3))


def ulysses_ranks(rank: int, world: int, device: torch.device,
                  cases: Sequence[AttnCase]) -> dict:
    """Each case through ``ulysses_attention`` over all ranks -> {"outputs":
    rank 0's gathered (B, L, H, D) outputs (CPU), "launches", "seconds"}."""
    from repro_torch.sharding import sequence_parallel as sp

    mesh = _model_mesh(world, device)
    before, outs, secs = _launches(), [], []
    for case in cases:
        q, k, v = (sp.shard_sequence(t, mesh) for t in attn_inputs(case, device))
        t0 = time.perf_counter()
        out = sp.ulysses_attention(q, k, v, mesh, causal=case.causal, softcap=case.softcap)
        full = sp.gather_sequence(out, mesh)
        if device.type == "cuda":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        outs.append(full.cpu() if rank == 0 else None)
        del q, k, v, out, full
    return {"outputs": outs, "launches": _delta(before), "seconds": secs}


@dataclasses.dataclass(frozen=True)
class ScanCase:
    """One chunk-parallel scan: (B, H, L, K) inputs from ``seed``; ``bonus``
    is rwkv6's strict read, without it the read is inclusive (mamba2);
    ``layout`` "per-head" (rwkv6) or "zamba2" (q and k shared across heads,
    a per-head decay broadcast over K, as ``models/ssm.py`` passes them);
    ``floor``: every decay at the floor exp(-MAX_NEG_LOGW)."""
    name: str
    b: int
    h: int
    l: int
    k: int
    v: int
    bonus: bool
    layout: str = "per-head"
    floor: bool = False
    dtype: str = "float32"
    seed: int = 0


def scan_inputs(case: ScanCase, device) -> tuple:
    """(q, k, v, decay, bonus or None), the same on every rank."""
    from repro_torch import device as _device
    gen = _device.generator(torch.device(device), case.seed)
    dt = getattr(torch, case.dtype)
    b, h, l = case.b, case.h, case.l

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=device)
    hq = h if case.layout == "per-head" else 1
    q, k = (rn(b, hq, l, case.k).to(dt).expand(b, h, l, case.k) for _ in range(2))
    v = rn(b, h, l, case.v).to(dt)
    if case.floor:
        decay = torch.full((b, h, l, case.k), math.exp(-MAX_NEG_LOGW), device=device)
    else:
        decay = torch.exp(-torch.exp(rn(b, h, l, case.k if case.layout == "per-head" else 1)
                                     * 0.3)).expand(b, h, l, case.k)
    bonus = rn(h, case.k) if case.bonus else None
    return q, k, v, decay, bonus


def scan_ranks(rank: int, world: int, device: torch.device,
               cases: Sequence[ScanCase]) -> dict:
    """Each case through ``scan_chunk_parallel`` over all ranks -> {"outputs":
    rank 0's (gathered output (B, H, L, V), final state) pairs (CPU),
    "launches", "seconds"}."""
    from repro_torch.sharding import sequence_parallel as sp

    mesh = _model_mesh(world, device)
    before, outs, secs = _launches(), [], []
    for case in cases:
        q, k, v, decay, bonus = scan_inputs(case, device)
        q, k, v, decay = (sp.shard_sequence(t, mesh, dim=2) for t in (q, k, v, decay))
        t0 = time.perf_counter()
        out, state = sp.scan_chunk_parallel(q, k, v, decay, mesh, bonus=bonus)
        full = sp.gather_sequence(out, mesh, dim=2)
        if device.type == "cuda":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        outs.append((full.cpu(), state.cpu()) if rank == 0 else None)
    return {"outputs": outs, "launches": _delta(before), "seconds": secs}


@dataclasses.dataclass(frozen=True)
class TrainCase:
    """``steps`` train steps of ``arch`` (its smoke config, or the full one
    cut to ``layers``; in ``dtype``) on batches of ``batch`` x ``seq`` on a
    ``mesh`` (data, model) with the ``opts`` (zero, fsdp, seqshard)."""
    arch: str
    mesh: tuple
    opts: tuple = ()
    smoke: bool = True
    layers: Optional[int] = None
    batch: int = 4
    seq: int = 16
    steps: int = 2
    seed: int = 0
    dtype: Optional[str] = None     # the config's own if None


def case_config(case: TrainCase):
    import repro_torch.configs as C
    cfg = C.get_smoke(case.arch) if case.smoke else C.get(case.arch)
    if case.layers:
        cfg = dataclasses.replace(cfg, num_layers=case.layers)
    if case.dtype:
        cfg = dataclasses.replace(cfg, dtype=getattr(torch, case.dtype))
    return cfg


class _Experts(torch.overrides.TorchFunctionMode):
    """Records the expert index of every ``torch.topk`` call inside the
    block (the MoE routing's only one), as each token's set of experts
    (sorted), on the CPU."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.topk:
            self.seen.append(torch.sort(out[1].detach(), dim=-1).values.cpu())
        return out


def _train(cfg, case: TrainCase, device, mesh, state_arrays, init: bool = False) -> tuple:
    """(state, per-step metrics as floats, the recorded expert sets, the
    parameters before the first step if ``init``)."""
    from repro_torch import convert
    from repro_torch.data import pipeline
    from repro_torch.models import transformer
    from repro_torch.sharding import partition
    from repro_torch.training import loop

    opts = set(case.opts)
    if state_arrays is None:
        state = loop.init_state(cfg, case.seed, device, mesh=mesh, zero="zero" in opts,
                                fsdp="fsdp" in opts)
    else:
        state = convert.from_jax_state(cfg, *state_arrays, device=device)
        if mesh is not None:
            state = loop.shard_state(cfg, state, mesh, zero="zero" in opts, fsdp="fsdp" in opts)
    before = {n: p.detach().clone() for n, p in state.params.items()} if init else None
    step = loop.make_train_step(cfg)
    rows = []
    if "seqshard" in opts and mesh is not None:
        transformer.set_activation_sharding(partition.P("data", "model", None))
    try:
        with _Experts() as experts:
            for i in range(case.steps):
                batch = pipeline.to_tensors(pipeline.synthetic_batch(
                    cfg, pipeline.DataConfig(batch=case.batch, seq_len=case.seq), i), device)
                state, m = step(state, batch)
                rows.append({k: float(v) for k, v in m.items()})
    finally:
        transformer.set_activation_sharding(None)
    return state, rows, experts.seen, before


def _gather_experts(seen: list, want: Optional[list]) -> list:
    """Every rank's recorded expert sets -> on rank 0 (``want``: its
    unsharded run's), each call's sets over the whole batch: rank 0's where
    it routed every group, else each batch shard's once, in the order
    ranks first hold them (the ranks that hold one shard record the same
    sets, and DTensor deals the shards out in rank order)."""
    import torch.distributed as dist

    if dist.get_world_size() == 1:
        return seen
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, seen)
    if want is None:
        return []
    out = []
    for c, w in enumerate(want):
        shards = []
        for part in (e[c] for e in every):
            if not any(torch.equal(part, s) for s in shards):
                shards.append(part)
        out.append(shards[0] if shards[0].shape == w.shape else torch.cat(shards))
    return out


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _rms(t: torch.Tensor) -> float:
    return max(t.float().pow(2).mean().sqrt().item(), 1e-30)


def train_ranks(rank: int, world: int, device: torch.device, cases: Sequence[TrainCase],
                state_arrays: Optional[dict] = None) -> list:
    """Each case unsharded (rank 0) and sharded (every rank) from the same
    seed, or from ``state_arrays[arch]`` (the reference's (params, mu, nu,
    step) as numpy, through ``convert.from_jax_state``) -> one row per case
    on rank 0: the loss, nll, aux and gradient norm of each step on both
    sides (``steps``), the largest relative error of the loss, gradient
    norm and aux loss (absolute where the aux loss is 0), and each tensor's largest error after the last step, with the
    name of the worst: ``params``, max |err| / rms(want) over the
    parameters that were not all zeros before the first step; ``updates``,
    rms(err) / rms(want - before) over every parameter, the error against
    the steps taken (while the learning rate is small a parameter's value
    hides its steps), and ``updates_max``, the same with max |err| (AdamW's
    step lr * g / (|g| + eps) turns a gradient's rounding near |g| ~ eps
    into a change of the order of the step, so the largest element reads
    that rounding); ``moments``, max |err| / (|want| + rms(want)) over
    both AdamW moments, each element against its own value and, near zero,
    against the tensor's rms, and ``moments_of_max``, max |err| /
    max |want| (g^2 and an embedding's gradient are heavy-tailed). Also
    the tokens whose set of experts differs (``topk_differ`` of
    ``tokens``), the routing groups rank 0 routed in the sharded step
    against all of them (``groups``), the host seconds of each side and
    the launches. On ``cuda`` TF32 is off and each side's ops are
    deterministic (the MoE's gathers sum their backward by atomics
    otherwise, in an order that changes from run to run)."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib

    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True, warn_only=True)
    out = []
    for case in cases:
        cfg = case_config(case)
        arrays = None if state_arrays is None else state_arrays[case.arch]
        want = None
        before = _launches()
        t0 = time.perf_counter()
        if rank == 0:
            ref_state, ref_rows, ref_experts, init = _train(cfg, case, device, None, arrays,
                                                            init=True)
            zeros = {n for n, p in init.items() if not bool(p.any())}
            want = {"params": {n: p.detach() for n, p in ref_state.params.items()},
                    "mu": ref_state.opt.mu, "nu": ref_state.opt.nu,
                    "step_rms": {n: _rms(p.detach() - init[n])
                                 for n, p in ref_state.params.items()}}
            del ref_state, init
            if device.type == "cuda":
                torch.cuda.empty_cache()
        t1 = time.perf_counter()
        dist.barrier()
        mesh = mesh_lib.build(mesh_lib.MeshShape(mesh_lib.AXES, tuple(case.mesh)), device.type)
        t2 = time.perf_counter()
        state, rows, experts, _ = _train(cfg, case, device, mesh, arrays)
        if device.type == "cuda":
            torch.cuda.synchronize()
        t3 = time.perf_counter()
        groups = sum(int(t.shape[0]) for t in experts)       # routed on this rank
        experts = _gather_experts(experts, ref_experts if rank == 0 else None)
        row = {"arch": case.arch, "mesh": "x".join(map(str, case.mesh)),
               "opts": ",".join(case.opts), "world": world,
               "backend": dist.get_backend(),
               "host_s": {"unsharded": t1 - t0, "sharded": t3 - t2}}
        errs = {k: (0.0, None) for k in ("params", "updates", "updates_max", "moments",
                                         "moments_of_max")}

        def worst(kind: str, err: float, name: str) -> None:
            if err >= errs[kind][0]:
                errs[kind] = (err, name)
        for name, p in state.params.items():
            pairs = (("params", p.full_tensor()), ("mu", state.opt.mu[name].full_tensor()),
                     ("nu", state.opt.nu[name].full_tensor()))
            for kind, got in pairs:
                if rank == 0:
                    w = want[kind][name].float()
                    d = (got.float() - w).abs()
                    if kind == "params":
                        dmax = d.max().item()
                        if name not in zeros:
                            worst("params", dmax / _rms(w), name)
                        worst("updates", _rms(d) / want["step_rms"][name], name)
                        worst("updates_max", dmax / want["step_rms"][name], name)
                    else:
                        worst("moments", (d / (w.abs() + _rms(w))).max().item(),
                              f"{kind} {name}")
                        worst("moments_of_max", d.max().item() / max(w.abs().max().item(), 1e-30),
                              f"{kind} {name}")
                    del w, d
                del got
        del state
        if rank == 0:
            row["steps"] = [{"want": a, "got": b} for a, b in zip(ref_rows, rows)]
            row["loss"] = max(_rel(b["loss"], a["loss"]) for a, b in zip(ref_rows, rows))
            for key in ("grad_norm", "aux"):
                row[key] = max(_rel(b[key], a[key]) if a[key] else abs(b[key])
                               for a, b in zip(ref_rows, rows))
            for kind, (err, name) in errs.items():
                row[kind], row[f"worst_{kind}"] = err, name
            if [a.shape for a in ref_experts] != [b.shape for b in experts]:
                raise RuntimeError(f"{case.arch}: the sharded step routed other groups: "
                                   f"{[a.shape for a in ref_experts]} against "
                                   f"{[b.shape for b in experts]}")
            row["topk_differ"] = sum(int((a != b).any(-1).sum())
                                     for a, b in zip(ref_experts, experts))
            row["tokens"] = sum(int(a.shape[0] * a.shape[1]) for a in ref_experts)
            row["groups"] = {"rank0": groups, "all": sum(int(a.shape[0]) for a in ref_experts)}
            row["launches"] = _delta(before)
            out.append(row)
            del want
        if device.type == "cuda":
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def suite_ranks(rank: int, world: int, device: torch.device, attn: Sequence[AttnCase] = (),
                scan: Sequence[ScanCase] = (), train: Sequence[TrainCase] = (),
                state_arrays: Optional[dict] = None) -> dict:
    """``ulysses_ranks``, ``scan_ranks`` and ``train_ranks`` in one world ->
    {"ulysses", "scan", "train"}."""
    return {"ulysses": ulysses_ranks(rank, world, device, attn),
            "scan": scan_ranks(rank, world, device, scan),
            "train": train_ranks(rank, world, device, train, state_arrays)}
