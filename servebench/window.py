"""The measured window: arrivals on the cell's schedule, handed to ``serve``.

Whenever the previous ``serve`` call has returned, every request that is
due and not yet handed over goes into one call; the port's Dispatcher
orders them. Each request's ``arrival`` and ``deadline`` are given in the
call's time base (due time minus the call's start, so zero or less; plus
the class's SLO), so the Dispatcher sees the request's true slack.

``serve`` stamps each request's ``stage_done["C"]`` on its own clock, after
waiting for the launch's last CUDA event. A request completes at the
call's return minus the time by which its stamp precedes the call's last
stamp: never earlier than it did. A stamp earlier than the CUDA-event time
of the call's launches up to and including the request's own counts in
``stamps_early``, which the run's check holds at 0. A call that raises
fails all its requests: they never complete.
"""
from __future__ import annotations

import collections
import dataclasses
import random
import sys
import time
import traceback
from typing import Dict, List, Optional, Set

import torch

from servebench import program
from servebench.traffic import generator

CALL_SEED_STRIDE = 4096          # serve(seed=...) of call k in a run of seed s: s * stride + k


@dataclasses.dataclass
class Served:
    index: int                   # place in the run's order of requests
    due: float                   # seconds after the window opened
    resolution: int
    seconds: float
    slo_s: float
    call: int = -1
    pos: int = -1                # place in its call's list of requests
    launch: int = -1
    completion: Optional[float] = None   # seconds after the window opened; None: failed
    output: Optional[torch.Tensor] = None  # kept for the requests the check samples

    @property
    def latency(self) -> float:
        return self.completion - self.due


@dataclasses.dataclass
class Launch:
    members: List[int]           # request indices, lead first
    resolution: int
    seconds: float
    steps: int
    stage_ms: Dict[str, float]
    latent_tokens: int
    cond_tokens: int


@dataclasses.dataclass
class Call:
    seed: int
    start: float                 # seconds after the window opened
    end: float
    launches: List[int] = dataclasses.field(default_factory=list)
    error: Optional[str] = None


@dataclasses.dataclass
class Run:
    cfg: dict
    mix: dict
    seconds: float
    requests: List[Served] = dataclasses.field(default_factory=list)
    launches: List[Launch] = dataclasses.field(default_factory=list)
    calls: List[Call] = dataclasses.field(default_factory=list)
    stamps_early: int = 0
    t0_ns: int = 0               # the window's opening on time.time_ns
    setup_s: float = 0.0
    trace: Optional[dict] = None

    @property
    def completed(self) -> List[Served]:
        return [r for r in self.requests if r.completion is not None]

    @property
    def end(self) -> float:
        """The last completion, seconds after the window opened."""
        return max((r.completion for r in self.completed), default=0.0)


def sample(mix: dict, seed: int, seconds: float) -> Set[int]:
    """Request indices whose outputs the check compares, drawn from the
    seed before the window: one of each class among the open schedule, or
    among the closed loop's first two rounds of callers."""
    rng = random.Random(seed * 7919 + 17)
    if mix["kind"] == "open":
        items = [(it.index, (it.resolution, it.seconds))
                 for it in generator.open_schedule(mix, seed, seconds)]
    else:
        seq = generator.closed_sequence(mix, seed)
        items = [(i, next(seq)) for i in range(2 * mix["clients"])]
    by_class: Dict[tuple, List[int]] = collections.defaultdict(list)
    for i, cls in items:
        by_class[cls].append(i)
    return {rng.choice(v) for _, v in sorted(by_class.items())}


def drive(pcfg, pipe, cfg: dict, mix: dict, device: torch.device, seed: int, seconds: float,
          keep: Set[int]) -> Run:
    """Run the window of ``seconds`` from now and every call begun in it."""
    run = Run(cfg, mix, seconds)
    cond_len = mix["cond_len"]
    queue: collections.deque = collections.deque()

    def add(due: float, cls: tuple) -> None:
        res, sec = cls
        run.requests.append(Served(len(run.requests), due, res, sec,
                                   generator.slo_s(mix, res, sec)))
        queue.append(run.requests[-1])

    if mix["kind"] == "open":
        for it in generator.open_schedule(mix, seed, seconds):
            add(it.due, (it.resolution, it.seconds))
        follow = None
    else:
        follow = generator.closed_sequence(mix, seed)
        for _ in range(mix["clients"]):
            add(0.0, next(follow))

    clock = time.perf_counter
    t0 = clock()
    run.t0_ns = time.time_ns()
    while queue:
        now = clock() - t0
        if queue[0].due > now:
            time.sleep(queue[0].due - now)
            continue
        batch = []
        while queue and queue[0].due <= now:
            batch.append(queue.popleft())
        call = _call(run, pcfg, pipe, device, seed, batch, t0, cond_len, keep)
        if follow is not None:
            # each caller sends its next request when its last one completes
            # (a failed request's caller sends again when the call returns)
            ends = sorted(call.end if r.completion is None else r.completion for r in batch)
            for t in ends:
                if t < seconds:
                    add(t, next(follow))
            queue = collections.deque(sorted(queue, key=lambda r: r.due))
    return run


def _call(run: Run, pcfg, pipe, device, seed: int, batch: List[Served], t0: float,
          cond_len: int, keep: Set[int]) -> Call:
    k = len(run.calls)
    if k >= CALL_SEED_STRIDE:
        raise RuntimeError(f"more than {CALL_SEED_STRIDE} serve calls in one run")
    clock = time.perf_counter
    call = Call(seed * CALL_SEED_STRIDE + k, clock() - t0, 0.0)
    run.calls.append(call)
    reqs = []
    for pos, r in enumerate(batch):
        r.call, r.pos = k, pos
        arrival = r.due - call.start
        reqs.append(program.request(pcfg, r.resolution, r.seconds, arrival, arrival + r.slo_s,
                                    cond_len))
    try:
        records = program.serve(pcfg, reqs, pipe, device, call.seed)
    except Exception:  # a failed call fails its requests; the run goes on
        call.error = traceback.format_exc()
        print(call.error, file=sys.stderr)
        call.end = clock() - t0
        return call
    call.end = clock() - t0
    stamps = [q.stage_done["C"] for q in reqs]
    last = max(stamps)
    launches: Dict[int, List[int]] = {}
    for pos, rec in enumerate(records):
        launches.setdefault(id(rec["stage_ms"]), []).append(pos)
    done_device_s = 0.0
    for members in sorted(launches.values(), key=lambda m: min(stamps[p] for p in m)):
        members.sort(key=lambda p: stamps[p])           # serve stamps the lead first
        rec = records[members[0]]
        run.launches.append(Launch([batch[p].index for p in members], rec["resolution"],
                                   rec["seconds"], rec["num_steps"], dict(rec["stage_ms"]),
                                   pcfg.latent_tokens(rec["resolution"], rec["seconds"]),
                                   cond_len))
        call.launches.append(len(run.launches) - 1)
        done_device_s += sum(rec["stage_ms"].values()) / 1e3
        for p in members:
            r = batch[p]
            r.launch = len(run.launches) - 1
            r.completion = call.end - (last - stamps[p])
            if stamps[p] < done_device_s:
                run.stamps_early += 1
            if r.index in keep:
                r.output = records[p]["output"]
    return call
