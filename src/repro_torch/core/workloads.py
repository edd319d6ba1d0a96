"""Workload traces (paper section 8.1, Table 5): Steady, Dynamic, Proprietary.

Counterpart of ``repro/core/workloads.py``, single-pipeline traces only (the
fleet, cross-batch, scale, lending and elastic traces wait for their
modules). Mix weights and request rates follow Table 5; Poisson arrivals.
The Proprietary trace has the diurnal/tidal shape of Fig. 9, scaled to the
Steady request budget (Appendix D.1). Each request's deadline is
``SLO_SCALE`` times its pipeline time under the given ``Profiler``, so with
the reference's hardware constants the traces are the reference's, bit for
bit.
"""
from __future__ import annotations

import math
import random
from typing import Dict, List, Optional, Tuple

from repro_torch.core.profiler import Profiler
from repro_torch.core.request import Request

# (resolution, seconds) classes and weights per pipeline and level (Table 5)
MIXES: Dict[str, Dict[str, List[Tuple[Tuple[int, float], float]]]] = {
    "sd3": {
        "light": [((128, 0), 2), ((256, 0), 2), ((512, 0), 1), ((1024, 0), 1), ((1536, 0), 1)],
        "medium": [((512, 0), 4), ((128, 0), 1), ((256, 0), 1), ((1024, 0), 1), ((1536, 0), 1)],
        "heavy": [((1024, 0), 2), ((1536, 0), 2), ((128, 0), 1), ((256, 0), 1), ((512, 0), 1)],
    },
    "flux": {
        "light": [((128, 0), 2), ((256, 0), 2), ((512, 0), 2), ((1024, 0), 1),
                  ((2048, 0), 1), ((3072, 0), 1), ((4096, 0), 1)],
        "medium": [((1024, 0), 2), ((2048, 0), 2), ((128, 0), 1), ((256, 0), 1),
                   ((512, 0), 1), ((3072, 0), 1), ((4096, 0), 1)],
        "heavy": [((3072, 0), 2), ((4096, 0), 2), ((128, 0), 1), ((256, 0), 1),
                  ((512, 0), 1), ((1024, 0), 1), ((2048, 0), 1)],
    },
    "cogvideox": {
        "light": [((480, 2), 3), ((720, 2), 3), ((480, 4), 1), ((480, 8), 1), ((480, 10), 1),
                  ((720, 4), 1), ((720, 8), 1), ((720, 10), 1)],
        "medium": [((480, 4), 2), ((480, 8), 2), ((480, 10), 2), ((480, 2), 1),
                   ((720, 2), 1), ((720, 4), 1), ((720, 8), 1), ((720, 10), 1)],
        "heavy": [((720, 4), 2), ((720, 8), 2), ((720, 10), 2), ((480, 2), 1),
                  ((720, 2), 1), ((480, 4), 1), ((480, 8), 1), ((480, 10), 1)],
    },
    "hunyuanvideo": {
        "light": [((540, 1), 3), ((720, 1), 3), ((540, 2), 1), ((540, 4), 1), ((540, 8), 1),
                  ((720, 2), 1), ((720, 4), 1), ((720, 8), 1)],
        "medium": [((540, 2), 2), ((540, 4), 2), ((720, 2), 2), ((540, 1), 1),
                   ((720, 1), 1), ((720, 4), 1), ((540, 8), 1), ((720, 8), 1)],
        "heavy": [((720, 4), 2), ((540, 8), 2), ((720, 8), 2), ((540, 1), 1),
                  ((720, 1), 1), ((540, 2), 1), ((540, 4), 1), ((720, 2), 1)],
    },
}

RATES = {"sd3": 20.0, "flux": 1.5, "cogvideox": 1.0, "hunyuanvideo": 0.5}
T_WIN = {"sd3": 180.0, "flux": 300.0, "cogvideox": 300.0, "hunyuanvideo": 600.0}
SLO_SCALE = 2.5   # SLO = 2.5x latency at optimal parallelism (AlpaServe-style)


def _sample_class(rng: random.Random, mix) -> Tuple[int, float]:
    total = sum(w for _, w in mix)
    x = rng.uniform(0, total)
    acc = 0.0
    for cls, w in mix:
        acc += w
        if x <= acc:
            return cls
    return mix[-1][0]


def _mk_request(pipeline: str, cls: Tuple[int, float], t: float,
                prof: Profiler, slo_scale: float) -> Request:
    res, sec = cls
    req = Request(pipeline, res, float(sec), arrival=t)
    req.deadline = t + slo_scale * prof.pipeline_time(req)
    return req


def steady_trace(pipeline: str, level: str, duration: float, prof: Profiler,
                 seed: int = 0, rate: Optional[float] = None,
                 slo_scale: float = SLO_SCALE) -> List[Request]:
    rng = random.Random(seed)
    rate = rate if rate is not None else RATES[pipeline]
    mix = MIXES[pipeline][level]
    t, out = 0.0, []
    while True:
        t += rng.expovariate(rate)
        if t >= duration:
            break
        out.append(_mk_request(pipeline, _sample_class(rng, mix), t, prof, slo_scale))
    return out


# Fig. 9 left: per-span proportions of the three steady mixes
DYNAMIC_PATTERN = [
    {"light": 0.7, "medium": 0.2, "heavy": 0.1},
    {"light": 0.2, "medium": 0.6, "heavy": 0.2},
    {"light": 0.1, "medium": 0.2, "heavy": 0.7},
    {"light": 0.3, "medium": 0.5, "heavy": 0.2},
    {"light": 0.6, "medium": 0.3, "heavy": 0.1},
    {"light": 0.1, "medium": 0.3, "heavy": 0.6},
]


def dynamic_trace(pipeline: str, duration: float, prof: Profiler,
                  seed: int = 0, rate: Optional[float] = None,
                  slo_scale: float = SLO_SCALE) -> List[Request]:
    rng = random.Random(seed + 17)
    rate = rate if rate is not None else RATES[pipeline]
    span = duration / len(DYNAMIC_PATTERN)
    t, out = 0.0, []
    while True:
        t += rng.expovariate(rate)
        if t >= duration:
            break
        props = DYNAMIC_PATTERN[min(int(t // span), len(DYNAMIC_PATTERN) - 1)]
        level = rng.choices(list(props), weights=list(props.values()))[0]
        out.append(_mk_request(pipeline, _sample_class(rng, MIXES[pipeline][level]),
                               t, prof, slo_scale))
    return out


def proprietary_trace(pipeline: str, duration: float, prof: Profiler,
                      seed: int = 0, rate: Optional[float] = None,
                      slo_scale: float = SLO_SCALE) -> List[Request]:
    """Diurnal/tidal pattern (Fig. 9 right) scaled to the Steady budget."""
    rng = random.Random(seed + 31)
    base = rate if rate is not None else RATES[pipeline]
    t, out = 0.0, []
    while t < duration:
        phase = 2 * math.pi * t / duration
        # two tidal peaks with a burst component
        r = base * (0.35 + 0.8 * max(0.0, math.sin(phase)) ** 2
                    + 0.55 * max(0.0, math.sin(2 * phase + 1.2)) ** 4)
        t += rng.expovariate(max(r, base * 0.05))
        if t >= duration:
            break
        level = rng.choices(["light", "medium", "heavy"],
                            weights=[0.4, 0.4, 0.2])[0]
        out.append(_mk_request(pipeline, _sample_class(rng, MIXES[pipeline][level]),
                               t, prof, slo_scale))
    return out


def make_trace(pipeline: str, workload: str, duration: float, prof: Profiler,
               seed: int = 0, rate: Optional[float] = None,
               slo_scale: float = SLO_SCALE) -> List[Request]:
    if workload in ("light", "medium", "heavy"):
        return steady_trace(pipeline, workload, duration, prof, seed, rate, slo_scale)
    if workload == "dynamic":
        return dynamic_trace(pipeline, duration, prof, seed, rate, slo_scale)
    if workload == "proprietary":
        return proprietary_trace(pipeline, duration, prof, seed, rate, slo_scale)
    raise KeyError(workload)
