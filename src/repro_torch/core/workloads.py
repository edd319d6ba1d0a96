"""Workload traces (paper section 8.1, Table 5): Steady, Dynamic, Proprietary.

Counterpart of ``repro/core/workloads.py``: the single-pipeline traces, the
fleet's heterogeneous traces (the shared-cluster mix flip, the bursty-E/C
lending scenario, the diurnal predictive scenario, the cross-lane batching
burst storm) and the elastic scenario's capacity schedules (preemption
storms, a region evacuation).  The scale tier's trace waits for the
array-backed slice.  Mix weights and request rates follow Table 5; Poisson
arrivals.
The Proprietary trace has the diurnal/tidal shape of Fig. 9, scaled to the
Steady request budget (Appendix D.1). Each request's deadline is
``SLO_SCALE`` times its pipeline time under the given ``Profiler``, so with
the reference's hardware constants the traces are the reference's, bit for
bit.
"""
from __future__ import annotations

import math
import random
from typing import Dict, List, Optional, Sequence, Tuple

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


# -- heterogeneous fleet traces (shared-cluster co-serving, core/fleet.py) ----

# Per-pipeline base rates for the 512-chip shared cluster (requests/s),
# and the canonical traffic-mix flip: image-dominated first half, then
# demand tilts hard toward the heavy pipelines mid-trace.  Tuned so both
# phases run the cluster hot (~60-75% busy chips) with very different
# per-pipeline splits — the regime where the partition, not raw capacity,
# decides SLOs.  A static partition sized for the first half strands chips
# on SD3 exactly when Flux/CogVideoX back up.  ``launch/serve_fleet.py
# --scenario shared`` passes these explicitly; ``fleet_trace`` itself
# defaults to a flat single phase.
FLEET_RATES: Dict[str, float] = {"sd3": 60.0, "flux": 3.0, "cogvideox": 2.0}
MIX_FLIP: Tuple[Tuple[float, Dict[str, float]], ...] = (
    (0.5, {"sd3": 2.0, "flux": 1.0 / 3.0, "cogvideox": 0.75}),
    (1.0, {"sd3": 0.5, "flux": 2.0, "cogvideox": 1.25}),
)

# Bursty-E/C unit-lending scenario (``launch/serve_fleet.py --scenario
# lending``): a calm sizing phase spanning the first fleet
# demand window fixes the partition, then three anti-correlated sub-window
# decode bursts — cogvideox (vae-decode dominated aux work) spikes 3.5x
# exactly while sd3 sits in its lull.  The bursts are shorter than the
# adaptive scheduler's hysteresis window + cooldown, so re-partitioning
# cannot chase them: without lending the capacity is stranded on sd3's
# range, with lending the decode overflow rides on borrowed sd3 units.
LENDING_RATES: Dict[str, float] = {"sd3": 40.0, "cogvideox": 1.0}
BURST_MULTS: Dict[str, float] = {"cogvideox": 3.5, "sd3": 0.3}


def bursty_ec_phases(duration: float, head: float = 180.0,
                     burst: float = 60.0, calm: float = 60.0
                     ) -> Tuple[Tuple[float, Dict[str, float]], ...]:
    """Phase spans for the bursty-E/C scenario at any duration: the burst
    *lengths* are what the scenario is tuned around (sub-window, so the
    re-partitioner cannot chase them), so they stay absolute — a longer
    trace gets more bursts, not longer ones.  Durations too short for even
    one absolute burst cycle fall back to the tuned 600 s *shape* (spans
    scale down proportionally), so short smoke traces still burst."""
    if duration < head + burst + calm:
        scale = duration / 600.0
        head, burst, calm = head * scale, burst * scale, calm * scale
    spans: List[Tuple[float, Dict[str, float]]] = [(head / duration, {})]
    t = head
    while t + burst + calm <= duration:
        t += burst
        spans.append((t / duration, dict(BURST_MULTS)))
        # an intermediate calm span only when another burst still fits;
        # otherwise the trailing calm runs to the end as one span (span
        # boundaries restart the arrival streams, so structure matters)
        if t + calm + burst + calm <= duration:
            t += calm
            spans.append((t / duration, {}))
        else:
            break
    if spans[-1][0] < 1.0:
        spans.append((1.0, {}))
    return tuple(spans)


BURSTY_EC: Tuple[Tuple[float, Dict[str, float]], ...] = bursty_ec_phases(600.0)


# Cross-lane dynamic batching scenario (``launch/serve_fleet.py --scenario
# cross_batch``): a long-prompt burst storm over a flux +
# hunyuanvideo fleet.  A steady cheap-prompt base stream (cond_len 77,
# ``light`` mixes) sizes the frozen plans — each lane gets exactly one
# auxiliary encode unit and flux's EDC pool runs ~90% busy.  On top of
# it, correlated waves of prompt-expansion requests (cond_len 4096,
# CROSS_BATCH_MIXES classes with cheap decode so the encode stage is the
# bottleneck) hit both pipelines at once.  Each wave overloads flux's
# single aux <E> unit (~2.4 unit-equivalents of encode demand against 1);
# cross-lane batching packs flux and hunyuanvideo encodes into one
# batched launch on the freer of the two aux units (~1.55x batch
# amortization at cond 4096).  The alternatives are structurally out:
# unit lending cannot help (flux's encode at cond 4096 runs 0.37 s,
# below the 0.5 s ``lend_min_stage_s`` gate, and the correlated waves
# leave no idle-window-clean supply) and re-partitioning cannot help
# (every plan shape carries exactly one aux E unit regardless of chip
# count, the waves are correlated so shares don't move, and each burst
# is shorter than the detection window + cooldown).  Rates are tuned for
# 96 chips; the wave rate sits just below the regime where fused batches
# serialize — raising it inverts the benefit.
CROSS_BATCH_PIPELINES: Tuple[str, ...] = ("flux", "hunyuanvideo")
CROSS_BATCH_MIXES: Dict[str, List[Tuple[Tuple[int, float], float]]] = {
    "flux": [((128, 0), 1), ((256, 0), 1)],
    "hunyuanvideo": [((540, 1), 1)],
}
CROSS_BATCH_BASE_RATES: Dict[str, float] = {"flux": 2.2, "hunyuanvideo": 0.5}
CROSS_BATCH_WAVE_RATES: Dict[str, float] = {"flux": 7.0, "hunyuanvideo": 0.3}
CROSS_BATCH_COND: Dict[str, int] = {"flux": 4096, "hunyuanvideo": 4096}
# the wave stream draws from an offset seed so base and wave arrivals
# stay independent per-pipeline streams (prime offset, same idiom as the
# dynamic/proprietary trace seed offsets)
CROSS_BATCH_WAVE_SEED_OFFSET = 7919


def cross_batch_phases(duration: float, head: float = 240.0,
                       burst: float = 90.0, calm: float = 150.0,
                       pipelines: Sequence[str] = CROSS_BATCH_PIPELINES
                       ) -> Tuple[Tuple[float, Dict[str, float]], ...]:
    """Burst-gate phase spans for the cross-batch wave stream: multiplier
    0 for every pipeline outside the bursts (the wave simply does not
    exist then), 1 inside.  Like ``bursty_ec_phases`` the burst lengths
    are absolute — each burst must stay shorter than the re-partitioner's
    detection window + cooldown — and durations too short for one full
    cycle fall back to the tuned 900 s shape scaled proportionally."""
    if duration < head + burst + calm:
        scale = duration / 900.0
        head, burst, calm = head * scale, burst * scale, calm * scale
    off = {p: 0.0 for p in pipelines}
    on = {p: 1.0 for p in pipelines}
    spans: List[Tuple[float, Dict[str, float]]] = [(head / duration, dict(off))]
    t = head
    while t < duration:
        t += burst
        spans.append((min(t / duration, 1.0), dict(on)))
        if t >= duration:
            break
        t += calm
        spans.append((min(t / duration, 1.0), dict(off)))
    return tuple(spans)


def cross_batch_trace(duration: float, profs: Dict[str, Profiler],
                      seed: int = 0,
                      base_rates: Optional[Dict[str, float]] = None,
                      wave_rates: Optional[Dict[str, float]] = None,
                      head: float = 240.0, burst: float = 90.0,
                      calm: float = 150.0,
                      slo_scale: float = SLO_SCALE) -> List[Request]:
    """Long-prompt burst-storm trace: the cheap-prompt base stream merged
    with the burst-gated cond-4096 wave stream.  Wave requests carry
    ``cond_len`` from CROSS_BATCH_COND and their deadline is recomputed
    from the profiler at that prompt length, so the SLO reflects the work
    actually requested."""
    pipes = CROSS_BATCH_PIPELINES
    base = fleet_trace(pipes, duration, profs, seed=seed,
                       rates=dict(base_rates or CROSS_BATCH_BASE_RATES),
                       level="light", slo_scale=slo_scale)
    wave = fleet_trace(pipes, duration, profs,
                       seed=seed + CROSS_BATCH_WAVE_SEED_OFFSET,
                       rates=dict(wave_rates or CROSS_BATCH_WAVE_RATES),
                       phases=cross_batch_phases(duration, head, burst, calm,
                                                 pipes),
                       mix_override=CROSS_BATCH_MIXES, slo_scale=slo_scale)
    for r in wave:
        r.cond_len = CROSS_BATCH_COND[r.pipeline]
        r.deadline = r.arrival + slo_scale * profs[r.pipeline].pipeline_time(r)
    out = base + wave
    out.sort(key=lambda r: (r.arrival, r.pipeline, r.rid))
    return out


# Elastic, failure-prone fleet scenario (``launch/serve_fleet.py --scenario
# elastic``, core/elastic.py): a steady two-pipeline fleet on a pool that
# refuses to stay fixed.  The schedules below are *capacity* scripts —
# tuples of ``CapacityEvent`` for ``FleetConfig.elastic_schedule`` — not
# traces; pair them with a plain ``fleet_trace`` at ELASTIC_RATES.  Both
# generators track the live node count through their own event sequence,
# so every victim node id is valid in the compacted chip space at apply
# time (the ``CapacityEvent`` contract); degraded nodes are drawn from
# the low end of the pool and victims from the high end, so a loss never
# shifts a still-degraded node's id.  The workload pairs a short-stage
# image pipeline with the *heavy* hunyuanvideo mix (denoise runs of
# 25-75 s, the same order as the notice window): draining matters
# exactly when a stage started inside the lead cannot finish before the
# loss, so the drain-unaware arm both wastes the doomed units' entire
# lead window of execution *and* restarts the victims a full lead later.
# Rates are tuned for a 256-chip starting pool running hot enough that
# losing a storm's worth of nodes visibly backs the queues up — the
# regime where that wasted work decides the recovery tail.
ELASTIC_PIPELINES: Tuple[str, ...] = ("sd3", "hunyuanvideo")
ELASTIC_RATES: Dict[str, float] = {"sd3": 8.0, "hunyuanvideo": 1.6}
ELASTIC_LEVEL = "heavy"            # long-video mix: D-stage ~ lead
ELASTIC_LEAD = 60.0                # spot eviction notice window (s)
ELASTIC_DEGRADE_FACTOR = 2.5       # slow-failing node stage-time multiplier


def preemption_storm_schedule(duration: float, num_chips: int,
                              chips_per_node: int = 8, seed: int = 0,
                              n_storms: int = 2, lead: float = ELASTIC_LEAD,
                              storm_div: int = 6) -> Tuple:
    """Repeated spot-preemption storms with autoscale recovery: each storm
    announces (``lead`` ahead) and then takes a random slice of the upper
    half of the live pool (``live // storm_div`` nodes — smaller divisor,
    bigger storm); a same-size join lands a tenth of the trace later with
    half the announce window.  One low node runs degraded
    (``ELASTIC_DEGRADE_FACTOR``) through the first half.  Deterministic
    per seed."""
    from repro_torch.core.elastic import CapacityEvent
    rng = random.Random(f"elastic-storm:{seed}")
    live = num_chips // chips_per_node
    floor = max(2, live // 2)
    events = []
    bad = rng.randrange(0, max(1, live // 4))
    # the slow node recovers *before* the first storm notice (0.30D - lead):
    # the degrade exercises Monitor detection + quarantine, but a node
    # running at 1/ELASTIC_DEGRADE_FACTOR speed inside the measured
    # recovery windows would confound the drain-vs-requeue comparison the
    # storm exists to make (and, near the knee, tip both arms into
    # collapse regardless of drain policy).
    events.append(CapacityEvent(t=round(duration * 0.05, 3), kind="degrade",
                                nodes=(bad,),
                                factor=ELASTIC_DEGRADE_FACTOR))
    events.append(CapacityEvent(t=round(duration * 0.22, 3), kind="recover",
                                nodes=(bad,)))
    for i in range(n_storms):
        frac = (0.30 + 0.40 * i / (n_storms - 1)) if n_storms > 1 else 0.45
        t = round(duration * frac, 3)
        k = max(1, min(live // storm_div, live - floor))
        if live - k < floor or t - lead <= 0.0:
            break
        victims = tuple(sorted(rng.sample(range(live // 2, live), k)))
        events.append(CapacityEvent(t=t, kind="preempt", nodes=victims,
                                    lead=lead))
        live -= k
        tj = round(t + duration * 0.10, 3)
        if tj < duration * 0.95:
            events.append(CapacityEvent(t=tj, kind="join", n_nodes=k,
                                        lead=lead / 2.0))
            live += k
    return tuple(sorted(events, key=lambda e: (e.t, e.kind)))


def region_evacuation_schedule(duration: float, num_chips: int,
                               chips_per_node: int = 8, seed: int = 0,
                               lead: float = ELASTIC_LEAD) -> Tuple:
    """One announced region evacuation: a quarter of the pool joins first
    (the replacement region, announced ``lead`` ahead so its chips
    pre-warm), then the *old* top quarter is evacuated under a long
    (1.5x) notice window — the migrate-ahead-of-decommission shape.  A
    low node runs degraded early in the trace.  Deterministic per seed."""
    from repro_torch.core.elastic import CapacityEvent
    rng = random.Random(f"elastic-evac:{seed}")
    n0 = num_chips // chips_per_node
    m = max(1, n0 // 4)
    bad = rng.randrange(0, max(1, n0 - m))
    events = [
        CapacityEvent(t=round(duration * 0.12, 3), kind="degrade",
                      nodes=(bad,), factor=ELASTIC_DEGRADE_FACTOR),
        CapacityEvent(t=round(duration * 0.30, 3), kind="recover",
                      nodes=(bad,)),
        CapacityEvent(t=round(duration * 0.40, 3), kind="join", n_nodes=m,
                      lead=lead),
        CapacityEvent(t=round(duration * 0.55, 3), kind="preempt",
                      nodes=tuple(range(n0 - m, n0)), lead=1.5 * lead),
    ]
    return tuple(sorted(events, key=lambda e: (e.t, e.kind)))


# Diurnal predictive scenario (``launch/serve_fleet.py --scenario
# predictive``):
# anti-phase day/night demand between the image and the video pipeline —
# the periodic structure the demand forecaster (core/forecast.py) exists to
# exploit.  Each flip is sharp (square waveform) and each half-period is
# longer than the adaptive scheduler's cooldown, so the adaptive fleet
# *can* chase every flip — it just always arrives a detection window late
# and pays the reload downtime mid-queue; the predictive scheduler
# pre-warms and fires at the flip.  Tuned for ~256 chips: both phases run
# the cluster hot without saturating the favoured pipeline.
PREDICTIVE_RATES: Dict[str, float] = {"sd3": 28.0, "cogvideox": 0.84}


def diurnal_phases(n_periods: int = 3, spans_per_period: int = 2,
                   amp: float = 0.8, lead_pipeline: str = "sd3",
                   anti_pipelines: Sequence[str] = ("cogvideox",),
                   shape: str = "square"
                   ) -> Tuple[Tuple[float, Dict[str, float]], ...]:
    """Piecewise-constant diurnal rate multipliers for ``fleet_trace``:
    ``lead_pipeline`` runs at ``1 + amp*w(t)`` and every anti-phase
    pipeline at ``1 - amp*w(t)``, with ``w`` a unit periodic waveform —
    ``"square"`` (day/night flips every half period, the canonical diurnal
    mix flip) or ``"sine"`` (smooth tides, sampled at span midpoints).
    Fractions are of the total trace duration, so the period is
    ``duration / n_periods``."""
    spans: List[Tuple[float, Dict[str, float]]] = []
    total = n_periods * spans_per_period
    for i in range(total):
        w = math.sin(2.0 * math.pi * (i + 0.5) / spans_per_period)
        if shape == "square":
            w = 1.0 if w >= 0.0 else -1.0
        mults = {lead_pipeline: 1.0 + amp * w}
        for p in anti_pipelines:
            mults[p] = 1.0 - amp * w
        spans.append(((i + 1) / total, mults))
    return tuple(spans)


def phase_shift_phases(flip_frac: float = 0.5, tilt: float = 2.0,
                       lead_pipeline: str = "sd3",
                       anti_pipelines: Sequence[str] = ("cogvideox",)
                       ) -> Tuple[Tuple[float, Dict[str, float]], ...]:
    """One hard phase shift at ``flip_frac`` of the trace: the lead
    pipeline tilts up then down (anti-phase pipelines mirror it) — the
    single-transition sibling of ``diurnal_phases`` for trend-style
    forecaster inputs and MIX_FLIP-shaped scenarios at any tilt."""
    hi = {lead_pipeline: tilt, **{p: 1.0 / tilt for p in anti_pipelines}}
    lo = {lead_pipeline: 1.0 / tilt, **{p: tilt for p in anti_pipelines}}
    return ((flip_frac, hi), (1.0, lo))


def randomized_fleet_scenario(seed: int,
                              pipelines: Sequence[str] = ("sd3", "flux"),
                              periods: int = 1
                              ) -> Tuple[Dict[str, float],
                                         Tuple[Tuple[float, Dict[str, float]],
                                               ...]]:
    """Seeded random (rates, phases) for the multi-lane event/tick parity
    tests: per-pipeline base rates jittered around
    the 128-chip test point and a mid-trace tilt at a random flip point.
    One tuned definition here — like ``FLEET_RATES``/``MIX_FLIP`` — so the
    parity suite and any future bench sweep draw the same scenarios.

    ``periods > 1`` swaps the single flip for a periodic tilt (``2 *
    periods`` equal spans alternating the same random tilt) — the
    forecastable variant the ``predictive`` scheduler's parity runs use.
    The rate/tilt draws are identical either way, so a seed's traffic
    intensity matches across variants."""
    rng = random.Random(f"fleet-scenario:{seed}")
    test_rates = {"sd3": 10.0, "flux": 1.0, "cogvideox": 0.8,
                  "hunyuanvideo": 0.4}
    rates = {p: test_rates.get(p, RATES[p] / 2.0) * rng.uniform(0.6, 1.2)
             for p in pipelines}
    flip = rng.uniform(0.35, 0.65)
    tilt = rng.uniform(1.5, 2.5)
    first, rest = pipelines[0], list(pipelines[1:])
    hi = {first: tilt, **{p: 1.0 / tilt for p in rest}}
    lo = {first: 1.0 / tilt, **{p: tilt for p in rest}}
    if periods <= 1:
        phases = ((flip, hi), (1.0, lo))
    else:
        n = 2 * periods
        phases = tuple(((i + 1) / n, hi if i % 2 == 0 else lo)
                       for i in range(n))
    return rates, phases


def fleet_trace(pipelines: Sequence[str], duration: float,
                profs: Dict[str, Profiler], seed: int = 0,
                rates: Optional[Dict[str, float]] = None,
                phases: Optional[Sequence[Tuple[float, Dict[str, float]]]] = None,
                level: str = "medium",
                slo_scale: float = SLO_SCALE,
                mix_override: Optional[Dict[str, List[Tuple[Tuple[int, float],
                                                            float]]]] = None
                ) -> List[Request]:
    """Merged multi-pipeline trace with piecewise-constant rate multipliers.

    ``phases`` is a sequence of ``(end_fraction, {pipeline: multiplier})``
    spans; within each span pipeline ``p`` arrives as a Poisson process at
    ``rates[p] * multiplier`` (missing multipliers default to 1).  Each
    pipeline draws from its own deterministic stream, so adding a pipeline
    or reordering the list never perturbs the others' arrivals.
    ``mix_override`` maps a pipeline to a class mix used in place of
    ``MIXES[pid][level]`` (scenario-specific mixes like CROSS_BATCH_MIXES
    stay out of the Table 5 tables)."""
    if phases is None:
        phases = ((1.0, {}),)
    out: List[Request] = []
    for pid in pipelines:
        rng = random.Random(f"fleet:{seed}:{pid}")
        base = (rates or FLEET_RATES).get(pid)
        if base is None:   # lazily: alias pipelines have no Table 5 rate
            base = RATES[pid]
        mix = (mix_override or {}).get(pid) or MIXES[pid][level]
        start = 0.0
        for end_frac, mults in phases:
            end = duration * end_frac
            r = base * mults.get(pid, 1.0)
            if r > 0.0:
                t = start
                while True:
                    t += rng.expovariate(r)
                    if t >= end:
                        break
                    out.append(_mk_request(pid, _sample_class(rng, mix), t,
                                           profs[pid], slo_scale))
            start = end
    out.sort(key=lambda r: r.arrival)
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
