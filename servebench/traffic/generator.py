"""The one traffic generator: every mix is a JSON file beside this one.

A mix names its request classes (resolution, seconds, weight, and for the
tails cells the class's latency limit ``slo_s``), the prompt length, and
one of two arrival kinds:

* ``open``: arrivals at ``load * knee_per_s`` requests a second, Poisson in
  shape. Every seed gets the same requests: N = round(rate * seconds), the
  classes in proportion to their weights (largest remainders), and as gaps
  the N mid-quantiles of the exponential distribution at that rate. The
  seed orders both in blocks of B arrivals, B the sum of the integer
  weights: each block holds each class its weight times, and one gap from
  each of B bands of the sorted gaps (the remainder last), in seed order.
  So every block spans about B / rate seconds with the same classes, and
  two seeds differ in order, not in work or in how it bunches.
* ``closed``: ``clients`` callers that each send their next request when the
  previous one completes. The classes come in blocks that hold each class
  its integer weight times, each block shuffled by the seed.

Table 5's classes and weights (TridentServe, section 8.1) are frozen in the
mix files; ``SLO_SCALE`` is the paper's 2.5 x the class's standalone latency.
"""
from __future__ import annotations

import dataclasses
import json
import math
import random
from pathlib import Path
from typing import Iterator, List, Tuple

HERE = Path(__file__).resolve().parent
SLO_SCALE = 2.5


def load(name: str) -> dict:
    """The mix ``traffic/<name>.json``."""
    return json.loads((HERE / f"{name}.json").read_text())


@dataclasses.dataclass(frozen=True)
class Item:
    index: int          # place in the schedule
    due: float          # seconds after the window opens
    resolution: int
    seconds: float


def classes(mix: dict) -> List[Tuple[int, float]]:
    return [(c["resolution"], float(c["seconds"])) for c in mix["classes"]]


def class_counts(mix: dict, n: int) -> List[int]:
    """n requests split over the classes in proportion to their weights,
    by largest remainder (ties to the earlier class)."""
    w = [c["weight"] for c in mix["classes"]]
    exact = [n * x / sum(w) for x in w]
    counts = [math.floor(e) for e in exact]
    order = sorted(range(len(w)), key=lambda i: (-(exact[i] - counts[i]), i))
    for i in order[:n - sum(counts)]:
        counts[i] += 1
    return counts


def open_schedule(mix: dict, seed: int, seconds: float) -> List[Item]:
    """The open loop's requests, all due inside ``seconds``, in due order."""
    rate = mix["load"] * mix["knee_per_s"]
    n = max(1, round(rate * seconds))
    # N mid-quantiles of Exp(rate) sum to about N / rate; scale them so the
    # last request falls just inside the window
    gaps = [-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)]
    stretch = min(1.0, seconds * (1.0 - 0.5 / n) / sum(gaps))
    rng = random.Random(seed)
    weights = [c["weight"] for c in mix["classes"]]
    size = sum(weights)
    # the sorted gaps in `size` bands, each shuffled; block j takes the j-th of each band
    bands = [gaps[n * i // size:n * (i + 1) // size] for i in range(size)]
    for band in bands:
        rng.shuffle(band)
    order: List[float] = []
    for j in range(-(-n // size)):
        block = [band[j] for band in bands if j < len(band)]
        rng.shuffle(block)
        order += block
    counts = class_counts(mix, n)
    blocks = min(k // w for k, w in zip(counts, weights))
    kinds: List[Tuple[int, float]] = []
    for part in [weights] * blocks + [[k - blocks * w for k, w in zip(counts, weights)]]:
        block = [cls for cls, k in zip(classes(mix), part) for _ in range(k)]
        rng.shuffle(block)
        kinds += block
    gaps = order
    out, t = [], 0.0
    for i, ((res, sec), g) in enumerate(zip(kinds, gaps)):
        t += g * stretch
        out.append(Item(i, t, res, sec))
    return out


def closed_sequence(mix: dict, seed: int) -> Iterator[Tuple[int, float]]:
    """The closed loop's classes in the order the callers send them."""
    block = [cls for cls, c in zip(classes(mix), mix["classes"]) for _ in range(c["weight"])]
    rng = random.Random(seed)
    while True:
        b = list(block)
        rng.shuffle(b)
        yield from b


def slo_s(mix: dict, resolution: int, seconds: float) -> float:
    """The class's latency limit: SLO_SCALE x its standalone latency, as
    measured once on the card and written into the mix."""
    for c in mix["classes"]:
        if c["resolution"] == resolution and float(c["seconds"]) == seconds:
            return SLO_SCALE * c["standalone_s"]
    raise KeyError((resolution, seconds))
