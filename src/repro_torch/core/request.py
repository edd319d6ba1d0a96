"""Requests, stages, and dispatch-plan records (the paper's Γ abstraction)."""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Tuple

STAGES = ("E", "D", "C")

_req_counter = itertools.count()


@dataclasses.dataclass
class Request:
    """One generative-vision request."""
    pipeline: str                 # pipeline config name (sd3/flux/...)
    resolution: int               # target output resolution (square)
    seconds: float = 0.0          # video duration; 0 for images
    arrival: float = 0.0          # arrival timestamp (s)
    deadline: float = 0.0         # SLO deadline (absolute, s)
    cond_len: int = 77            # prompt token count
    rid: int = dataclasses.field(default_factory=lambda: next(_req_counter))

    # runtime bookkeeping (filled by the engine)
    stage_done: Dict[str, float] = dataclasses.field(default_factory=dict)
    dispatched: Dict[str, "DispatchPlan"] = dataclasses.field(default_factory=dict)

    @property
    def finished(self) -> bool:
        return "C" in self.stage_done

    @property
    def finish_time(self) -> float:
        return self.stage_done.get("C", float("inf"))

    @property
    def latency(self) -> float:
        return self.finish_time - self.arrival

    @property
    def on_time(self) -> bool:
        return self.finished and self.finish_time <= self.deadline

    def key(self) -> Tuple[str, int, float]:
        """Workload-class key used by the profiler's tables."""
        return (self.pipeline, self.resolution, self.seconds)


@dataclasses.dataclass
class DispatchPlan:
    """Γ_r^s = (r, G_r^s, {s: φ_s}) — stage-level dispatch record."""
    rid: int
    stage: str                     # "E" | "D" | "C"
    workers: Tuple[int, ...]       # chip ids
    degree: int                    # SP degree (in scheduling units)
    parallelism: str = "ulysses"   # φ_s: ulysses | scan-chunk | spatial
    # execution bookkeeping
    start: float = -1.0
    finish: float = -1.0
    merged_with: Optional[str] = None   # stage merged into this plan's run

    @property
    def launched(self) -> bool:
        return self.start >= 0.0
