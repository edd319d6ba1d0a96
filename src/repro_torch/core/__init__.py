"""TridentServe core, as ported so far: counterpart of ``repro/core`` for one
pipeline.

* ``placement``    — placement types, Virtual Replicas (Table 3), plans
* ``orchestrator`` — Dynamic Orchestrator (Algorithm 2, Appendix C.1)
* ``dispatcher``   — Resource-Aware Dispatcher (two-step ILP, §6.2, C.2)
* ``ilp``          — in-repo branch-and-bound 0/1 ILP solver
* ``runtime``      — Runtime Engine (§5): reinstance, stage prep with
                     proactive push + handoff buffers, merging execute,
                     Adjust-on-Dispatch placement switches
* ``monitor``      — sliding-window throughput + switch trigger (§5.3)
* ``profiler``     — offline profiler as an analytic model on a named
                     ``Hardware`` set (§5.1)
* ``clock``        — the event-clock kernel (event heap, tick-grid
                     quantization, heartbeat/adaptive idle gap, wake
                     sources) + the ``Lane`` serving stack
* ``simulator``    — discrete-event cluster driving the real planner code
* ``trident``      — the full TridentServe scheduler (Algorithm 1)
* ``baselines``    — B1-B6 (§8.1, Appendix D.2)
* ``workloads``    — Steady/Dynamic/Proprietary traces (Table 5, Fig. 9)

The fleet, unit lending, forecasting and elastic capacity wait.
"""
from repro_torch.core import (baselines, clock, dispatcher, ilp, monitor,
                              orchestrator, placement, profiler, request,
                              runtime, simulator, trident, workloads)

__all__ = ["baselines", "clock", "dispatcher", "ilp", "monitor",
           "orchestrator", "placement", "profiler", "request", "runtime",
           "simulator", "trident", "workloads"]
