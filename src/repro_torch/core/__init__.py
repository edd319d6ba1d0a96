"""TridentServe core, as ported so far: counterpart of ``repro/core``.

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
                     and the fleet's heterogeneous traces
* ``fleet``        — shared-cluster co-serving of heterogeneous pipelines:
                     one placement plan for the whole cluster, chip budgets
                     re-partitioned with the live traffic mix
* ``forecast``     — the demand forecaster behind predictive re-partitioning
* ``lending``      — cross-pipeline unit lending between re-partitions
* ``elastic``      — elastic, failure-prone capacity: the fault injector

The array-backed fast path and cross-node SP wait.
"""
from repro_torch.core import (baselines, clock, dispatcher, elastic, fleet,
                              forecast, ilp, lending, monitor, orchestrator,
                              placement, profiler, request, runtime, simulator,
                              trident, workloads)

__all__ = ["baselines", "clock", "dispatcher", "elastic", "fleet", "forecast",
           "ilp", "lending", "monitor", "orchestrator", "placement", "profiler",
           "request", "runtime", "simulator", "trident", "workloads"]
