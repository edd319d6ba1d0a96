"""Table 4: the dispatch ILP's solve time per tick, 128 to 8192 GPUs.

The pending set grows with the pool (20 flux requests per 128 GPUs, classes
drawn from flux's Table 5 mixes, deadline 2.5x each request's pipeline
time), and each size is dispatched three times against the same frozen
pending set on an all-idle plan:

* ``solve_ms`` — a cold dispatch on a fresh incremental dispatcher
  (``Dispatcher(incremental=True)``, which may take the solver's exact
  shortcuts: ``ilp.solve(dp=True)``);
* ``warm_solve_ms`` — a second dispatch on a plain dispatcher, whose
  previous choices warm-start the incumbent of a full re-solve;
* ``incremental_solve_ms`` — a second dispatch on the incremental
  dispatcher: the (options, budgets) signature is unchanged, so the
  previous solution is reused without a solve (nodes 0).

The nodes-explored columns depend only on the instance; under
``--hw reference`` they are the reference's (``benchmarks/
dispatcher_scalability.py``).  The times are the host's.  No tensor is
computed, so it needs no card.

  PYTHONPATH=src python -m repro_torch.launch.dispatcher_scalability \\
      [--full] [--hw reference]
"""
from __future__ import annotations

import argparse
import random
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import repro_torch.configs as configs
from repro_torch.core.dispatcher import Dispatcher
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.profiler import HARDWARE, H100_SXM, Hardware, Profiler
from repro_torch.core.request import Request
from repro_torch.core.workloads import MIXES

QUICK_SIZES = (128, 512, 2048, 4096)
FULL_SIZES = (128, 256, 512, 1024, 2048, 4096, 8192)


def _timed_dispatch(disp: Dispatcher, reqs, plan, idle, free) -> Tuple[float, int]:
    t0 = time.perf_counter()
    decisions = disp.dispatch(reqs, plan, set(idle), dict(free), 0.0)
    return (time.perf_counter() - t0) * 1e3, len(decisions)


def run(sizes: Sequence[int] = QUICK_SIZES, hw: Hardware = H100_SXM) -> List[Dict]:
    """One row per pool size: the three dispatches' host ms and solver
    statistics (``Dispatcher.last_solve_stats``)."""
    rows: List[Dict] = []
    prof = Profiler(configs.get("flux"), hw=hw)
    rng = random.Random(0)
    classes = [cls for mix in MIXES["flux"].values() for cls, _ in mix]
    for chips in sizes:
        orch = Orchestrator(prof, num_chips=chips)
        n_req = max(8, 20 * chips // 128)
        reqs = []
        for _ in range(n_req):
            res, sec = rng.choice(classes)
            r = Request("flux", res, float(sec))
            r.deadline = 2.5 * prof.pipeline_time(r)
            reqs.append(r)
        plan = orch.generate(reqs)
        # the solver's search recurses once per pending request: 8192 GPUs
        # pend 1280, past the interpreter's default depth of 1000
        sys.setrecursionlimit(max(sys.getrecursionlimit(), 2 * n_req + 1000))
        idle = set(range(plan.num_units))
        free = {g: 0.0 for g in idle}

        inc = Dispatcher(prof, max_batch=n_req, incremental=True)
        cold_ms, dispatched = _timed_dispatch(inc, reqs, plan, idle, free)
        cold = dict(inc.last_solve_stats)
        base = Dispatcher(prof, max_batch=n_req)
        _timed_dispatch(base, reqs, plan, idle, free)
        warm_ms, _ = _timed_dispatch(base, reqs, plan, idle, free)
        warm = dict(base.last_solve_stats)
        reuse_ms, _ = _timed_dispatch(inc, reqs, plan, idle, free)
        reuse = dict(inc.last_solve_stats)
        rows.append({"gpus": chips, "pending": n_req, "dispatched": dispatched,
                     "solve_ms": cold_ms, "warm_solve_ms": warm_ms,
                     "incremental_solve_ms": reuse_ms,
                     "cold": cold, "warm": warm, "incremental": reuse,
                     "solve_reuses": inc.solve_reuses})
    return rows


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hw", choices=sorted(HARDWARE), default="h100",
                    help="the profiler's constant set: H100_SXM or the JAX "
                         "reference's")
    ap.add_argument("--full", action="store_true",
                    help=f"pool sizes {FULL_SIZES} (default {QUICK_SIZES})")
    args = ap.parse_args(argv)
    rows = run(FULL_SIZES if args.full else QUICK_SIZES, HARDWARE[args.hw])
    for r in rows:
        print(f"{r['gpus']} GPUs, {r['pending']} pending, {r['dispatched']} "
              f"dispatched: cold {r['solve_ms']:.1f} ms ({r['cold']['nodes']} nodes, "
              f"optimal={r['cold']['optimal']}), warm {r['warm_solve_ms']:.1f} ms "
              f"({r['warm']['nodes']} nodes), incremental "
              f"{r['incremental_solve_ms']:.1f} ms ({r['incremental']['nodes']} "
              f"nodes, reused={bool(r['incremental'].get('reused'))})")
    return rows


if __name__ == "__main__":
    main()
