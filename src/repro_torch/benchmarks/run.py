"""Benchmark harness on the ported core — one module per paper table/figure.

Prints ``name,value,derived`` CSV rows.  Default is quick mode (shorter
traces, fewer combos); ``--full`` runs the paper-scale sweeps; ``--only
<name>`` runs a single module.  ``--hw`` names the profiler's constant set:
``h100`` (``H100_SXM``, the default: simulated numbers for the paper's
figures on the card) or ``reference`` (the JAX reference's constants, under
which every row is the reference script's).  Counterpart of
``benchmarks/run.py``; the kernel microbenchmarks and the roofline table
(``kernels_bench``, ``roofline``) wait for the port of the dry-run.

``--smoke`` is the CI-style pass: the event-vs-tick smoke set and the
shared-cluster, predictive, cross-batch, scale and elastic smokes, each
writing its JSON under ``--out`` as ``<BENCH name>.torch_<hw>_smoke.json``,
and the event clock's parity check.  Under ``--hw reference`` the
regression gate (``check_regression``) then holds them to the committed
``BENCH_*.json`` in ``--baselines``.  It needs no card.

  PYTHONPATH=src python -m repro_torch.benchmarks.run [--hw reference] [--only e2e]
  PYTHONPATH=src python -m repro_torch.benchmarks.run --smoke --hw reference
"""
from __future__ import annotations

import argparse
import importlib
import os
import sys
import time
import traceback
from typing import List, Optional, Sequence, Tuple

from repro_torch.benchmarks.common import Row, emit
from repro_torch.core.profiler import HARDWARE, H100_SXM, Hardware

MODULES = [
    "parallelism_scaling",     # Fig. 3 / Appendix A
    "replica_demand",          # Fig. 4
    "e2e",                     # Fig. 10
    "placement_switch",        # Fig. 11
    "vr_distribution",         # Fig. 12
    "adjust_on_dispatch",      # Fig. 13
    "ablation",                # Fig. 14
    "slo_sensitivity",         # Fig. 15
    "dispatcher_scalability",  # Table 4, on launch/dispatcher_scalability.py
    "batch_effects",           # Fig. 17 / Appendix E.1
]

# the checkout's root, which holds the committed BENCH_*.json baselines
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

# (committed baseline, the smoke's BENCH stem, the e2e function writing it)
SMOKES = (
    ("BENCH_event_sim.json", "BENCH_event_sim", None),
    ("BENCH_shared_cluster.json", "BENCH_shared", "run_shared_smoke"),
    ("BENCH_unified_clock.json", "BENCH_unified_clock", None),
    ("BENCH_predictive.json", "BENCH_predictive", "run_predictive_smoke"),
    ("BENCH_cross_batch.json", "BENCH_cross_batch", "run_cross_batch_smoke"),
    ("BENCH_scale.json", "BENCH_scale", "run_scale_smoke"),
    ("BENCH_elastic.json", "BENCH_elastic", "run_elastic_smoke"),
)


def run_module(name: str, quick: bool = True, hw: Hardware = H100_SXM) -> List[Row]:
    return importlib.import_module(f"repro_torch.benchmarks.{name}").run(quick=quick, hw=hw)


def smoke_path(out: str, stem: str, hw: Hardware) -> str:
    return os.path.join(out, f"{stem}.torch_{hw_key(hw)}_smoke.json")


def hw_key(hw: Hardware) -> str:
    return next(k for k, v in HARDWARE.items() if v == hw)


def run_smoke(out: str, hw: Hardware, baselines: Optional[str] = ROOT,
              file=None) -> Tuple[bool, List[str]]:
    """The smoke pass (the module docstring); returns whether the event
    clock reproduced the tick clock's metrics and the gate's problems
    (none unless ``baselines`` names a directory of committed BENCH files)."""
    from repro_torch.benchmarks import e2e
    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    print("# --- e2e (smoke) ---", flush=True, file=file)
    rows = e2e.run_smoke(bench_path=smoke_path(out, "BENCH_event_sim", hw),
                         unified_bench_path=smoke_path(out, "BENCH_unified_clock", hw), hw=hw)
    emit(rows, file=file)
    print(f"# e2e smoke took {time.perf_counter() - t0:.1f}s", flush=True, file=file)
    for _, stem, fn in SMOKES:
        if fn is None:
            continue
        t0 = time.perf_counter()
        print(f"# --- e2e ({fn}) ---", flush=True, file=file)
        emit(getattr(e2e, fn)(bench_path=smoke_path(out, stem, hw), hw=hw), file=file)
        print(f"# {fn} took {time.perf_counter() - t0:.1f}s", flush=True, file=file)
    # event-vs-tick parity is the smoke pass's one hard check; the row must
    # be present — a missing row is a broken check, not a passing one
    parity = [v for n, v, _ in rows if n.endswith("metrics_match_event_vs_tick")]
    parity_ok = len(parity) == 1 and parity[0] == 1.0
    if not parity_ok:
        print("# SMOKE FAILURE: event clock diverged from tick clock", flush=True, file=file)
    problems: List[str] = []
    if baselines:
        from repro_torch.benchmarks import check_regression
        print("# --- check_regression ---", flush=True, file=file)
        problems = check_regression.run_checks(
            [(os.path.join(baselines, base), smoke_path(out, stem, hw))
             for base, stem, _ in SMOKES])
        for p in problems:
            print(f"# REGRESSION: {p}", flush=True, file=file)
        if not problems:
            print("# check_regression: OK", flush=True, file=file)
    return parity_ok, problems


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hw", choices=sorted(HARDWARE), default="h100",
                    help="the profiler's constant set: H100_SXM or the JAX reference's")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--only", default=None, choices=MODULES)
    ap.add_argument("--smoke", action="store_true",
                    help="CI-style fast pass: the e2e smoke set with the event-vs-tick "
                         "check and the fleet and scale smokes; under --hw reference, "
                         "the regression gate against the committed baselines")
    ap.add_argument("--out", default="results",
                    help="directory of --smoke's JSON (default: results)")
    ap.add_argument("--baselines", default=ROOT,
                    help="directory of the committed BENCH_*.json (default: the checkout)")
    args = ap.parse_args(argv)
    hw = HARDWARE[args.hw]
    if args.smoke:
        parity_ok, problems = run_smoke(args.out, hw,
                                        args.baselines if args.hw == "reference" else None)
        return 0 if parity_ok and not problems else 1
    ok = True
    print(f"# simulated: the profiler's {hw.name} constants, not measured", flush=True)
    for name in [args.only] if args.only else MODULES:
        t0 = time.perf_counter()
        print(f"# --- {name} ---", flush=True)
        try:
            emit(run_module(name, quick=not args.full, hw=hw))
        except Exception as e:  # keep the harness going; report at the end
            ok = False
            traceback.print_exc()
            print(f"{name}/ERROR,{-1},{type(e).__name__}: {e}", flush=True)
        print(f"# {name} took {time.perf_counter() - t0:.1f}s", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
