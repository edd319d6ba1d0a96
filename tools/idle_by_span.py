"""Idle device time by the port's innermost span, and busy time by stage.

  PYTHONPATH=src python tools/idle_by_span.py --workload sd3.saturated --seed 2147483659

Runs one cell's traced run through the benchmark's harness
(``servebench.harness.run`` with tracing on, on the first CUDA device),
keeps the profiler's raw device events and the port's spans
(``repro_torch.trace``), and attributes

- each idle gap of the device in the traced window to the innermost span
  open on the host at the gap's middle (``no span`` outside every call);
- device busy time to the stage span (``encode``, ``diffuse``, ``decode``)
  whose device interval holds it (``no stage`` elsewhere).

It prints the harness's result line, the two tables, the host's lead by
DDIM step, what the spans' attributes count and the records' mean Decode
time (which ``decode_ms`` reads from the spans), and writes all of it to
``chiprun_out/idle_by_span.<workload>.<seed>.json``. It exits non-zero
where its idle total is not the harness's within 1%. ``attribute`` and
``counts`` are pure functions of events and spans.
"""
from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

ROOT = Path(__file__).resolve().parents[1]
NO_SPAN = "no span"
NO_STAGE = "no stage"
STAGES = ("encode", "diffuse", "decode")


def _union(intervals) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _innermost(spans, points: Sequence[int]) -> List[str]:
    """For each of the ascending ``points``, the name of the innermost span
    whose host interval holds it. Spans of one thread nest, so a stack of
    those open at the point gives it."""
    order = sorted((s for s in spans if s.host_end_ns is not None),
                   key=lambda s: (s.host_start_ns, -s.host_end_ns))
    out, stack, i = [], [], 0
    for p in points:
        while i < len(order) and order[i].host_start_ns <= p:
            while stack and stack[-1].host_end_ns <= order[i].host_start_ns:
                stack.pop()
            stack.append(order[i])
            i += 1
        while stack and stack[-1].host_end_ns <= p:
            stack.pop()
        out.append(stack[-1].name if stack else NO_SPAN)
    return out


def attribute(ops: Sequence[Tuple[int, int]], spans, t0_ns: int, t1_ns: int) -> dict:
    """Idle and busy seconds of the window [t0_ns, t1_ns): ``ops`` are the
    device operations' (start, end), ``spans`` the port's spans (host and
    device times on the same clock). Busy time is the union of the
    operations clipped to the window, as the harness takes it."""
    busy = _union((max(s, t0_ns), min(e, t1_ns)) for s, e in ops if min(e, t1_ns) > max(s, t0_ns))
    gaps = [(a_end, b_start) for (_, a_end), (b_start, _) in zip(busy, busy[1:])]
    gaps = [(t0_ns, busy[0][0])] + gaps + [(busy[-1][1], t1_ns)] if busy else [(t0_ns, t1_ns)]
    gaps = [(s, e) for s, e in gaps if e > s]
    idle: Dict[str, int] = collections.Counter()
    for (s, e), name in zip(gaps, _innermost(spans, [(s + e) // 2 for s, e in gaps])):
        idle[name] += e - s
    starts = [s for s, _ in busy]
    stage_ns: Dict[str, int] = collections.Counter()
    for sp in spans:
        if sp.name not in STAGES or sp.device_start_ns is None:
            continue
        lo, hi = sp.device_start_ns, sp.device_end_ns
        k = max(0, bisect.bisect_right(starts, lo) - 1)
        while k < len(busy) and busy[k][0] < hi:
            stage_ns[sp.name] += max(0, min(busy[k][1], hi) - max(busy[k][0], lo))
            k += 1
    busy_ns = sum(e - s for s, e in busy)
    stage_ns[NO_STAGE] = busy_ns - sum(stage_ns.values())
    return {"window_s": (t1_ns - t0_ns) / 1e9, "busy_s": busy_ns / 1e9,
            "idle_s": sum(idle.values()) / 1e9,
            "idle_by_span": {k: v / 1e9 for k, v in idle.most_common()},
            "busy_by_stage": {k: v / 1e9 for k, v in stage_ns.most_common()}}


def counts(spans) -> dict:
    """What the spans' attributes say: plans and their units, dispatch
    rounds with the pending requests, decisions and co-requests they saw,
    launches with their batch and classes, whether each served request has
    exactly one launch (``rids``), the anchors' largest error, and the
    host's lead on the device by DDIM step (median ms, with its timestep)."""
    by = collections.defaultdict(list)
    for s in spans:
        by[s.name].append(s)
    rids = [r for s in by["launch"] for r in s.attrs["rids"]]
    served = sum(s.attrs["requests"] for s in by["serve"])
    lead: Dict[int, list] = collections.defaultdict(list)
    for s in by["step"]:
        if s.device_end_ns is not None:
            lead[(s.attrs["step"], s.attrs["t"])].append((s.device_end_ns - s.host_end_ns) / 1e6)
    return {
        "serve_calls": len(by["serve"]), "requests": served,
        "anchor_err_us_max": max((s.attrs.get("anchor_err_ns", 0) for s in by["serve"]),
                                 default=0) / 1e3,
        "plans": len(by["plan"]), "plan_units": sorted({s.attrs["units"] for s in by["plan"]}),
        "dispatch_rounds": len(by["dispatch"]),
        "pending_mean": statistics.fmean(s.attrs["pending"] for s in by["dispatch"])
        if by["dispatch"] else 0.0,
        "decisions": sum(s.attrs["decisions"] for s in by["dispatch"]),
        "corequests": sum(s.attrs["corequests"] for s in by["dispatch"]),
        "launches": len(by["launch"]),
        "batch_mean": statistics.fmean(s.attrs["batch"] for s in by["launch"])
        if by["launch"] else 0.0,
        "classes": sorted(collections.Counter(
            (s.attrs["resolution"], s.attrs["seconds"], s.attrs["steps"])
            for s in by["launch"]).items()),
        "each_request_once": len(rids) == len(set(rids)) == served,
        "lead_ms_by_step": [[i, t, statistics.median(v)] for (i, t), v in sorted(lead.items())],
    }


def _table(title: str, rows: Dict[str, float], total: float) -> str:
    lines = [f"{title} (s, share)"]
    lines += [f"  {k:<12} {v:10.4f} {100 * v / total if total else 0:6.1f}%"
              for k, v in rows.items()]
    return "\n".join(lines)


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=None,
                    help="the window (default: BENCHMARK.json's run_seconds)")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"))
    args = ap.parse_args(argv)
    build = ROOT / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    from repro_torch import trace
    from servebench import harness
    from servebench import trace as tracing

    kept = {}

    class Keeping(tracing.Tracer):
        """The harness's tracer, keeping the raw device operations."""

        def summary(self, calls_ns):
            kept["ops"] = [(ev.start_ns(), ev.end_ns())
                           for ev in self.prof.profiler.kineto_results.events()
                           if ev.device_type() == torch.autograd.DeviceType.CUDA
                           and not ev.is_user_annotation()]
            kept["window"] = (self.t0_ns, self.t1_ns)
            return super().summary(calls_ns)

    bench = harness.load_benchmark()
    c = harness.cell(bench, args.workload)
    seconds = args.seconds or bench["run_seconds"]
    tracing.Tracer = Keeping
    trace.clear()
    out, run = harness.run(c, args.seed, seconds, True, torch.device("cuda", 0), t_start)
    print(json.dumps({k: v for k, v in out.items() if k != "compared"}))
    spans = trace.spans()
    att = attribute(kept["ops"], spans, *kept["window"])
    cnt = counts([s for s in spans if s.host_start_ns >= run.t0_ns])
    harness_idle = run.trace["window_s"] - run.trace["busy_s"]
    att["harness_idle_s"] = harness_idle
    att["dropped_spans"] = trace.dropped()
    att["records_decode_ms"] = statistics.fmean(la.stage_ms["C"] for la in run.launches)
    print(_table("idle by innermost span", att["idle_by_span"], att["idle_s"]))
    print(_table("busy by stage span", att["busy_by_stage"], att["busy_s"]))
    print("lead by step (index, t, median ms):", cnt["lead_ms_by_step"])
    print("counts:", json.dumps({k: v for k, v in cnt.items() if k != "lead_ms_by_step"}))
    print(f"idle {att['idle_s']:.4f} s, harness {harness_idle:.4f} s; "
          f"dropped spans {att['dropped_spans']}; the records' stage_ms['C'] "
          f"{att['records_decode_ms']:.6f} ms a launch")
    Path(args.out).mkdir(parents=True, exist_ok=True)
    path = Path(args.out) / f"idle_by_span.{args.workload}.{args.seed}.json"
    path.write_text(json.dumps({"result": out, "attribution": att, "counts": cnt}, indent=1))
    ok = abs(att["idle_s"] - harness_idle) <= 0.01 * max(harness_idle, 1e-9)
    return 0 if ok and out["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
