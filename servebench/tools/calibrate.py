"""Measure what a traffic mix fixes once: each class's standalone latency,
and the knee (the highest rate whose backlog does not grow over a window).

  python3 servebench/tools/calibrate.py --workload sd3.saturated --seed 7 \\
      --standalone 5 --rates 1.5,2,2.5,3 --seconds 30

One process: set-up as a run, then each class served alone ``--standalone``
times (one request a ``serve`` call; the median wall time is the class's
standalone latency), then an open-loop window at each rate of ``--rates``
(requests a second; the mix's load is taken as 1). For each rate it prints
the requests, the mean latency of the first and last third of them by due
time, the 95th percentile, and how long after the window the last one
completed. Nothing is written into the mix: copy the numbers by hand.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--standalone", type=int, default=5)
    ap.add_argument("--rates", default="")
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from servebench import harness, program, weights, window
    from servebench.traffic import generator

    c = harness.cell(harness.load_benchmark(), args.workload)
    cfg, mix = c["cfg"], c["mix"]
    dev = torch.device("cuda", 0)
    w = weights.for_config(cfg, dev, args.seed)
    pcfg = program.config(cfg)
    pipe = program.pipeline(pcfg, w)
    classes = generator.classes(mix)
    program.serve(pcfg, [program.request(pcfg, r, s, 0.0, 1.0, mix["cond_len"])
                         for r, s in classes], pipe, dev, args.seed, num_steps=1)
    torch.cuda.synchronize()
    out = {"workload": args.workload, "device": torch.cuda.get_device_name(dev),
           "standalone_s": {}, "sweep": []}
    for res, sec in classes if args.standalone > 0 else ():
        times = []
        for i in range(args.standalone + 1):
            req = program.request(pcfg, res, sec, 0.0, 10.0, mix["cond_len"])
            t = time.perf_counter()
            program.serve(pcfg, [req], pipe, dev, args.seed + i)
            times.append(time.perf_counter() - t)
        out["standalone_s"][f"{res}x{sec:g}"] = statistics.median(times[1:])
        print(f"standalone {res}x{sec:g}: {[round(x, 4) for x in times]}", flush=True)
    for rate in [float(x) for x in args.rates.split(",") if x]:
        m = dict(mix, kind="open", knee_per_s=rate, load=1.0)
        r = window.drive(pcfg, pipe, cfg, m, dev, args.seed, args.seconds, set())
        done = sorted(r.completed, key=lambda q: q.due)
        third = max(1, len(done) // 3)
        row = {"rate": rate, "requests": len(r.requests), "completed": len(done),
               "mean_first_third_s": statistics.mean(q.latency for q in done[:third]),
               "mean_last_third_s": statistics.mean(q.latency for q in done[-third:]),
               "p95_s": float(np.percentile([q.latency for q in done], 95)),
               "mean_s": statistics.mean(q.latency for q in done),
               "slo_pct": 100.0 * sum(q.latency <= q.slo_s for q in done) / len(r.requests),
               "drain_s": r.end - args.seconds, "calls": len(r.calls)}
        out["sweep"].append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
