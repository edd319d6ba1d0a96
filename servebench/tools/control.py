"""Read the compared number of the program, of the control and of faults,
seed by seed.

  python3 servebench/tools/control.py --workload sd3.saturated --seeds 11,12,13 \\
      --control 3 --seconds 15 --faults fp8_after_first,stuck_middle

For each seed, one whole run of the cell (set-up, a window of ``--seconds``
at the cell's own load, the check) gives the program's ``pixel_gap``. For
the first ``--control`` seeds the control, the plain reference computed
with float8 e4m3 products (one precision below the served bfloat16), is
put in the program's place on the same sampled requests and read the same
way, and so is each fault of ``--faults``, planted in the reference:

- ``fp8_after_first``: every DDIM step but the first in float8;
- ``stuck_middle``: the middle step returns its state unchanged;
- ``reuse_middle``: the middle step reuses the step before's prediction.

One JSON line a seed. The limit in the configuration file is set from
these readings: above the program's largest, below the control's smallest.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@contextlib.contextmanager
def planted(ref, cfg: dict, fault: str):
    """The reference module with ``fault`` planted in its DiT step."""
    import torch
    steps = cfg["pipeline"]["num_steps"]
    ts = ref.linspace32(999, 0, steps).to(torch.int32).tolist()
    mid = steps // 2
    real = ref.dit_forward
    last = {}

    def faulty(W, cfg_, latents, t, cond, fp8=False):
        step = int(t[0])
        if fault == "fp8_after_first":
            return real(W, cfg_, latents, t, cond, fp8=step != ts[0])
        if fault == "stuck_middle" and step == ts[mid]:
            ab = torch.cumprod(1.0 - ref.linspace32(1e-4, 0.02, 1000), 0)
            a, n = ab[ts[mid]], ab[ts[mid + 1]]
            r = (n / a).sqrt()
            return float((1 - r) / ((1 - n).sqrt() - r * (1 - a).sqrt())) * latents
        if fault == "reuse_middle" and step == ts[mid]:
            return last["e"]
        last["e"] = real(W, cfg_, latents, t, cond, fp8)
        return last["e"]

    ref.dit_forward = faulty
    try:
        yield ref
    finally:
        ref.dit_forward = real


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--faults", default="")
    args = ap.parse_args(argv)

    import torch

    from servebench import check, harness, weights

    c = harness.cell(harness.load_benchmark(), args.workload)
    cfg = c["cfg"]
    ref = check.reference(cfg)
    faults = [f for f in args.faults.split(",") if f]
    dev = torch.device("cuda", 0)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        out, run = harness.run(c, seed, args.seconds, False, dev, time.perf_counter())
        row = {"workload": args.workload, "seed": seed, "correct": out["correct"],
               "program": out["compared"]["pixel_gap"]["value"],
               "compared": {k: v["value"] for k, v in out["compared"].items()},
               "setup_s": run.setup_s}
        if i < args.control:
            w = weights.for_config(cfg, dev, seed)
            by = {name: [] for name in ["control"] + faults}
            for r in run.requests:
                if r.output is None:
                    continue
                tokens, noise = check.inputs(run, r, dev)
                want = ref.generate(w, cfg, tokens, noise, r.resolution, r.seconds)
                got = ref.generate(w, cfg, tokens, noise, r.resolution, r.seconds, fp8=True)
                by["control"].append([r.resolution, ref.pixel_gap(got, want)])
                for f in faults:
                    with planted(ref, cfg, f):
                        got = ref.generate(w, cfg, tokens, noise, r.resolution, r.seconds)
                    by[f].append([r.resolution, ref.pixel_gap(got, want)])
                del want, got
            for name, found in by.items():
                row[name] = max(g for _, g in found)
                row[name + "_by_request"] = found
            del w
        del run
        torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
