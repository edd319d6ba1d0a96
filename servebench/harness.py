"""One run of one cell: set-up, the window, the metrics, the check.

Everything that belongs to one cell is found by name: the cell in
``BENCHMARK.json``, its configuration file, its traffic mix
(``traffic/<name>.json``), the configuration's plain reference
(``reference/<name>.py``) and each metric's reader (``metrics/<name>.py``,
or the file of the name's part before its first dot, which several
metrics of one quantity share).
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # top-level names, compared whole


def load_benchmark(path: Path = ROOT / "BENCHMARK.json") -> dict:
    return json.loads(path.read_text())


def cell(bench: dict, name: str) -> dict:
    """The cell ``name`` with its configuration, mix and metrics resolved."""
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    from servebench.traffic import generator
    return {"name": name, "chips": w["chips"],
            "cfg": json.loads((ROOT / conf["file"]).read_text()),
            "mix": generator.load(w["traffic"]),
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def reader(name: str) -> Callable:
    """The ``read(run)`` of a metric's reader file."""
    for stem in (name, name.split(".")[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.is_file():
            spec = importlib.util.spec_from_file_location(f"servebench.metrics.{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r} under {HERE / 'metrics'}")


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def run(c: dict, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float) -> Tuple[dict, "window.Run"]:
    """Set up, drive the window, read the metrics and check the outputs:
    the result's line and the run it read. ``t_start``: the process's start
    on ``time.perf_counter``'s clock."""
    from servebench import check, program, trace as tracing, weights, window
    from servebench.traffic import generator

    cfg, mix = c["cfg"], c["mix"]
    w = weights.for_config(cfg, device, seed)
    pcfg = program.config(cfg)
    pipe = program.pipeline(pcfg, w)
    # warm-up: each class once, through serve itself, at one DDIM step
    warm = [program.request(pcfg, res, sec, 0.0, 1.0, mix["cond_len"])
            for res, sec in generator.classes(mix)]
    program.serve(pcfg, warm, pipe, device, seed, num_steps=1)
    keep = window.sample(mix, seed, seconds)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start

    t_window = time.perf_counter()
    tracer = tracing.Tracer() if trace else None
    with tracer or contextlib.nullcontext():
        r = window.drive(pcfg, pipe, cfg, mix, device, seed, seconds, keep)
    r.setup_s = setup_s
    t_drained = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if tracer is not None:
        r.trace = tracer.summary([(r.t0_ns + int(call.start * 1e9),
                                   r.t0_ns + int(call.end * 1e9)) for call in r.calls])
        del tracer
    t_traced = time.perf_counter()

    names = c["per_layer"] if trace else c["end_to_end"]
    metrics: Dict[str, dict] = {}
    for m in names:
        v = reader(m["name"])(r)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # the program's state goes before the reference runs beside the weights
    del pipe
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = check.compare(r, w, device, len(keep))
    print(f"servebench: set-up {setup_s:.1f} s, window and drain {t_drained - t_window:.1f} s, "
          f"trace {t_traced - t_drained:.1f} s, check {time.perf_counter() - t_traced:.1f} s",
          file=sys.stderr)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    out = {"correct": check.passed(checks), "attempted": len(r.requests),
           "failed": sum(q.completion is None for q in r.requests),
           "metrics": metrics, "device": dev}
    if r.trace is not None:
        dev["busy_s"] = r.trace["busy_s"]
        dev["window_s"] = r.trace["window_s"]
        out["breakdown"] = {"device_ops": r.trace["device_ops"],
                            "idle_gaps": r.trace["idle_gaps"]}
    out["compared"] = checks
    return out, r


def main(args, t_start: float) -> int:
    bench = load_benchmark()
    c = cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < c["chips"]:
        print(f"servebench: {args.workload} needs {c['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out, _ = run(c, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), t_start)
    found = forbidden_modules()
    if found:
        print(f"servebench: modules that must not load were loaded: {found}", file=sys.stderr)
        return 3
    for name, chk in out["compared"].items():
        print(f"{name} {chk['value']} limit {chk['limit']}", file=sys.stderr)
    print(json.dumps(out))
    return 0

