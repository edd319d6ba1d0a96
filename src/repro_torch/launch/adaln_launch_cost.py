"""Where the host time of one K2 launch goes, on the card.

  PYTHONPATH=src python src/repro_torch/launch/adaln_launch_cost.py

Times, with the host clock, each step of the eager launch path of
``ops.adaln_rmsnorm`` (the op, the kernel wrapper, and each piece of the
wrapper on its own) at sd3's 512 px call, (1, 1101, 1536) bf16 with scale
and shift as rows of the DiT's (1, 6, D) modulation. Each step runs 200
times with no synchronisation (so the launch queue never fills and the
host's own cost is what is timed); the steps take turns, 25 rounds, and the
median per call in microseconds is printed. The C entry point is timed with
a launch record of B = 0, where it returns before launching (the ctypes
call alone), and with the served one (the call and the CUDA launch).

Then, at each shape the serve phases give K2, it times a steady stream of
``ops.adaln_rmsnorm`` calls with CUDA events: inputs cycled through enough
copies to spill the 50 MB L2, 50 calls untimed, then 200 timed with no
synchronisation before them, 3 times (the median is printed). That is the
cost of a call in a long stream: the larger of its host time and its device
time with the gap between eager launches.

It runs against whichever ``repro_torch`` is first on the path, so the
same file times an older tree's launch path too (run it by its path with
that tree's ``src`` on ``PYTHONPATH``): it reads the wrapper's pieces of
either form, a per-call ``_check`` with twelve C arguments, or a
remembered signature (``_key``, ``_launch_record``) with a launch record.
Prints one JSON line; the last line names the card. Fails where there is no
CUDA card.
"""
from __future__ import annotations

import ctypes
import json
import math
import statistics
import subprocess
import time

import torch

import repro_torch.configs as C
from repro_torch.kernels import _build, ops
from repro_torch.kernels import adaln_rmsnorm as ar
from repro_torch.launch import quickstart

SHAPE = (1, 1101, 1536)
CALLS, ROUNDS = 200, 25
EPS = 1e-6
COND_LEN = 77                  # prompt tokens of every served request
L2_BYTES = 50 * 2 ** 20


def served_shapes() -> list:
    """K2's (B, L, D) on the serve paths: each request's DiT over its latent
    tokens plus the prompt's."""
    out = []
    for name in C.PIPELINE_IDS:
        cfg = C.get(name)
        for res, sec in quickstart.REQUESTS[name]:
            out.append((1, cfg.latent_tokens(res, sec) + COND_LEN, cfg.dit.d_model))
    return list(dict.fromkeys(out))


def host_split(steps: dict) -> dict:
    """Median host microseconds per call of each step, the steps in turns."""
    for fn in steps.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in steps}
    for _ in range(ROUNDS):
        for name, fn in steps.items():
            t0 = time.perf_counter()
            for _ in range(CALLS):
                fn()
            times[name].append((time.perf_counter() - t0) / CALLS * 1e6)
            torch.cuda.synchronize()
    return {name: statistics.median(t) for name, t in times.items()}


def c_calls(x, s, t, out):
    """(the C entry point's call that returns before launching, the served
    call, what keeps their records alive), in this tree's form."""
    stream = torch.cuda.current_stream(x.device).cuda_stream
    px, ps, pt, po = x.data_ptr(), s.data_ptr(), t.data_ptr(), out.data_ptr()
    fn = _build.function("repro_adaln_rmsnorm", ar._ARGTYPES)
    if hasattr(ar, "_launch_record"):
        served = ar._launch_record(ar._key(x, s, t, EPS))
        empty = ar._Launch(B=0, L=0)
        return (lambda: fn(px, ps, pt, po, ctypes.addressof(empty), stream),
                lambda: fn(px, ps, pt, po, served[2], stream), (served, empty))
    b, l, d = SHAPE
    args = (px, ps, pt, po, b * l, l, d, s.stride(0), t.stride(0), EPS, 1, stream)
    return lambda: fn(*args[:4], 0, *args[5:]), lambda: fn(*args), None


def guarded(device) -> None:
    with torch.cuda.device(device):
        pass


def inputs(gen, b, l, d):
    x = torch.randn((b, l, d), generator=gen, device="cuda").bfloat16()
    mod = (torch.randn((b, 6, d), generator=gen, device="cuda") * 0.1).bfloat16()
    return x, mod[:, 0], mod[:, 1]


def stream_us(gen, shape, warm: int = 50, reps: int = 200) -> float:
    nbytes = 2 * math.prod(shape) * 2
    sets = [inputs(gen, *shape) for _ in range(max(1, math.ceil(2 * L2_BYTES / nbytes)))]
    got = []
    for _ in range(3):
        for i in range(warm):
            ops.adaln_rmsnorm(*sets[i % len(sets)])
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for i in range(reps):
            ops.adaln_rmsnorm(*sets[i % len(sets)])
        e1.record()
        torch.cuda.synchronize()
        got.append(e0.elapsed_time(e1) / reps * 1e3)
    return statistics.median(got)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("adaln_launch_cost: no CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x, s, t = inputs(gen, *SHAPE)
    out = torch.empty_like(x)
    dev = x.device
    empty_call, served_call, _records = c_calls(x, s, t, out)   # keep the records alive
    steps = {
        "ops.adaln_rmsnorm": lambda: ops.adaln_rmsnorm(x, s, t),
        "wrapper": lambda: ar.adaln_rmsnorm(x, s, t),
        "torch.empty_like": lambda: torch.empty_like(x),
        "current_stream().cuda_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "raw stream": lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "current device": lambda: torch._C._cuda_getDevice(),
        "data_ptr x4": lambda: (x.data_ptr(), s.data_ptr(), t.data_ptr(), out.data_ptr()),
        "C call, no launch": empty_call,
        "C call and launch": served_call,
        "device guard": lambda: guarded(dev),
    }
    if hasattr(ar, "_check"):
        steps["_check"] = lambda: ar._check(x, s, t)
    if hasattr(ar, "_key"):
        sigs = ar._SIGNATURES
        steps["signature lookup"] = lambda: sigs.get(ar._key(x, s, t, EPS))
        steps["alignment check"] = lambda: (x.data_ptr() | s.data_ptr() | t.data_ptr()) & 15
    split = host_split(steps)
    streams = {str(list(shape)): stream_us(gen, shape) for shape in served_shapes()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"shape": list(SHAPE), "dtype": "bfloat16",
                      "form": "signature" if hasattr(ar, "_key") else "per-call check",
                      "torch": torch.__version__, "host_us_per_call": split,
                      "stream_us_per_call": streams}), flush=True)
    print(smi)


if __name__ == "__main__":
    main()
