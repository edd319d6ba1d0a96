"""Run one cell of the serving benchmark on one CUDA device.

  python3 servebench/run.py --workload sd3.saturated --seed 1234 --seconds 51 --trace 0

Prints the result as the last line of standard output (a JSON object) and
the numbers the check compared, each beside its limit, as the last lines
of standard error. Exits non-zero without a result where there is no CUDA
device, where the port is missing, or where JAX or the JAX package was
loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def process_age_s() -> float:
    """Seconds since this process started (from /proc), or 0 where unknown."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return max(0.0, float(Path("/proc/uptime").read_text().split()[0]) - started)
    except (OSError, ValueError, IndexError):
        return 0.0


def main(argv=None) -> int:
    t_start = T_START - process_age_s()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every cache of the program stays inside the checkout, at fixed paths
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from servebench import harness
    return harness.main(args, t_start)


if __name__ == "__main__":
    sys.exit(main())
