"""A later change adds a configuration, a traffic mix, a cell and a metric
by adding files and entries only: here in a copy of the benchmark, whose
new cell (at the SMOKE sizes) then runs on the CPU through the same
harness, and whose new metric is read by name."""
import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT, config_file, smoke_mix

SCRIPT = r"""
import json, sys, time
import torch
from servebench import harness
c = harness.cell(harness.load_benchmark(), "sd3tiny.burst")
out, run = harness.run(c, 2 ** 31 + 3, 1.5, False, torch.device("cpu"), time.perf_counter())
print(json.dumps({"correct": out["correct"], "metrics": out["metrics"],
                  "configs": sorted(harness.load_benchmark()["workloads"][i]["name"]
                                    for i in range(len(harness.load_benchmark()["workloads"])))}))
"""


def test_new_cell_config_mix_and_metric_by_files_only(tmp_path):
    import repro_torch.configs as C
    bench_src = json.loads((ROOT / "BENCHMARK.json").read_text())
    shutil.copytree(ROOT / "servebench", tmp_path / "servebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "servebench").rglob("*") if p.is_file()}
    bench = json.loads(json.dumps(bench_src))
    # new files: a configuration, a mix, a metric's reader
    (tmp_path / "servebench/configs/sd3tiny.json").write_text(
        json.dumps(config_file(C.get_smoke("sd3"), limit=1e-3)))
    mix = smoke_mix("sd3_medium")
    mix["knee_per_s"] = 4.0
    (tmp_path / "servebench/traffic/sd3tiny_burst.json").write_text(json.dumps(mix))
    (tmp_path / "servebench/metrics/launches_total.py").write_text(
        "def read(run):\n    return float(len(run.launches))\n")
    # new entries
    bench["configs"].append({"name": "sd3tiny", "source": "https://example.org/tiny",
                             "file": "servebench/configs/sd3tiny.json", "reduced": [],
                             "why": "tiny"})
    bench["workloads"].append({"name": "sd3tiny.burst", "config": "sd3tiny",
                               "traffic": "sd3tiny_burst", "chips": 1, "why": "tiny"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "sd3.saturated" in m["workloads"]:
            m["workloads"].append("sd3tiny.burst")
    bench["end_to_end"].append({"name": "launches_total", "unit": "launches", "better": "higher",
                                "bound": 0.1, "source": "host_clock",
                                "workloads": ["sd3tiny.burst"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "servebench").rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())     # no file edited
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT / 'src'}")
    p = subprocess.run([sys.executable, "-c", SCRIPT], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"]
    assert out["metrics"]["launches_total"]["value"] >= 1
    assert {"throughput_mpx_s.paced", "setup_s"} <= set(out["metrics"])
    assert "sd3tiny.burst" in out["configs"]
