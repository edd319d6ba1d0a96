"""The control at a size a test run holds: the plain reference with float8
products in the program's place fails the configuration's own limit, and
the program in bfloat16 (on the CPU, with the kernels' plain versions)
passes it, on the same requests. On the card ``tools/control.py`` reads
both at the cells' own sizes."""
import copy
import json
import time

import pytest

from conftest import ROOT, smoke_config, smoke_mix
from servebench import check, harness, weights


@pytest.mark.parametrize("config,mix", [("sd3", "sd3_saturated"), ("flux", "flux_hires")])
def test_control_fails_the_limit_and_the_program_passes(config, mix, cpu):
    limit = json.loads((ROOT / "servebench" / "configs" / f"{config}.json").read_text())
    limit = limit["limits"]["pixel_gap"]
    cfg = smoke_config(config, limit=limit)
    for part in ("encoder", "dit", "decoder"):
        cfg[part]["dtype"] = "bfloat16"
    cell = {"name": "smoke", "chips": 1, "cfg": cfg, "mix": smoke_mix(mix),
            "end_to_end": [], "per_layer": []}
    seed = 2 ** 31 + 77
    out, run = harness.run(copy.deepcopy(cell), seed, 1.5, False, cpu, time.perf_counter())
    program_gap = out["compared"]["pixel_gap"]["value"]
    w = weights.for_config(cfg, cpu, seed)
    control_gap = max(g for _, g in check.gaps(run, w, cpu, fp8=True))
    assert out["correct"] and program_gap < limit
    assert control_gap > limit
    assert control_gap > 3 * program_gap
    assert out["failed"] == 0
