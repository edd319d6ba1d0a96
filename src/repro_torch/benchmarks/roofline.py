"""§Roofline — the three-term roofline table from the port's dry-run records
(``results/torch_dryrun_single_pod.jsonl``, ``results/torch_dryrun_multi_pod.jsonl``,
written by ``python -m repro_torch.launch.dryrun --all [--multi-pod] --out ...``).

Counterpart of ``benchmarks/roofline.py``. Each record keeps one device's
counts, so its three terms are priced here on ``hw`` (``H100_SXM`` by
default: a collective group wider than a node of 8 at ``inter_node_bw``);
a missing file gives one "missing" row."""
from __future__ import annotations

import json
import os
from typing import List

from repro_torch.benchmarks.common import Row
from repro_torch.core.profiler import H100_SXM, Hardware

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results")
FILES = ("torch_dryrun_single_pod.jsonl", "torch_dryrun_multi_pod.jsonl")


def terms(r: dict, hw: Hardware) -> dict:
    """A record's compute, memory and collective seconds on ``hw``."""
    wide = r.get("coll_wire_bytes_wide", 0.0) if hw.link_domain_chips else 0.0
    return {"compute": r["hlo_flops_per_device"] / hw.peak_flops,
            "memory": r["hlo_bytes_per_device"] / hw.hbm_bw,
            "collective": ((r["coll_wire_bytes_total"] - wide) / hw.link_bw
                           + wide / hw.inter_node_bw)}


def run(quick: bool = True, hw: Hardware = H100_SXM, results: str = RESULTS) -> List[Row]:
    rows: List[Row] = []
    for fname in FILES:
        path = os.path.join(results, fname)
        if not os.path.exists(path):
            rows.append((f"roofline/{fname}/missing", 0.0,
                         {"hint": "run python -m repro_torch.launch.dryrun --all"}))
            continue
        with open(path) as f:
            for line in f:
                r = json.loads(line)
                tag = f"roofline/{r['arch']}/{r['shape']}/{r['mesh']}"
                if r["status"] == "skipped":
                    rows.append((f"{tag}/skipped", 0.0, {"reason": r["reason"][:60]}))
                    continue
                if r["status"] != "ok":
                    rows.append((f"{tag}/error", -1.0, {"error": r.get("error", "")[:80]}))
                    continue
                t = terms(r, hw)
                dom = max(("compute", "memory", "collective"), key=lambda k: t[k])
                rows.append((f"{tag}/t_{dom}_ms", round(t[dom] * 1e3, 3),
                             {"compute_ms": round(t["compute"] * 1e3, 3),
                              "memory_ms": round(t["memory"] * 1e3, 3),
                              "collective_ms": round(t["collective"] * 1e3, 3),
                              "bottleneck": dom,
                              "useful_flops_ratio": round(r["useful_ratio"], 4),
                              "peak_mem_GiB": round(
                                  r.get("peak_mem_per_device", 0) / 2 ** 30, 2)}))
    return rows
