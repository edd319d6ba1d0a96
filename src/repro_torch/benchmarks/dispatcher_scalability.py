"""Table 4 — dispatcher ILP solve time per tick, 128 -> 8192 GPUs with a
fixed request/GPU ratio: ``launch/dispatcher_scalability.py``'s runs as the
reference script's rows (``solve_ms``, ``warm_solve_ms``,
``incremental_solve_ms`` per pool size; the times are the host's)."""
from __future__ import annotations

from typing import List

from repro_torch.benchmarks.common import Row
from repro_torch.core.profiler import H100_SXM, Hardware
from repro_torch.launch import dispatcher_scalability as table4


def run(quick: bool = True, hw: Hardware = H100_SXM) -> List[Row]:
    rows: List[Row] = []
    for r in table4.run(table4.QUICK_SIZES if quick else table4.FULL_SIZES, hw):
        base = f"dispatcher_scalability/{r['gpus']}gpus"
        rows.append((f"{base}/solve_ms", round(r["solve_ms"], 1),
                     {"pending": r["pending"], "dispatched": r["dispatched"],
                      "ilp": r["cold"]}))
        rows.append((f"{base}/warm_solve_ms", round(r["warm_solve_ms"], 1),
                     {"nodes_cold": r["cold"].get("nodes"),
                      "nodes_warm": r["warm"].get("nodes"), "ilp": r["warm"]}))
        rows.append((f"{base}/incremental_solve_ms", round(r["incremental_solve_ms"], 1),
                     {"nodes": r["incremental"].get("nodes"),
                      "reused": bool(r["incremental"].get("reused")),
                      "solve_reuses": r["solve_reuses"]}))
    return rows
