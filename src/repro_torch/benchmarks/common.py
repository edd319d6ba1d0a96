"""Shared benchmark plumbing: each module exposes ``run(quick, hw) -> rows``.

A row is (name, value, derived) where value is the headline number for the
CSV and ``derived`` is a dict of extra fields. Counterpart of
``benchmarks/common.py``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

Row = Tuple[str, float, Dict[str, Any]]


def emit(rows: List[Row], file=None) -> None:
    for name, value, derived in rows:
        extra = ";".join(f"{k}={v}" for k, v in derived.items())
        print(f"{name},{value},{extra}", flush=True, file=file)


DUR_QUICK = 120.0
DUR_FULL = 600.0


def duration(quick: bool) -> float:
    return DUR_QUICK if quick else DUR_FULL
