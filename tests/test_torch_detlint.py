"""The determinism gate over the port: detlint finds nothing unsuppressed in
the port's host code (the scheduler core, serving, the benchmark scripts
and sharding), with the port's ``core`` and ``serving`` in the strict zone,
as the reference's own are (``tools/detlint/engine.py``)."""
import os

import pytest

from tools.detlint.engine import lint_paths

REPO = os.path.join(os.path.dirname(__file__), "..")
PATHS = ("src/repro_torch/core", "src/repro_torch/serving", "src/repro_torch/benchmarks",
         "src/repro_torch/sharding")
STRICT = ("src/repro_torch/core", "src/repro_torch/serving")


@pytest.mark.parametrize("path", PATHS)
def test_port_gate_is_clean(monkeypatch, path):
    """Zero unsuppressed findings, path by path (the suppressions carry the
    reference's reasons)."""
    monkeypatch.chdir(REPO)
    result = lint_paths([path], strict_prefixes=STRICT)
    assert result.errors == [] and result.files > 0
    assert [(f.path, f.line, f.rule) for f in result.findings] == []


def test_port_gate_is_clean_over_all_paths_at_once(monkeypatch):
    """The CLI's run, ``python -m tools.detlint`` over the four paths
    together (cross-module return kinds seen whole)."""
    monkeypatch.chdir(REPO)
    result = lint_paths(list(PATHS), strict_prefixes=STRICT)
    assert result.errors == []
    assert [(f.path, f.line, f.rule) for f in result.findings] == []
