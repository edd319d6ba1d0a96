"""What the benchmark may import, and one short cell on the card."""
import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import ROOT

PKG = ROOT / "servebench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    """Top-level names of every module a file imports, anywhere in it."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                out.add(str(arg.value).split(".")[0])
    return out


FILES = sorted(PKG.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_jax_package(path):
    assert not (_imports(path) & FORBIDDEN), path


@pytest.mark.parametrize("path", sorted((PKG / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert not (_imports(path) & {"repro_torch", "servebench"}), path


def test_only_program_imports_the_port():
    users = {p.relative_to(PKG).as_posix() for p in FILES
             if "repro_torch" in _imports(p) and "tests" not in p.parts}
    assert users == {"program.py"}


def test_the_window_drives_quickstart_serve():
    src = (PKG / "program.py").read_text()
    assert "quickstart.serve(" in src


def test_forbidden_names_are_compared_whole():
    from servebench import harness
    sys.modules.setdefault("repro_torch_lookalike_for_test", sys)
    try:
        found = harness.forbidden_modules()
        assert not any(m.startswith("repro_torch") for m in found)
    finally:
        sys.modules.pop("repro_torch_lookalike_for_test", None)


def test_a_bare_checkout_gives_no_result(tmp_path):
    """BENCHMARK.json and the benchmark's folder alone: no port to serve."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PKG, tmp_path / "servebench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "servebench/run.py", "--workload", "sd3.saturated",
                        "--seed", "1", "--seconds", "1"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout


@pytest.mark.gpu
def test_one_short_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "servebench/run.py", "--workload", "sd3.saturated",
                        "--seed", str(2 ** 31 + 5), "--seconds", "3", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert set(out) >= {"correct", "attempted", "failed", "metrics", "device"}
