"""The port stands alone: no JAX, nothing of the JAX package and nothing
of its top-level ``benchmarks`` package, and no quiet fallback to the CPU."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
import repro_torch.configs as TC
from repro_torch import convert
from repro_torch.core.request import Request
from repro_torch.launch import quickstart, serve_llm
from repro_torch.models import pipeline as tpl
from repro_torch.models import transformer as ttf

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top == "jax" or top.startswith("jax") or top in ("repro", "benchmarks")


def test_port_imports_no_jax_and_no_reference_package():
    mods = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))
    code = (
        "import importlib, importlib.util, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"spec = importlib.util.spec_from_file_location('chip_smoke', {str(ROOT / 'chip_smoke.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('repro', 'benchmarks')"
        " or n.split('.')[0].startswith('jax'))\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(mods) >= 32 and "repro_torch.benchmarks.e2e" in mods


def test_no_source_names_jax_or_the_reference_package():
    # also the imports inside functions, which the import above does not run
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not any(_forbidden(n) for n in names), (path, names)


def test_default_device_is_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    cfg = TC.get_smoke("sd3")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpl.build(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        quickstart.serve(cfg, [Request(cfg.name, 64)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.from_jax(cfg, {})
    lm = TC.get_smoke("rwkv6-3b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.from_jax_lm(lm, {})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttf.build(lm)
    reqs = serve_llm.requests_from_seed(lm.vocab_size, 1, (4, 8), 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_llm.serve(lm, reqs)
