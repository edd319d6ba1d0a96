"""Build the port's CUDA sources into one shared library and load it.

Every ``csrc/*.cu`` file is compiled with ``nvcc`` for ``sm_90a`` (one
``nvcc`` per source, all started together), linked into one ``.so`` with a
plain C interface, and loaded with ``ctypes``. The build lands in
``build/kernels-<hash>/`` at the repository root, keyed by a hash of the
sources and flags, so a changed source rebuilds and an unchanged one loads
at once. Nothing here runs at import: the first kernel call builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
LIB_NAME = "librepro_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_fns: dict = {}


class KernelBuildError(RuntimeError):
    pass


def sources() -> list:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc() -> str:
    cands = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            cands.append(os.path.join(os.environ[var], "bin", "nvcc"))
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError("nvcc not found (set CUDA_HOME); the kernels need the CUDA toolkit")


def _run(cmds: Sequence[Sequence[str]], log: Path) -> None:
    """Run the commands in parallel; raise with stderr if any fails."""
    procs = [subprocess.Popen(list(c), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    failed = []
    with open(log, "a") as fh:
        for c, p in zip(cmds, procs):
            out, err = p.communicate()
            fh.write(" ".join(c) + "\n" + out + err + "\n")
            if p.returncode != 0:
                failed.append(f"$ {' '.join(c)}\n{err}")
    if failed:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(failed))


def build_dir() -> Path:
    """Where the current sources build: the library and ``nvcc.log``."""
    return BUILD_ROOT / f"kernels-{source_hash()}"


def build() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="kernels-tmp-", dir=BUILD_ROOT))
    try:
        exe = nvcc()
        cus = [p for p in sources() if p.suffix == ".cu"]
        objs = [tmp / (p.stem + ".o") for p in cus]
        log = tmp / "nvcc.log"
        _run([[exe, *NVCC_FLAGS, "-c", str(p), "-o", str(o)] for p, o in zip(cus, objs)], log)
        _run([[exe, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp / LIB_NAME),
               *map(str, objs)]], log)
        try:
            tmp.rename(out_dir)            # atomic: a concurrent build may win the race
        except OSError:
            if not lib.is_file():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib


def function(name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """One C entry point with its argument types; it returns a cudaError_t."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
