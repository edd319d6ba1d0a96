"""K1 built from this tree's source and from another, side by side on the card.

  PYTHONPATH=src python src/repro_torch/launch/flash_attention_ab.py OTHER.cu [--trap]

``OTHER.cu`` is another version of ``csrc/flash_attention.cu``: an older
tree's (``git show REV:src/repro_torch/csrc/flash_attention.cu > OTHER.cu``)
or an edited copy. Each source is compiled on its own by nvcc into a library
under ``build/``, and ptxas's registers, stack and spills are printed per
instantiation. ``--trap`` builds both with an ``mbar_wait`` that traps after
2e7 polls, so that a barrier phase slip in a rehearsed change faults instead
of hanging the card (it slows both builds alike). Then, at every K1 shape
``chip_smoke.py`` times (the DiTs' joint attention, hunyuanvideo's causal
encoder, each LLM's prefill groups, from ``chip_smoke.serving_shapes``), each
library is held against the plain version on the same inputs (K1's limits,
``chip_smoke.k1_agree``) and timed by CUDA-graph replays past L2, in turns:
this, other, other, this. A shape whose head dim a library does not take is
timed for the other alone. Prints one JSON line per shape, then the sums by
head dim (over the shapes both take, and over all), and the card's name and
power limit last. Fails where there is no CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

import repro_torch.configs as C
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve_llm

ROOT = Path(__file__).resolve().parents[3]

WAIT_LOOP = """  uint32_t done = 0;
  do {"""
TRAP_LOOP = """  uint32_t done = 0, polls = 0;
  do {
    if (++polls > 20000000u) asm volatile("trap;");"""


def trapping(source: str) -> str:
    """The source with an ``mbar_wait`` that traps after 2e7 polls."""
    if source.count(WAIT_LOOP) != 1:
        raise ValueError("mbar_wait's poll loop not found: cannot build the trapping copy")
    return source.replace(WAIT_LOOP, TRAP_LOOP)


def build(source: str, trap: bool) -> tuple:
    """Start nvcc on one version of the source; returns (process, library path)."""
    if trap:
        source = trapping(source)
    out = _build.BUILD_ROOT / f"ab-{hashlib.sha256(source.encode()).hexdigest()[:16]}"
    out.mkdir(parents=True, exist_ok=True)
    (out / "flash_attention.cu").write_text(source)
    lib = out / "libfa.so"
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
           str(out / "flash_attention.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), lib


def ptxas_lines(log: str) -> list:
    """(instantiation, ptxas's register / stack / spill lines) of fa_fwd_kernel."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line and "fa_fwd_kernel" in line:
            d_nc = line.split("fa_fwd_kernelILi")[1].split("E")[:2]
            name = f"D={d_nc[0]} NC={d_nc[1].lstrip('Li')}"
        elif name and ("spill" in line or "Used" in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


def use(lib: ctypes.CDLL) -> None:
    """Point the K1 wrapper at ``lib``."""
    _build._lib = lib
    _build._fns.clear()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="another version of csrc/flash_attention.cu")
    ap.add_argument("--trap", action="store_true", help="build both with a trapping mbar_wait")
    ap.add_argument("--reps", type=int, default=20, help="calls per timed graph")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_attention_ab: no CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs           # the repository's root script: shapes, limits, timing
    sources = {"this": (_build.CSRC / "flash_attention.cu").read_text(),
               "other": Path(args.other).read_text()}
    jobs = {name: build(src, args.trap) for name, src in sources.items()}
    libs = {}
    for name, (proc, lib) in jobs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{err}")
        for line in ptxas_lines(out + err):
            print(f"ptxas {name} {line}", flush=True)
        libs[name] = ctypes.CDLL(str(lib))
    torch.backends.cuda.matmul.allow_tf32 = False
    groups = {arch: cs.group_lengths(cs.llm_requests(serve_llm, C.get(arch)))
              for arch in cs.LLM_ARCHS + cs.ATTN_ARCHS}
    shapes, _ = cs.serving_shapes(C, groups)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for path, shape in shapes:
        b, lq, lkv, h, d, causal, window, cap = shape
        mask = ops.attention_mask(lq, lkv, window, "cuda") if causal else None

        def make():
            return tuple(torch.randn((b, n, h, d), generator=gen, device="cuda")
                         .to(torch.bfloat16) for n in (lq, lkv, lkv))
        sets = cs.ring(make, 2 * (2 * b * lq * h * d + 2 * b * lkv * h * d))
        want = cs.plain_by_heads(ref, *sets[0], mask, cap)

        def kernel(q, k, v):
            return fa.flash_attention(q, k, v, causal=causal, window=window, softcap=cap)
        row = {"path": path, "shape": list(shape)}
        taken = []
        for name in libs:
            use(libs[name])
            try:
                got = kernel(*sets[0])
            except RuntimeError:          # a head dim this version does not take
                row[name] = None
                continue
            torch.cuda.synchronize()
            err, rel, ok = cs.k1_agree(got, want)
            if not ok:
                raise RuntimeError(f"{name} disagrees with the plain version at {shape}: "
                                   f"max |err| {err}, rms {rel}")
            row[name], row[f"{name}_rms_rel_err"] = [], rel
            taken.append(name)
        for name in taken + taken[::-1]:
            use(libs[name])
            row[name].append(cs.device_ms(kernel, sets, args.reps))
        print(json.dumps(row), flush=True)
        rows.append(row)
        del sets, want
        torch.cuda.empty_cache()
    sums = {}
    for r in rows:
        d = r["shape"][4]
        keys = [f"D={d} all"] + ([f"D={d} both"] if all(r[n] is not None for n in libs) else [])
        for n in libs:
            for key in keys if r[n] is not None else []:
                sums.setdefault(key, {}).setdefault(n, 0.0)
                sums[key][n] += sum(r[n]) / len(r[n])
    print(json.dumps({"ms_summed": sums}), flush=True)
    print(cs.smi())


if __name__ == "__main__":
    main()
