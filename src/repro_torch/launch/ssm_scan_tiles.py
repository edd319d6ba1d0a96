"""K3's tile sweep on the card: every register tile of ``csrc/ssm_scan.cu``
held against the plain version, then timed at the LLM serving shapes.

  PYTHONPATH=src python -m repro_torch.launch.ssm_scan_tiles

For each R (rows of S per thread: 2, 4, 8, i.e. slices of 16, 32, 64
columns) it checks the kernel at small shapes, across the ring's edges, at
zamba2's layout and at the decay floor (where a sequence cut off a chunk
boundary must give the same bits), within K3's limits. Then it times each R
at rwkv6's (B, 40, L, 64, 64) strict read with a per-channel decay and
zamba2's (B, 64, L, 64, 64) inclusive read with head-shared q/k and a
per-head decay, in device time from CUDA-graph replays, and prints one JSON
line per (shape, R): the time, the blocks the busiest SM holds, and the time
per such block and token, from which the kernel's TILE_COST is set. First
it prints, for the two served instantiations, the instructions of the token
loop (the code between the two barriers that hold most FMAs, over CHUNK
tokens) per token, by opcode, from ``cuobjdump -sass`` of the built library.
The last line names the card; the script fails where there is no CUDA card.
"""
from __future__ import annotations

import collections
import json
import math
import os
import re
import subprocess

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import ssm_scan as ss

ROWS = (2, 4, 8)
BATCH, LENGTHS, REPS = 4, (1810, 854), 10    # chip_smoke.py's LLM prefill groups
# K3's limits, as chip_smoke.py states them: the state and f32 outputs to
# 1e-5 of their rms (and 1e-5 relative), bf16 outputs one ulp
RMS, REL = 1e-5, {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


def inputs(gen, b, h, l, *, bonus, layout, dtype=torch.bfloat16, floor=False):
    """layout "rwkv6": every input per head; "zamba2": q/k shared across
    heads (stride 0) and the decay per head, broadcast over K."""
    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    hq = 1 if layout == "zamba2" else h
    q, k = (rn(b, hq, l, 64).to(dtype).expand(b, h, l, 64) for _ in range(2))
    if floor:
        decay = torch.full((b, h, l, 64), math.exp(-ss.MAX_NEG_LOGW), device="cuda")
    else:
        decay = torch.exp(-torch.exp(rn(b, h, l, 1 if layout == "zamba2" else 64)))
    return (q, k, rn(b, h, l, 64).to(dtype), decay.expand(b, h, l, 64),
            rn(h, 64) if bonus else None)


def within(got, want) -> bool:
    ok = True
    for g, w in zip(got, want):
        d, w = (g.float() - w.float()).abs(), w.float()
        ok &= bool((d <= RMS * w.pow(2).mean().sqrt() + REL[g.dtype] * w.abs()).all().item())
    return ok


def check(gen, rows: int) -> None:
    cases = [(1, 2, l, bonus, "rwkv6", dt) for l in (7, ss.CHUNK * ss.STAGES + 1)
             for bonus in (False, True) for dt in (torch.float32, torch.bfloat16)]
    cases += [(1, 64, ss.CHUNK * ss.STAGES + 1, False, "zamba2", torch.bfloat16)]
    for b, h, l, bonus, layout, dt in cases:
        q, k, v, w, u = inputs(gen, b, h, l, bonus=bonus, layout=layout, dtype=dt)
        if not within(ss.ssm_scan_rows(rows, q, k, v, w, bonus=u),
                      ref.ssm_scan_ref(q, k, v, w, u)):
            raise RuntimeError(f"R={rows} disagrees with the plain version at "
                               f"{(b, h, l, bonus, layout, dt)}")
    for bonus in (False, True):
        q, k, v, w, u = inputs(gen, 2, 3, 5 * ss.CHUNK + 7, bonus=bonus, layout="rwkv6",
                               floor=True)
        o, s = ss.ssm_scan_rows(rows, q, k, v, w, bonus=u)
        cut = ss.CHUNK + 5
        o1, s1 = ss.ssm_scan_rows(rows, *(t[:, :, :cut] for t in (q, k, v, w)), bonus=u)
        o2, s2 = ss.ssm_scan_rows(rows, *(t[:, :, cut:] for t in (q, k, v, w)), bonus=u,
                                  initial_state=s1)
        if not (within((o, s), ref.ssm_scan_ref(q, k, v, w, u))
                and torch.equal(torch.cat([o1, o2], 2), o) and torch.equal(s2, s)):
            raise RuntimeError(f"R={rows} fails the decay-floor cut check (bonus={bonus})")


# the served instantiations: ssm_scan_kernel<T, STRICT, SCALAR_W, R>
SERVED = {"rwkv6 (bf16, strict, per-channel decay, R=4)": "I13__nv_bfloat16Lb1ELb0ELi4E",
          "zamba2 (bf16, inclusive, per-token decay, R=8)": "I13__nv_bfloat16Lb0ELb1ELi8E"}


def loop_sass() -> dict:
    """Per served instantiation: the token loop's instructions per token and
    its most frequent opcodes per token."""
    exe = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    lib = _build.build_dir() / _build.LIB_NAME
    text = subprocess.run([exe, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for name, key in SERVED.items():
        body = next(f for f in re.split(r"\n\s+Function : ", text)
                    if "ssm_scan_kernel" + key in f.split("\n", 1)[0])
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", body)
        bars = [i for i, o in enumerate(ops) if o == "BAR"]
        lo, hi = max(zip(bars, bars[1:]), key=lambda p: ops[p[0]:p[1]].count("FFMA"))
        hist = collections.Counter(ops[lo:hi])
        out[name] = {"per_token": (hi - lo) / ss.CHUNK,
                     "by_opcode": {o: n / ss.CHUNK for o, n in hist.most_common(12)}}
    return out


def device_ms(fn, sets, reps: int) -> float:
    """Mean device ms of one call, from a CUDA graph of ``reps`` calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in sets[:2]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(*sets[i % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("ssm_scan_tiles: no CUDA device")
    _build.library()
    for name, rec in loop_sass().items():
        print(json.dumps({"instantiation": name, **rec}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for rows in ROWS:
        check(gen, rows)
        print(f"R={rows}: agrees with the plain version; the floor cut gives the same bits",
              flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for layout, h, bonus in (("rwkv6", 40, True), ("zamba2", 64, False)):
        for l in LENGTHS:
            # 8 input sets of ~40-60 MB each spill the 50 MB L2 between calls
            sets = [inputs(gen, BATCH, h, l, bonus=bonus, layout=layout) for _ in range(8)]
            chosen = ss.plan(*sets[0][:4], bonus=sets[0][4])
            print(json.dumps({"shape": [BATCH, h, l, 64, 64], "layout": layout,
                              "plan": chosen}), flush=True)
            for rows in ROWS:
                blocks = BATCH * h * math.ceil(64 / (8 * rows))
                ms = device_ms(lambda q, k, v, w, u: ss.ssm_scan_rows(rows, q, k, v, w, bonus=u),
                               sets, REPS)
                busiest = math.ceil(blocks / sms)
                print(json.dumps({"shape": [BATCH, h, l, 64, 64], "layout": layout,
                                  "rows": rows, "slice": 8 * rows, "blocks": blocks,
                                  "busiest_sm_blocks": busiest, "ms": ms,
                                  "us_per_block_token": 1e3 * ms / busiest / l,
                                  "chosen": chosen["rows"] == rows}), flush=True)
            del sets
            torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
