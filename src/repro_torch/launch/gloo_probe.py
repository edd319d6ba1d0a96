"""Which collectives gloo runs on a device's tensors: each of all_reduce,
reduce_scatter_tensor, all_gather_into_tensor and all_to_all_single once
on 2^20 float32 elements, called directly (``torch.distributed``) and as
DTensor calls them (``torch.distributed._functional_collectives``), each
in a world of its own (``shard_check.run``) so that a rank that dies ends
only its world; one line per call with its host seconds or its error.

  PYTHONPATH=src python -m repro_torch.launch.gloo_probe --world 2
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence, Union

import torch

from repro_torch.launch import shard_check as sc

COLLECTIVES = ("all_reduce", "reduce_scatter_tensor", "all_gather_into_tensor",
               "all_to_all_single")


def collective_ranks(rank: int, world: int, device: torch.device, functional: bool, name: str,
                     numel: int = 2 ** 20) -> float:
    """The collective ``name`` once over the world -> the host seconds it
    took. A collective the backend cannot run on the device raises, or
    ends the rank."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc

    group = dist.group.WORLD
    x = torch.full((numel,), float(rank + 1), device=device)
    calls = {
        "all_reduce": (lambda: fc.all_reduce(x, "sum", group)) if functional else
        (lambda: dist.all_reduce(x.clone())),
        "reduce_scatter_tensor": (lambda: fc.reduce_scatter_tensor(x, "sum", 0, group))
        if functional else (lambda: dist.reduce_scatter_tensor(x.new_empty(numel // world), x)),
        "all_gather_into_tensor": (lambda: fc.all_gather_tensor(x, 0, group)) if functional else
        (lambda: dist.all_gather_into_tensor(x.new_empty(numel * world), x)),
        "all_to_all_single": (lambda: fc.all_to_all_single(x, None, None, group)) if functional
        else (lambda: dist.all_to_all_single(torch.empty_like(x), x)),
    }
    t0 = time.perf_counter()
    got = calls[name]()
    if functional:
        fc.wait_tensor(got)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def probe(world: int, device: str) -> Dict[str, Union[float, str]]:
    """{"direct all_reduce": seconds or the error's last line, ...}."""
    out = {}
    for functional in (False, True):
        for name in COLLECTIVES:
            key = f"{'functional' if functional else 'direct'} {name}"
            try:
                out[key] = sc.run(world, collective_ranks, functional, name, device=device,
                                  threads=0, timeout=300)[0]
            except (RuntimeError, TimeoutError) as e:
                out[key] = str(e).strip().splitlines()[-1][:200]
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--world", type=int, default=2)
    args = ap.parse_args(argv)
    from repro_torch import device as _device

    report = probe(args.world, _device.resolve(args.device).type)
    for key, value in report.items():
        print(f"{key}: {value}", flush=True)
    return report


if __name__ == "__main__":
    main()
