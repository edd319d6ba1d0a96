"""Work replayed from CUDA graphs: where a replay may run, and the capture
that the port's graph caches share (``diffusion.StepGraphs``, the DDIM
step; ``pipeline.EncodeGraphs``, Encode).

A cache holds the addresses of its module's parameters at capture
(``ptrs``) and one memory pool for all its graphs (their replays never
overlap). Its owner drops it when ``replay_ptrs`` gives other addresses.
Every cache captures on one side stream a device (``capture_stream``): the
GEMM library keeps a workspace for each stream it ran on for the life of
the process, so a stream a cache would leave one behind with each cache.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.sharding import spmd

_STREAMS: Dict[int, torch.cuda.Stream] = {}


def capture_stream(dev: torch.device) -> torch.cuda.Stream:
    """The side stream every capture on ``dev`` runs on, made at the first."""
    index = torch.device(dev).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _STREAMS:
        _STREAMS[index] = torch.cuda.Stream(index)
    return _STREAMS[index]


def replay_ptrs(module: nn.Module, x: torch.Tensor) -> Optional[tuple]:
    """The addresses of ``module``'s parameters where work on ``x`` can
    replay graphs of it: on a CUDA device, grad off, no kernel counter set
    (it counts ops as they dispatch, and a replay dispatches none), no
    capture already under way and no DTensor parameter. None elsewhere: the
    work then runs eagerly."""
    if (not x.is_cuda or torch.is_grad_enabled() or kops.COUNTER is not None
            or torch.cuda.is_current_stream_capturing()):
        return None
    params = list(module.parameters())
    if any(spmd.is_dtensor(p) for p in params):
        return None
    return tuple(p.data_ptr() for p in params)


class Graphs:
    """A cache of graphs of one module's work, by a key of its owner's
    choosing (``shapes``), captured by ``capture``."""

    def __init__(self, ptrs: tuple):
        self.ptrs = ptrs
        self.pool = torch.cuda.graph_pool_handle()
        self.shapes: Dict[tuple, object] = {}

    def capture(self, dev: torch.device, runs: Sequence[Callable[[], None]]
                ) -> Tuple[List[torch.cuda.CUDAGraph], Dict[str, int]]:
        """One graph of each of ``runs``, in order, after all of them ran once
        on ``capture_stream`` (first launches and library state outside the
        captures), and each kernel op's launches in one replay of them all.
        ``kops.LAUNCHES`` is left as it was."""
        side = capture_stream(dev)
        before = dict(kops.LAUNCHES)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for run in runs:
                run()
        torch.cuda.current_stream(dev).wait_stream(side)
        warm = dict(kops.LAUNCHES)
        graphs = []
        for run in runs:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self.pool, stream=side,
                                  capture_error_mode="thread_local"):
                run()
            graphs.append(graph)
        launches = {k: n - warm[k] for k, n in kops.LAUNCHES.items() if n != warm[k]}
        kops.LAUNCHES.update(before)
        return graphs, launches
