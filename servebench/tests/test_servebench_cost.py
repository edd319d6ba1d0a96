"""The frozen cost arithmetic equals the port's at this tree: K1's cost
function, and the FLOPs the port's encoder and DiT run, as torch's FLOP
counter counts them on the CPU (where attention is plain einsums)."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import config_file
from servebench import program, weights
from servebench.cost import arith


@pytest.mark.parametrize("b,l,h,d", [(1, 141, 24, 64), (2, 4173, 24, 128), (1, 16461, 24, 128),
                                     (3, 1101, 24, 64)])
def test_k1_cost_equals_the_kernels(b, l, h, d):
    from repro_torch.kernels import flash_attention as fa
    q = torch.empty((b, l, h, d), dtype=torch.bfloat16, device="meta")
    assert arith.k1_cost(b, l, l, h, d) == fa.cost(q, q, q, causal=False)


def test_peaks_equal_the_ports():
    from repro_torch.core.profiler import H100_SXM
    assert arith.PEAK_BF16_FLOPS == H100_SXM.peak_flops == 989e12
    assert arith.PEAK_HBM_BYTES == H100_SXM.hbm_bw == 3.35e12


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("name", ["sd3", "flux"])
@pytest.mark.parametrize("res,batch", [(32, 1), (64, 2)])
def test_model_flops_equal_what_the_port_runs(name, res, batch, cpu):
    import repro_torch.configs as C
    from repro_torch.models import pipeline as pl
    cfg = config_file(C.get_smoke(name))
    pipe = program.pipeline(program.config(cfg), weights.for_config(cfg, cpu, 1))
    lc, lx = 77, (res // 16) ** 2
    tokens = torch.randint(0, cfg["encoder"]["vocab_size"], (batch, lc))
    cond = pl.encode(pipe, tokens)
    noise = torch.randn((batch, lx, cfg["dit"]["latent_dim"]))
    t = torch.full((batch,), 500.0)
    assert _counted(lambda: pl.encode(pipe, tokens)) == arith.encoder_flops(cfg["encoder"], lc,
                                                                             batch)
    assert _counted(lambda: pipe.dit(noise, t, cond)) == arith.dit_step_flops(cfg["dit"], lx, lc,
                                                                              batch)


def test_bound_takes_the_larger_term():
    flops, nbytes = arith.k1_cost(1, 16461, 16461, 24, 128)
    assert arith.bound_s(flops, nbytes) == pytest.approx(flops / 989e12)
    assert arith.bound_s(1.0, 3.35e12) == pytest.approx(1.0)
