"""Model FLOPs of the encoder and every DiT step served, from the shapes
(cost/arith.py), over the window's time to the last completion at the
H100's bf16 peak."""
from servebench.cost import arith


def read(run):
    if not run.launches or run.end <= 0:
        return None
    flops = sum(arith.request_flops(run.cfg, la.latent_tokens, la.cond_tokens, la.steps,
                                    len(la.members)) for la in run.launches)
    return 100.0 * flops / (run.end * arith.PEAK_BF16_FLOPS)
