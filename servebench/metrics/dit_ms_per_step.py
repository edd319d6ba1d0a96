"""Diffuse's CUDA-event time over the DDIM steps it ran, summed over launches."""


def read(run):
    steps = sum(la.steps for la in run.launches)
    return sum(la.stage_ms["D"] for la in run.launches) / steps if steps else None
