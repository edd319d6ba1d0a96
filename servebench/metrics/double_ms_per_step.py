"""Device time of the ``double`` spans (a DDIM step's embeddings, token
refiner and dual-stream blocks) over the DDIM steps (``parts.part_ms``)."""
from servebench import parts


def read(run):
    return parts.part_ms(run, "double")
