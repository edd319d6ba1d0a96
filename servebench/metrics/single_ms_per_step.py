"""Device time of the ``single`` spans (a DDIM step's single-stream
blocks, final layer and DDIM update) over the DDIM steps
(``parts.part_ms``)."""
from servebench import parts


def read(run):
    return parts.part_ms(run, "single")
