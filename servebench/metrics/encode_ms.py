"""Encode's CUDA-event time per launch (the records' stage_ms["E"])."""


def read(run):
    if not run.launches:
        return None
    return sum(la.stage_ms["E"] for la in run.launches) / len(run.launches)
