"""Host time of the serving loop per launch: each serve call's wall time
minus the CUDA-event time of its launches, summed, over the launches."""


def read(run):
    if not run.launches:
        return None
    gap = sum((c.end - c.start) - sum(sum(run.launches[i].stage_ms.values()) / 1e3
                                      for i in c.launches)
              for c in run.calls if c.error is None)
    return 1e3 * gap / len(run.launches)
