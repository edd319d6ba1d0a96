"""Output megapixels of every completed request over the time from the
window's opening to the last completion of the calls begun in it."""


def read(run):
    done = run.completed
    if not done or run.end <= 0:
        return None
    return sum(r.resolution * r.resolution for r in done) / 1e6 / run.end
