"""Requests a launch carries (the records' batch), over the launches."""


def read(run):
    if not run.launches:
        return None
    return sum(len(la.members) for la in run.launches) / len(run.launches)
