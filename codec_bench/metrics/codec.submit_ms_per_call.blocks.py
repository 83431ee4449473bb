"""The program's own ``phases.io`` (``models/fused.py::two_deep``: halo
staging, the upload and the launches), the mean over the compress calls of
the traced window, in ms."""


def read(run):
    calls = run.calls_of("compress")
    if not calls:
        return None
    return sum(c.stats.phases.io for c in calls) * 1e3 / len(calls)
