"""The program's own ``phases.io`` (``models/fused.py::two_deep``: halo
staging, the upload and the launches of each batch), summed over the
compress calls of the traced window, in ms per MiB of input."""


def read(run):
    calls = run.calls_of("compress")
    mib = sum(c.nin for c in calls) / (1 << 20)
    if not mib:
        return None
    return sum(c.stats.phases.io for c in calls) * 1e3 / mib
