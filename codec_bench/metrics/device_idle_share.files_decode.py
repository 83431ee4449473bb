"""Per cent of the traced window in which no device operation ran (1 - the
union of device activity / the window's wall), in the files-decode cell."""

from codec_bench import trace


def read(run):
    return trace.idle_share(run.view) if run.view else None
