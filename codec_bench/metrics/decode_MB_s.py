"""Decompressed bytes of every decompress call in the window, in MB (1e6
B), over the host-clock span from the first call's start to the last
call's end."""


def read(run):
    calls = run.calls_of("decompress")
    if not calls:
        return None
    span = max(c.t1 for c in calls) - min(c.t0 for c in calls)
    return sum(c.nout for c in calls) / span / 1e6
