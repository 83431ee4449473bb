"""Per cent of the wall of the benchmark's decompress spans in which no
device operation ran."""

from codec_bench import trace


def read(run):
    if not run.view:
        return None
    spans = [(s.t0, s.t1) for s in run.view.spans_of("decompress")]
    wall = sum(b - a for a, b in spans)
    if not wall:
        return None
    return 100.0 * (1.0 - trace.busy_ns(run.view, clip=spans) / wall)
