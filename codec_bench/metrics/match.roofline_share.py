"""Share of the HBM roofline reached by the match layer
(``ops/match.py::match_sweep`` -> ``match_kernel``), in per cent.

Bytes: each input byte read once and the (L, O) int32 tables written once,
9 bytes a position.  Time: the ``match_kernel`` device time of the traced
window's compress spans.  No operation count is used: the count of
compares belongs to one search algorithm, and a hash or suffix search
needs far fewer, so this share stays far below 100 % by construction and
moves with the layer's time.
"""

from codec_bench import trace

KERNEL = r"\bmatch_kernel\b"


def layer_bytes(n_in: int) -> int:
    """Bytes of one compress of ``n_in`` input bytes at the layer's
    boundary."""
    return 9 * n_in


def read(run):
    if not run.view or not run.peaks:
        return None
    spans = run.view.spans_of("compress")
    ns = trace.kernel_ns(run.view.ops_in(spans), KERNEL)
    if not ns:
        return None
    moved = sum(layer_bytes(run.calls[s.call].nin) for s in spans)
    return 100.0 * moved / run.peaks["hbm_bytes_per_s"] / (ns / 1e9)
