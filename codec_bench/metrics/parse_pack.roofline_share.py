"""Share of the HBM roofline reached by the parse and pack layer
(``ops/parse_walk.py::build_lox``, ``walk_parse_pack``, ``token_bytes``),
in per cent.

Bytes: the (L, O) int32 tables and the input read once, 9 bytes a
position, and the stream's payload written once.  Time: every device
operation of the traced window's compress spans that is neither
``match_kernel`` nor a copy.
"""

import re

from codec_bench import trace

MATCH = re.compile(r"\bmatch_kernel\b")


def layer_bytes(n_in: int, stream_bytes: int) -> int:
    """Bytes of one compress of ``n_in`` input bytes into a stream of
    ``stream_bytes`` bytes (4 of them the header)."""
    return 9 * n_in + max(0, stream_bytes - 4)


def read(run):
    if not run.view or not run.peaks:
        return None
    spans = run.view.spans_of("compress")
    ns = sum(o.t1 - o.t0 for o in run.view.ops_in(spans)
             if not o.copy and not MATCH.search(o.name))
    if not ns:
        return None
    moved = sum(layer_bytes(run.calls[s.call].nin, run.calls[s.call].nout)
                for s in spans)
    return 100.0 * moved / run.peaks["hbm_bytes_per_s"] / (ns / 1e9)
