"""Share of the HBM roofline reached by the token pack
(``ops/parse_walk.py::pack_bits`` -> ``csrc/pack_bits.cu::pack_bits_kernel``),
in per cent.

Bytes: each token word read once, 4 bytes a token (the program's own
``EncodeStats.tokens``), and the stream's payload written once (the stream
less its 4 header bytes).  Time: the ``pack_bits_kernel`` device time of
the traced window's compress spans.  None where the program has no such
kernel or keeps no token count.
"""

from codec_bench import trace

KERNEL = r"\bpack_bits_kernel\b"


def layer_bytes(tokens: int, stream_bytes: int) -> int:
    """Bytes of one compress call's pack: ``tokens`` token words read and
    a stream of ``stream_bytes`` bytes (4 of them the header) written."""
    return 4 * tokens + max(0, stream_bytes - 4)


def read(run):
    if not run.view or not run.peaks:
        return None
    spans = run.view.spans_of("compress")
    ns = trace.kernel_ns(run.view.ops_in(spans), KERNEL)
    if not ns:
        return None
    moved = 0
    for s in spans:
        c = run.calls[s.call]
        tokens = getattr(c.stats, "tokens", None)
        if tokens is None:
            return None
        moved += layer_bytes(tokens, c.nout)
    return 100.0 * moved / run.peaks["hbm_bytes_per_s"] / (ns / 1e9)
