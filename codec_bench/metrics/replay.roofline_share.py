"""Share of the HBM roofline reached by the decode kernels
(``ops/decode_walk.py::walk_decode`` -> ``token_scan_kernel``,
``replay_kernel``), in per cent.

Bytes: the stream's payload read once and the decoded bytes written once.
Time: those two kernels' device time in the traced window's decompress
spans.
"""

from codec_bench import trace

KERNELS = r"\b(token_scan_kernel|replay_kernel)\b"


def layer_bytes(stream_bytes: int, n_out: int) -> int:
    """Bytes of one decompress of a ``stream_bytes`` stream (4 of them the
    header) into ``n_out`` bytes."""
    return max(0, stream_bytes - 4) + n_out


def read(run):
    if not run.view or not run.peaks:
        return None
    spans = run.view.spans_of("decompress")
    ns = trace.kernel_ns(run.view.ops_in(spans), KERNELS)
    if not ns:
        return None
    moved = sum(layer_bytes(run.calls[s.call].nin, run.calls[s.call].nout)
                for s in spans)
    return 100.0 * moved / run.peaks["hbm_bytes_per_s"] / (ns / 1e9)
