"""Vectorized host decode (numpy).

Positions via cumsum, copy chains collapsed by pointer doubling, executed
with numpy on the host.  It is the ``backend="host"`` decoder and the
independent reference the device decode (``ops.decode_walk``) is tested
against at small sizes.
"""

from __future__ import annotations

import numpy as np

from .. import bitio, spec


def decode_tokens_np(
    off: np.ndarray, ln: np.ndarray, nxt: np.ndarray
) -> bytes:
    """Replay a whole token stream with vectorized pointer doubling."""
    T = off.shape[0]
    if T == 0:
        return b""
    off = off.astype(np.int64)
    ln = ln.astype(np.int64)
    sz = ln + 1
    ends = np.cumsum(sz)
    starts = ends - sz
    n = int(ends[-1])

    # Literal placement.
    val = np.zeros(n, np.uint8)
    lit_pos = starts + ln
    val[lit_pos] = nxt.astype(np.uint8)

    # Parent pointers: literal bytes point to themselves, match bytes point
    # ``off`` behind.  tok_of[j] = covering token via start-indicator cumsum.
    ind = np.zeros(n + 1, np.int64)
    ind[starts] = 1  # starts are strictly increasing (sz >= 1): no collisions
    tok_of = np.cumsum(ind[:n]) - 1
    j = np.arange(n, dtype=np.int64)
    delta = j - starts[tok_of]
    is_lit = delta == ln[tok_of]
    ptr = np.where(is_lit, j, j - off[tok_of])
    if (ptr < 0).any():
        raise ValueError("corrupt stream: match reaches before output start")

    # Pointer doubling until fixpoint: log2(longest chain) rounds.
    while True:
        ptr2 = ptr[ptr]
        if np.array_equal(ptr2, ptr):
            break
        ptr = ptr2
    return val[ptr].tobytes()


def decode(stream: bytes) -> bytes:
    """Decompress a complete reference-format stream on the host."""
    _, off, ln, nxt = bitio.parse_stream(stream)
    return decode_tokens_np(off, ln, nxt)
