"""Executable specification of the codec in plain numpy.

This is the semantic reference for all accelerated paths: a direct, serial
statement of what encode and decode *mean*, independent of the PyTorch/CUDA
and native implementations.  It is the differential-test anchor at small
sizes and the ``backend="numpy"`` encoder.  It is deliberately simple, not
fast.

Encode semantics (SURVEY.md §2.4): at each position emit the token for the
*true longest* match within the sliding window ``[p - d_limit, p)`` (nearest
offset wins ties), capped at ``min(la, remaining) - 1`` so ``next`` is always
a real byte (lz77.c:87,134; tree.c:136).  This dominates the reference BST's
path-limited match, so token count — and therefore compressed size, tokens
being fixed-width — is <= the reference's for the same window parameters.

Decode semantics (lz77.c:164-195): replay tokens; each match byte copies from
``off`` bytes behind the write cursor, one byte at a time, so overlapping
copies (off < len) replicate runs.
"""

from __future__ import annotations

import numpy as np

from .. import bitio, spec


def find_longest_match(
    x: np.ndarray, p: int, cap: int, dmax: int
) -> tuple[int, int]:
    """Longest match for position ``p``: (length, distance).

    ``x`` is the full input; candidates are distances 1..dmax; match length
    is capped at ``cap``.  Overlapping sources (d < length) are legal because
    byte-serial decode reproduces the input bytes.  Ties prefer the smallest
    distance.  Returns (0, 0) when there is no match.
    """
    if cap <= 0 or dmax <= 0:
        return 0, 0
    ds = np.arange(1, dmax + 1)
    alive = np.ones(dmax, dtype=bool)
    lens = np.zeros(dmax, dtype=np.int64)
    for i in range(cap):
        alive &= x[p - ds + i] == x[p + i]
        if not alive.any():
            break
        lens += alive
    best = int(lens.argmax())  # argmax returns first (= smallest d) on ties
    if lens[best] == 0:
        return 0, 0
    return int(lens[best]), int(ds[best])


def encode_tokens(
    data: bytes, params: spec.Params
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Greedy longest-match parse -> (off, len, next) token arrays."""
    x = np.frombuffer(data, dtype=np.uint8)
    n = x.shape[0]
    offs: list[int] = []
    lens: list[int] = []
    nxts: list[int] = []
    p = 0
    while p < n:
        cap = min(params.len_limit, n - p - 1)
        dmax = min(params.d_limit, p)
        length, dist = find_longest_match(x, p, cap, dmax)
        offs.append(dist)
        lens.append(length)
        nxts.append(int(x[p + length]))
        p += length + 1
    return (
        np.asarray(offs, dtype=np.int64),
        np.asarray(lens, dtype=np.int64),
        np.asarray(nxts, dtype=np.int64),
    )


def encode(data: bytes, params: spec.Params | None = None) -> bytes:
    """Compress ``data`` into a complete reference-format stream."""
    params = params or spec.Params()
    off, length, nxt = encode_tokens(data, params)
    return bitio.build_stream(off, length, nxt, params)


def decode_tokens(
    off: np.ndarray, length: np.ndarray, nxt: np.ndarray
) -> bytes:
    """Replay tokens into output bytes (byte-serial copy semantics)."""
    total = int(length.sum() + length.shape[0])
    out = np.zeros(total, dtype=np.uint8)
    back = 0
    for i in range(off.shape[0]):
        ln = int(length[i])
        if ln > 0:
            d = int(off[i])
            if d == 0:
                raise ValueError(
                    f"corrupt stream: token {i} has len={ln} but off=0 "
                    "(reference emits this only for degenerate sb sizes)"
                )
            if d >= ln:
                out[back : back + ln] = out[back - d : back - d + ln]
            else:
                # Overlapping copy: byte-serial semantics replicate the
                # d-byte pattern (lz77.c:178-188).
                pattern = out[back - d : back]
                reps = -(-ln // d)
                out[back : back + ln] = np.tile(pattern, reps)[:ln]
            back += ln
        out[back] = nxt[i]
        back += 1
    return out.tobytes()


def decode(stream: bytes) -> bytes:
    """Decompress a complete reference-format stream."""
    _, off, length, nxt = bitio.parse_stream(stream)
    return decode_tokens(off, length, nxt)
