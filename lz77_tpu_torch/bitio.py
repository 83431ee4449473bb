"""Vectorized little-endian bitstream codec (host side).

Bit-exact numpy reimplementation of the reference's bit-granular file I/O
(bitio.c): values are laid down LSB-first within each byte, bytes in
increasing order.  Where the reference moves ONE bit per loop iteration
(bitio.c:213-236, 270-295), this module packs/unpacks entire token arrays in
a handful of numpy ops — the fixed per-stream token width makes every token's
bit offset affine (``32 + i*width``), so no scan is needed.

This is the host-side bit I/O component (SURVEY.md §2 component 7); on the
device the walk kernel packs token words itself (``ops.parse_walk``).
"""

from __future__ import annotations

import numpy as np

from . import spec


def _field_bits(values: np.ndarray, nbits: int) -> np.ndarray:
    """(T,) uint32 -> (T, nbits) uint8 of LSB-first bits."""
    v = values.astype(np.uint32, copy=False)[:, None]
    shifts = np.arange(nbits, dtype=np.uint32)[None, :]
    return ((v >> shifts) & 1).astype(np.uint8)


def _bits_to_uint(bits: np.ndarray) -> np.ndarray:
    """(T, nbits) uint8 LSB-first bits -> (T,) int64 values."""
    nbits = bits.shape[-1]
    out = np.zeros(bits.shape[:-1], dtype=np.int64)
    for j in range(nbits):
        out |= bits[..., j].astype(np.int64) << j
    return out


def tokens_to_bytes(
    off: np.ndarray, length: np.ndarray, nxt: np.ndarray, params: spec.Params
) -> np.ndarray:
    """Byte-aligned fast path: token arrays -> packed payload bytes.

    Valid only when the token width is a byte multiple (e.g. the default
    12+4+8 = 24 bits): each token occupies exactly width/8 bytes, so the
    whole payload is a (T, width/8) byte matrix built with a few shifts.
    """
    W = params.width
    assert W % 8 == 0 and W <= 64
    bo, bl = params.off_bits, params.len_bits
    v = (
        off.astype(np.int64)
        | (length.astype(np.int64) << bo)
        | (nxt.astype(np.int64) << (bo + bl))
    )
    nbytes = W // 8
    out = np.empty((off.shape[0], nbytes), np.uint8)
    for k in range(nbytes):
        out[:, k] = (v >> (8 * k)) & 0xFF
    return out.reshape(-1)


def bytes_to_tokens(
    payload: np.ndarray, T: int, params: spec.Params
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Byte-aligned fast path inverse of :func:`tokens_to_bytes`."""
    W = params.width
    assert W % 8 == 0 and W <= 64
    nbytes = W // 8
    bo, bl = params.off_bits, params.len_bits
    mat = payload[: T * nbytes].reshape(T, nbytes)
    v = np.zeros(T, np.int64)
    for k in range(nbytes):
        v |= mat[:, k].astype(np.int64) << (8 * k)
    off = v & ((1 << bo) - 1)
    length = (v >> bo) & ((1 << bl) - 1)
    nxt = (v >> (bo + bl)) & 0xFF
    return off, length, nxt


def scalar_bits(value: int, nbits: int) -> np.ndarray:
    """One value as an LSB-first uint8 bit vector."""
    return _field_bits(np.asarray([value]), nbits)[0]


def tokens_to_bits(
    off: np.ndarray, length: np.ndarray, nxt: np.ndarray, params: spec.Params
) -> np.ndarray:
    """Token arrays -> flat LSB-first bit array of shape (T * width,).

    Field order per token: offset, length, next (lz77.c:249-251).
    """
    T = off.shape[0]
    parts = []
    if params.off_bits:
        parts.append(_field_bits(off, params.off_bits))
    if params.len_bits:
        parts.append(_field_bits(length, params.len_bits))
    parts.append(_field_bits(nxt, 8))
    if not parts:
        return np.zeros((0,), dtype=np.uint8)
    bits = np.concatenate(parts, axis=1) if len(parts) > 1 else parts[0]
    assert bits.shape == (T, params.width)
    return bits.reshape(-1)


def bits_to_tokens(
    bits: np.ndarray, params: spec.Params
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Flat bit array (multiple of width) -> (off, len, next) int64 arrays."""
    W = params.width
    T = bits.shape[0] // W
    tok = bits[: T * W].reshape(T, W)
    bo, bl = params.off_bits, params.len_bits
    off = _bits_to_uint(tok[:, :bo])
    length = _bits_to_uint(tok[:, bo : bo + bl])
    nxt = _bits_to_uint(tok[:, bo + bl : bo + bl + 8])
    return off, length, nxt


def build_stream(
    off: np.ndarray, length: np.ndarray, nxt: np.ndarray, params: spec.Params
) -> bytes:
    """Assemble a complete compressed stream: header + tokens + zero padding.

    Header is sb then la, 16 LSB-first bits each (lz77.c:74-75).  The final
    partial byte is padded with zero bits, mirroring bitIO_close's round-up
    of a zero-initialised buffer (bitio.c:180-182).
    """
    header = np.concatenate(
        [
            scalar_bits(params.sb, spec.HEADER_FIELD_BITS),
            scalar_bits(params.la, spec.HEADER_FIELD_BITS),
        ]
    )
    body = tokens_to_bits(
        np.asarray(off), np.asarray(length), np.asarray(nxt), params
    )
    all_bits = np.concatenate([header, body])
    return np.packbits(all_bits, bitorder="little").tobytes()


def byte_aligned(params: spec.Params) -> bool:
    """True when tokens pack to whole bytes (default 24-bit tokens do)."""
    return params.width % 8 == 0


def header_bytes(params: spec.Params) -> bytes:
    """The 4-byte stream header: sb then la, 16 LSB-first bits each."""
    return np.packbits(
        np.concatenate(
            [
                scalar_bits(params.sb, spec.HEADER_FIELD_BITS),
                scalar_bits(params.la, spec.HEADER_FIELD_BITS),
            ]
        ),
        bitorder="little",
    ).tobytes()


def tokens_to_chunk(
    off: np.ndarray, length: np.ndarray, nxt: np.ndarray, params: spec.Params
) -> np.ndarray:
    """Per-block payload chunk: packed bytes when byte-aligned, else bits."""
    if byte_aligned(params):
        return tokens_to_bytes(off, length, nxt, params)
    return tokens_to_bits(off, length, nxt, params)


def assemble_stream(chunks: list[np.ndarray], params: spec.Params) -> bytes:
    """Header + concatenated per-block payload chunks -> stream bytes."""
    if byte_aligned(params):
        return header_bytes(params) + b"".join(c.tobytes() for c in chunks)
    return concat_token_bits(chunks, params)


def concat_token_bits(bit_chunks: list[np.ndarray], params: spec.Params) -> bytes:
    """Header + concatenation of per-block token bit arrays -> stream bytes.

    Used by the block-parallel encoder: per-block payloads are bit-contiguous
    (no per-block padding), exactly as if a single serial encoder had emitted
    all tokens (SURVEY.md §7 design insight 4).
    """
    header = np.concatenate(
        [
            scalar_bits(params.sb, spec.HEADER_FIELD_BITS),
            scalar_bits(params.la, spec.HEADER_FIELD_BITS),
        ]
    )
    all_bits = np.concatenate([header] + bit_chunks)
    return np.packbits(all_bits, bitorder="little").tobytes()


def parse_stream(
    data: bytes,
) -> tuple[spec.Params, np.ndarray, np.ndarray, np.ndarray]:
    """Full stream -> (params, off, len, next).

    Token count replicates the reference decoder's EOF-by-short-read rule:
    ``(8*(size-4)) // width`` whole tokens, the rest is padding.
    """
    if len(data) < spec.HEADER_BYTES:
        raise ValueError(
            f"stream too short for header: {len(data)} < {spec.HEADER_BYTES} bytes"
        )
    raw = np.frombuffer(data, dtype=np.uint8)
    head_bits = np.unpackbits(raw[: spec.HEADER_BYTES], bitorder="little")
    sb = int(_bits_to_uint(head_bits[:16][None, :])[0])
    la = int(_bits_to_uint(head_bits[16:32][None, :])[0])
    params = spec.Params(la=la, sb=sb)
    payload = raw[spec.HEADER_BYTES :]
    T = spec.token_count(payload.shape[0], params.width)
    if byte_aligned(params):
        off, length, nxt = bytes_to_tokens(payload, T, params)
        return params, off, length, nxt
    # Only unpack the bytes that contain whole tokens.
    needed_bytes = (T * params.width + 7) // 8
    bits = np.unpackbits(payload[:needed_bytes], bitorder="little")[
        : T * params.width
    ]
    off, length, nxt = bits_to_tokens(bits, params)
    return params, off, length, nxt
