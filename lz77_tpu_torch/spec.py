"""Format specification for the LZ77 token stream.

This module is the single source of truth for the *observable* stream format
of the reference codec (cstdvd/lz77): header layout, token field widths, bit
order, and parameter validity rules.  Every other component of this package
(numpy spec model, PyTorch ops and CUDA kernels, native host binding) derives
its constants from here.  Own copy of the JAX package's ``spec`` module: the
two packages share a stream format, not code.

Reference contract (see SURVEY.md §2.3, verified against the C binary):

* Header: 32 bits — SB_SIZE in 16 bits then LA_SIZE in 16 bits, LSB-first
  within each byte (reference: lz77.c:74-75, MAX_BIT_BUFFER=16 lz77.c:24).
* Token: offset in ``bitof(sb)`` bits, length in ``bitof(la)`` bits, next
  char in 8 bits, in that order (lz77.c:249-251).  Token width is constant
  per stream, so token *i* starts at bit ``32 + i*width``.
* Bit order: LSB-first within each byte, bytes in increasing order
  (bitio.c:213-236, 270-295) — a little-endian bitstream.
* Length semantics: emitted match length is in ``[0, la-1]`` — the maximum
  value is never emitted (tree.c:136); ``next`` is always a real input byte.
  Every token consumes ``len+1`` input bytes.
* Offset semantics: ``off in [1, sb]`` for matches, ``0`` for literals.
* EOF: no terminator; decoding stops when fewer than ``width`` bits remain
  (lz77.c:266-280).  Final-byte padding is zero bits and can never form a
  phantom token because every token is wider than 7 bits.

Divergence policy (SURVEY.md §2.3.8): the reference *corrupts* data for
``sb`` equal to 0, 1 or an exact power of two because ``bitof(2^k) = k`` bits
cannot hold offset ``2^k``.  We do not replicate the corruption: the encoder
restricts match distances to ``d_limit(sb) = min(sb, 2**bitof(sb) - 1)`` so
every emitted stream is valid and decodable by the reference decoder, and the
CLI additionally rejects those degenerate sizes unless forced.
"""

from __future__ import annotations

import dataclasses

# Compile-time defaults of the reference (lz77.c:21-24).
DEFAULT_LA_SIZE = 15
DEFAULT_SB_SIZE = 4095
# Window multiplier of the reference's ring buffer (lz77.c:23).  Our block
# representation does not use it, but the decoder reconstruction tests do.
WINDOW_MULTIPLIER = 3
# Header field width in bits (lz77.c:24).
HEADER_FIELD_BITS = 16
HEADER_BITS = 2 * HEADER_FIELD_BITS
HEADER_BYTES = HEADER_BITS // 8

# CLI bounds of the reference (main.c:35-38).
MIN_LA_SIZE = 2
MAX_LA_SIZE = 255
MIN_SB_SIZE = 1  # the reference allows 0 but that is UB (bitof(0)); we reject
MAX_SB_SIZE = 65535


def bitof(n: int) -> int:
    """Minimum bits to count up to ``n`` — ``ceil(log2(n))``.

    Integer-exact equivalent of the reference's float computation
    (bitio.c:41-43) for all n in [1, 65535].  ``bitof(1) == 0``.
    """
    if n < 1:
        raise ValueError(f"bitof undefined for n={n} (reference UB for -s 0)")
    return (n - 1).bit_length()


def token_width(la: int, sb: int) -> int:
    """Bits per token: off(bitof(sb)) + len(bitof(la)) + next(8)."""
    return bitof(sb) + bitof(la) + 8


def d_limit(sb: int) -> int:
    """Largest match distance the encoder may emit safely.

    ``min(sb, 2**bitof(sb)-1)``: equals ``sb`` for every non-power-of-two
    size; for degenerate sizes (1, powers of two) it restricts the search so
    offsets always fit their field (divergence policy, see module docstring).
    """
    return min(sb, (1 << bitof(sb)) - 1)


def len_limit(la: int) -> int:
    """Largest emittable match length: ``la - 1`` (tree.c:136 stops early)."""
    return la - 1


def is_degenerate_sb(sb: int) -> bool:
    """True for sb values the reference encoder corrupts (0/1/powers of 2)."""
    return sb < 2 or (sb & (sb - 1)) == 0


@dataclasses.dataclass(frozen=True)
class Params:
    """Validated codec parameters (the in-band header contents)."""

    la: int = DEFAULT_LA_SIZE
    sb: int = DEFAULT_SB_SIZE

    def __post_init__(self) -> None:
        if not (MIN_LA_SIZE <= self.la <= MAX_LA_SIZE):
            raise ValueError(
                f"lookahead size {self.la} outside [{MIN_LA_SIZE}, {MAX_LA_SIZE}]"
            )
        if not (MIN_SB_SIZE <= self.sb <= MAX_SB_SIZE):
            raise ValueError(
                f"search-buffer size {self.sb} outside [{MIN_SB_SIZE}, {MAX_SB_SIZE}]"
            )

    @property
    def off_bits(self) -> int:
        return bitof(self.sb)

    @property
    def len_bits(self) -> int:
        return bitof(self.la)

    @property
    def width(self) -> int:
        return token_width(self.la, self.sb)

    @property
    def d_limit(self) -> int:
        return d_limit(self.sb)

    @property
    def len_limit(self) -> int:
        return len_limit(self.la)


def token_count(payload_bytes: int, width: int) -> int:
    """Number of whole tokens in a payload of ``payload_bytes`` bytes.

    Mirrors the reference decoder's EOF rule: any trailing span shorter than
    ``width`` bits is padding, never a token (lz77.c:266-280).
    """
    if payload_bytes < 0:
        raise ValueError("negative payload")
    return (payload_bytes * 8) // width


def stream_size_bytes(num_tokens: int, width: int) -> int:
    """Exact compressed file size: header + tokens + round-up padding."""
    return HEADER_BYTES + (num_tokens * width + 7) // 8
