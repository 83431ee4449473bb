"""The reference's parameter edges, and a corrupt-stream corpus, from a seed.

The reference accepts ``-l 2..255`` and ``-s 1..65535`` (main.c:35-38).
:data:`GRID` holds the ends of both ranges: ``sb`` 1, 2 and 3 (offset widths
of 0, 1 and 2 bits; at ``sb`` 1 no copy can be coded), the power-of-two
sizes that the CLI takes only with ``--force-sb``, and ``la`` 2 and 255.
:func:`make_input` gives one input for every point (text, zeros, random
bytes and a run of one byte across a block boundary), and
:func:`corrupt_streams` cut, flipped and padded streams to decode.
``chip_smoke.py`` runs both on the card, ``tests/test_torch_edges.py`` on the
CPU against the JAX package, so the two see the same corpus.
"""

from __future__ import annotations

import numpy as np

from . import corpus

# (la, sb): off_bits 0, 1 and 2; power-of-two sb; both ends of la
GRID = (
    (255, 1), (2, 1), (15, 1),
    (2, 2), (15, 2), (255, 2),
    (2, 3),
    (128, 256), (15, 4096),
    (2, 65535), (255, 65535),
)
# the grid points whose streams the corrupt corpus is cut from: off_bits 0,
# off_bits 1 and a byte-aligned 24-bit width at a power-of-two sb
CORRUPT_GRID = ((255, 1), (15, 2), (15, 4096))
# a header (la 3, sb 7) and one token whose length (3) is more than la - 1
SAMPLE = bytes.fromhex("07000300ffff")

# the card's input (82,520 bytes) and block size
CARD_SIZES = dict(text=48 << 10, zeros=16 << 10, random=16 << 10, run=1000,
                  block_size=16 << 10)
# the CPU tests' input (about 1.2 KiB) and block size; the corrupt corpus is
# cut from streams of this input on the card too
SMALL_SIZES = dict(text=640, zeros=128, random=256, run=200, block_size=1024)


def make_input(seed: int, *, text: int, zeros: int, random: int, run: int,
               block_size: int) -> bytes:
    """Text, zeros and random bytes, then a run of ``run`` copies of one byte
    that starts ``run // 2`` bytes before a block boundary, then 100 bytes
    of text.  ``text + zeros + random`` must be a multiple of
    ``block_size``."""
    if (text + zeros + random) % block_size or run // 2 > random:
        raise ValueError("text + zeros + random must end on a block "
                         "boundary, with the run's first half inside it")
    rng = np.random.default_rng(seed)
    return b"".join((
        corpus.synth_english(text, seed=seed + 1),
        bytes(zeros),
        rng.integers(0, 256, random - run // 2, dtype=np.uint8).tobytes(),
        bytes([int(rng.integers(1, 256))]) * run,
        corpus.synth_english(100, seed=seed + 2),
    ))


def outcome(fn, *args, **kwargs):
    """What a call gives: its result, or its exception's type and text (a
    decode either returns bytes or raises one of these)."""
    try:
        return fn(*args, **kwargs)
    except (ValueError, RuntimeError, IndexError) as e:
        return type(e).__name__, str(e)


def _flip(stream: bytes, bit: int) -> bytes:
    b = bytearray(stream)
    b[bit // 8] ^= 1 << (bit % 8)
    return bytes(b)


def corrupt_streams(seed: int, streams: dict[str, bytes]) -> dict[str, bytes]:
    """Damaged copies of each stream, by name: cut at 0, 2, 4 and 5 bytes, a
    third, a half and one byte short of its length; one bit flipped in the
    header's sb field and one in its la field's low byte; two bits flipped
    in the payload; 1 and 7 random bytes added.  With :data:`SAMPLE`."""
    rng = np.random.default_rng(seed)
    out = {"sample": SAMPLE}
    for name, s in streams.items():
        n = len(s)
        for k in sorted({0, 2, 4, 5, n // 3, n // 2, n - 1}):
            out[f"{name}_cut{k}"] = s[:k]
        for lo, hi in ((0, 16), (16, 24)):
            bit = int(rng.integers(lo, hi))
            out[f"{name}_flip{bit}"] = _flip(s, bit)
        for bit in sorted(rng.choice(np.arange(32, 8 * n), 2, replace=False)):
            out[f"{name}_flip{int(bit)}"] = _flip(s, int(bit))
        for k in (1, 7):
            pad = rng.integers(0, 256, k, dtype=np.uint8).tobytes()
            out[f"{name}_pad{k}"] = s + pad
    return out
