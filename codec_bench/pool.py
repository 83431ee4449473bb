"""Seeded, vectorised surrogates of the Silesia corpus's file classes.

A frozen copy of the classes of ``lz77_tpu_torch/corpus.py`` (english,
source, xml, records, binary) plus incompressible bytes, rewritten so that
each tile is a few NumPy calls instead of a Python loop a word or a line.
A file is its class's tile, made from the run's seed and the file's index,
repeated to the file's published size.  The tile is at least 1 MiB, far
beyond the largest window a stream may state (65,535 bytes), so the matcher
never sees a repeat: the match work and the ratio are those of fresh data.

Each class takes its vocabulary and layout (words, identifiers, opcodes,
the kinds and lengths of a binary's segments: what sets how much a file
repeats, and so the match work) from a generator fixed by the file's index
alone, and draws the text over them (which word, line, tag or opcode comes
next, operands, numbers, random bytes) from the run's seed: every seed has
other bytes and the same work.
"""

from __future__ import annotations

import numpy as np

MIN_TILE = 1 << 20

_LETTERS = np.frombuffer(b"etaoinshrdlcumwfgypbvkjxqz", np.uint8)
_LETTER_P = np.array([12.7, 9.1, 8.2, 7.5, 7.0, 6.7, 6.3, 6.1, 6.0, 4.3,
                      4.0, 2.8, 2.8, 2.4, 2.4, 2.2, 2.0, 2.0, 1.9, 1.5,
                      1.0, 0.8, 0.2, 0.2, 0.1, 0.1])
_LETTER_P = _LETTER_P / _LETTER_P.sum()


class Table:
    """Byte strings of varied length, packed into one array."""

    def __init__(self, strings):
        strings = [bytes(s) for s in strings]
        self.lens = np.array([len(s) for s in strings], np.int64)
        self.starts = np.concatenate([[0], np.cumsum(self.lens)[:-1]])
        self.flat = np.frombuffer(b"".join(strings), np.uint8)

    def __len__(self):
        return len(self.lens)

    def offset(self, other: "Table") -> "Table":
        """This table followed by ``other``: ids of ``other`` shift by
        ``len(self)``."""
        out = Table([])
        out.lens = np.concatenate([self.lens, other.lens])
        out.flat = np.concatenate([self.flat, other.flat])
        out.starts = np.concatenate(
            [self.starts, other.starts + len(self.flat)])
        return out

    def join(self, ids: np.ndarray) -> np.ndarray:
        """The strings ``ids`` (any shape, read in C order) end to end."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        lens = self.lens[ids]
        total = int(lens.sum())
        first = np.cumsum(lens) - lens
        owner = np.repeat(np.arange(ids.shape[0]), lens)
        within = np.arange(total) - first[owner]
        return self.flat[self.starts[ids][owner] + within]


def _words(shape, count: int = 4000) -> Table:
    """A word pool with English letter frequencies (corpus.py's)."""
    lens = np.clip(shape.normal(4.7, 2.2, count).astype(np.int64), 1, 14)
    letters = shape.choice(_LETTERS, size=int(lens.sum()), p=_LETTER_P)
    cuts = np.cumsum(lens)[:-1]
    return Table(np.split(letters, cuts))


def english(rng, shape, n: int) -> np.ndarray:
    """Word salad with Zipf word reuse (dickens, webster, reymont)."""
    words = _words(shape)
    k = len(words)
    # each word with its separator: " " or, 6 % of the time, ". "
    table = Table([words.flat[s:s + l].tobytes() + sep
                   for sep in (b" ", b". ")
                   for s, l in zip(words.starts, words.lens)])
    count = n // 4 + 64
    ranks = rng.zipf(1.3, size=count) % k
    ids = ranks + k * (rng.random(count) < 0.06)
    return table.join(ids)[:n]


def source(rng, shape, n: int) -> np.ndarray:
    """C-like source lines (samba)."""
    alpha = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz_", np.uint8)
    idents = [shape.choice(alpha, size=int(k)).tobytes()
              for k in shape.integers(3, 12, 120)]
    kw = [b"int ", b"return ", b"if (", b"for (", b"static ", b"void ",
          b"struct ", b"const ", b"char *", b"size_t "]
    lit = [b"", b" = ", b"[i];\n", b" < ", b") {\n", b"(", b", sizeof(",
           b"));\n", b"}\n"]
    ind = [b"", b"    ", b"        "]
    I0, K0, L0, N0 = 0, len(ind), len(ind) + len(kw), \
        len(ind) + len(kw) + len(lit)
    table = Table(ind + kw + lit + idents)
    count = n // 12 + 64
    i = I0 + rng.integers(0, 3, count)
    a = N0 + rng.integers(0, 120, count)
    b = N0 + rng.integers(0, 120, count)
    k = K0 + rng.integers(0, len(kw), count)
    form = rng.integers(0, 4, count)
    e = np.full(count, L0)  # the empty string
    s = lambda j: np.full(count, L0 + j)  # noqa: E731
    cols = np.select(
        [form[:, None] == f for f in range(3)],
        [np.stack([i, k, a, s(1), b, s(2), e], 1),
         np.stack([i, np.full(count, K0 + 2), a, s(3), b, s(4), e], 1),
         np.stack([i, a, s(5), b, s(6), a, s(7)], 1)],
        np.stack([i, s(8), e, e, e, e, e], 1),
    )
    return table.join(cols)[:n]


def xml(rng, shape, n: int) -> np.ndarray:
    """Tag-heavy XML (xml)."""
    tags = [b"entry", b"name", b"value", b"item", b"record", b"field"]
    words = _words(shape)
    lit = [b"<", b' id="', b'">', b"</", b">\n"]
    nums = [str(v).encode() for v in range(10000)]
    base = Table(lit + tags + nums)
    table = base.offset(words)
    T0, N0, W0 = len(lit), len(lit) + len(tags), len(base)
    count = n // 20 + 64
    t = T0 + rng.integers(0, len(tags), count)
    w = W0 + rng.integers(0, len(words), count)
    v = N0 + rng.integers(0, 10000, count)
    L = lambda j: np.full(count, j)  # noqa: E731
    cols = np.stack([L(0), t, L(1), v, L(2), w, L(3), t, L(4)], 1)
    return table.join(cols)[:n]


def records(rng, shape, n: int) -> np.ndarray:
    """Fixed-layout database records, 40 bytes each (nci, osdb, sao)."""
    count = n // 40 + 1
    rid = rng.integers(0, 99999, count)
    vals = rng.integers(0, 999, (count, 4))

    def digits(v, width):
        p = 10 ** np.arange(width - 1, -1, -1)
        return (v[:, None] // p % 10 + 48).astype(np.uint8)

    bar = np.full((count, 1), ord("|"), np.uint8)
    parts = [digits(rid, 8)]
    for j in range(4):
        parts += [bar, digits(vals[:, j], 6)]
    parts += [bar, np.tile(np.frombuffer(b"OK\n", np.uint8), (count, 1))]
    return np.concatenate(parts, 1).reshape(-1)[:n]


def binary(rng, shape, n: int) -> np.ndarray:
    """Executable-like bytes: opcode/operand pairs, zero-padded tables and
    compressed-looking resources (mozilla, ooffice, mr)."""
    opcodes = shape.integers(0, 256, 64, dtype=np.uint8)
    count = n // 300 + 64
    kind = shape.random(count)
    lens = np.where(kind < 0.4, 2 * shape.integers(64, 512, count),
                    np.where(kind < 0.7, shape.integers(32, 1024, count),
                             shape.integers(64, 512, count)))
    seg = np.repeat(np.arange(count), lens)[:n]
    pos = np.arange(seg.shape[0]) - (np.cumsum(lens) - lens)[seg]
    rnd = rng.integers(0, 256, seg.shape[0], dtype=np.uint8)
    ops = opcodes[rng.integers(0, 64, seg.shape[0])]
    k = kind[seg]
    out = np.where(k < 0.4, np.where(pos % 2 == 0, ops, rnd),
                   np.where(k < 0.7, 0, rnd)).astype(np.uint8)
    return out


def random(rng, shape, n: int) -> np.ndarray:
    """Incompressible bytes (x-ray stands in as such)."""
    return rng.integers(0, 256, n, dtype=np.uint8)


CLASSES = {"english": english, "source": source, "xml": xml,
           "records": records, "binary": binary, "random": random}


def make_file(cls: str, size: int, seed: int, index: int,
              tile: int = MIN_TILE) -> bytes:
    """``size`` bytes of class ``cls``: a tile of ``min(size, tile)`` bytes
    from ``(seed, index)``, repeated."""
    rng = np.random.default_rng([index, seed])
    shape = np.random.default_rng([index, 0x5AFE])
    t = min(size, tile)
    body = CLASSES[cls](rng, shape, t)
    while body.shape[0] < t:  # a generator may fall short of its estimate
        body = np.concatenate(
            [body, CLASSES[cls](rng, shape, t - body.shape[0])])
    return np.resize(body[:t], size).tobytes()


def make_pool(files: list[dict], seed: int, *, scale: int = 1,
              tile: int = MIN_TILE) -> list[bytes]:
    """The config's ``files`` (each ``{"name", "bytes", "class"}``), in
    order.  ``scale`` divides every size (the CPU tests' small pools)."""
    return [make_file(f["class"], max(1, f["bytes"] // scale), seed, i, tile)
            for i, f in enumerate(files)]
