"""Plain PyTorch reference of the reference codec's stream (cstdvd/lz77).

Written from the format, not from the program: it imports nothing of
``lz77_tpu_torch`` and takes nothing the program made but the streams it
judges.  Every function runs on whatever device its tensors are on, as a
few dozen large tensor operations.

The format (lz77.c, bitio.c): a 32-bit header, ``sb`` then ``la``, 16
LSB-first bits each; then tokens of ``bitof(sb)`` offset bits,
``bitof(la)`` length bits and 8 bits of the next byte, LSB-first, packed
with no gap; zero bits pad the last byte.  A token covers ``len + 1``
bytes: ``len`` bytes copied, one at a time, from ``off`` bytes back, then
the next byte.  The encoder's guarantee: at each token's position the
token holds the longest match within the last ``d_limit(sb)`` bytes,
capped at ``min(la - 1, bytes left - 1)``, the nearest offset on ties, and
``off = 0`` when the length is 0.
"""

from __future__ import annotations

import numpy as np
import torch

HEADER_BYTES = 4


def bitof(n: int) -> int:
    """Bits that count up to ``n``: ``ceil(log2(n))`` (bitio.c:41-43)."""
    return (n - 1).bit_length()


def d_limit(sb: int) -> int:
    """The farthest offset a stream of window ``sb`` may hold."""
    return min(sb, (1 << bitof(sb)) - 1)


def header(la: int, sb: int) -> bytes:
    return int(sb | (la << 16)).to_bytes(4, "little")


class Tokens:
    """A parsed stream: its header and its tokens as int64 tensors."""

    def __init__(self, la, sb, off, ln, nxt, bad_tail):
        self.la, self.sb = la, sb
        self.off, self.ln, self.nxt = off, ln, nxt
        self.bad_tail = bad_tail  # padding not zero, or not the last byte

    def __len__(self):
        return int(self.off.shape[0])


def parse(stream: bytes, device) -> Tokens:
    """Header and tokens of ``stream``; ``ValueError`` if it has no header
    or states a window outside the format's range."""
    if len(stream) < HEADER_BYTES:
        raise ValueError(f"stream of {len(stream)} bytes has no header")
    head = int.from_bytes(stream[:HEADER_BYTES], "little")
    sb, la = head & 0xFFFF, head >> 16
    if not (2 <= la <= 255 and 1 <= sb <= 65535):
        raise ValueError(f"header states la {la}, sb {sb}")
    ob, lb = bitof(sb), bitof(la)
    width = ob + lb + 8
    body = np.frombuffer(stream, np.uint8)[HEADER_BYTES:]
    T = body.shape[0] * 8 // width
    raw = torch.zeros(body.shape[0] + 8, dtype=torch.int64, device=device)
    raw[:body.shape[0]] = torch.from_numpy(body.copy()).to(device)
    bit = torch.arange(T, dtype=torch.int64, device=device) * width
    byte, shift = bit >> 3, bit & 7
    word = torch.zeros(T, dtype=torch.int64, device=device)
    for k in range((width + 7 + 7) // 8):  # bytes a token can touch
        word |= raw[byte + k] << (8 * k)
    v = (word >> shift) & ((1 << width) - 1)
    off = v & ((1 << ob) - 1)
    ln = (v >> ob) & ((1 << lb) - 1)
    nxt = (v >> (ob + lb)) & 0xFF
    used = T * width
    tail = int.from_bytes(body[used // 8:].tobytes(), "little") >> (used % 8)
    size_ok = body.shape[0] == -(-used // 8)
    return Tokens(la, sb, off, ln, nxt, bad_tail=tail != 0 or not size_ok)


def starts(tok: Tokens) -> torch.Tensor:
    """Each token's first byte in the decoded output."""
    span = tok.ln + 1
    return torch.cumsum(span, 0) - span


def invalid(tok: Tokens) -> torch.Tensor:
    """Tokens no encoder of this format may emit: a copy with offset 0,
    beyond ``d_limit`` or before the output's start, a length above
    ``la - 1``, or an offset on a token of length 0."""
    pos = starts(tok)
    copy = tok.ln > 0
    bad_copy = copy & ((tok.off < 1) | (tok.off > d_limit(tok.sb))
                       | (tok.off > pos) | (tok.ln > tok.la - 1))
    return bad_copy | (~copy & (tok.off != 0))


def decode(tok: Tokens) -> torch.Tensor:
    """The decoded bytes (uint8), by pointer doubling: a copied byte points
    ``off`` bytes back, a next byte is a root, and every byte takes its
    root's value.  Invalid copies read as roots of value 0 (``invalid``
    counts them)."""
    dev = tok.off.device
    T = len(tok)
    if T == 0:
        return torch.zeros(0, dtype=torch.uint8, device=dev)
    pos = starts(tok)
    span = tok.ln + 1
    n = int(pos[-1] + span[-1])
    k = torch.repeat_interleave(torch.arange(T, device=dev), span)
    i = torch.arange(n, dtype=torch.int64, device=dev)
    lit = (i - pos[k]) == tok.ln[k]
    ok = ~invalid(tok)[k]
    src = torch.where(lit | ~ok, i, i - tok.off[k])
    val = torch.where(lit, tok.nxt[k], 0)
    del k
    while True:
        nsrc = src[src]
        if torch.equal(nsrc, src):
            break
        src = nsrc
    return val[src].to(torch.uint8)


def longest_match(x: torch.Tensor, pos: torch.Tensor, la: int, sb: int,
                  budget: int = 1 << 25) -> tuple[torch.Tensor, torch.Tensor]:
    """(length, offset) of the longest match at each of ``pos`` in ``x``
    (uint8), by comparing every offset 1..d_limit(sb) at every length:
    capped at ``min(la - 1, len(x) - p - 1)``, the nearest offset on ties,
    (0, 0) where no byte matches.  ``budget`` bounds the elements of one
    block of positions."""
    n = x.shape[0]
    C = la - 1
    dev = x.device
    j = torch.arange(C, dtype=torch.int64, device=dev)
    pos = pos.to(torch.int64)
    # offsets beyond a position are never candidates: a position near the
    # start compares only the offsets it has
    D = max(1, min(d_limit(sb), int(pos.max()) if pos.numel() else 1))
    per = max(1, budget // max(1, D * C))
    lens, offs = [], []
    for b in range(0, pos.shape[0], per):
        p = pos[b:b + per]
        D = max(1, min(d_limit(sb), int(p.max())))
        d = torch.arange(1, D + 1, dtype=torch.int64, device=dev)
        cap = torch.clamp(torch.minimum(torch.full_like(p, C), n - p - 1),
                          min=0)
        tgt = x[torch.clamp(p[:, None] + j, max=n - 1)]            # (P, C)
        src = p[:, None, None] - d[None, :, None] + j              # (P, D, C)
        eq = x[torch.clamp(src, 0, n - 1)] == tgt[:, None, :]
        eq &= j < cap[:, None, None]
        run = torch.cumprod(eq.to(torch.int32), dim=2).sum(dim=2)  # (P, D)
        run = torch.where(d[None, :] <= p[:, None], run, -1)
        best = torch.argmax(run, dim=1)  # the first, so the nearest offset
        ln = torch.clamp(run.gather(1, best[:, None])[:, 0], min=0)
        lens.append(ln)
        offs.append(torch.where(ln > 0, best + 1, 0))
    if not lens:
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        return empty, empty
    return torch.cat(lens), torch.cat(offs)
