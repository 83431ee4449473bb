"""Parallel token-replay decode (plain tensor function, no kernel).

The reference decoder is a byte-serial loop — each copied byte may be the
source of the next (lz77.c:178-188).  Re-expressed as data-parallel pointer
chasing:

  1. output positions of every token = exclusive cumsum of (len + 1);
  2. every output byte is either a literal (value known) or a copy of the
     byte ``off`` positions earlier — a parent pointer;
  3. pointer doubling collapses every copy chain to its literal root in
     log2(n) gathers, handling overlapping (off < len) runs for free.

Works for any conforming stream — including ones produced by the C encoder —
because token bit offsets are affine and the copy semantics depend only on
absolute output positions, not on the reference's ring-buffer recycling.
The walk-decode kernel (``ops.decode_walk``) is the fast form of the same
idea; this one decodes a chunk of tokens against a carried tail and backs
``models.decoder``.
"""

from __future__ import annotations

import torch


def decode_tokens(
    off: torch.Tensor,
    ln: torch.Tensor,
    nxt: torch.Tensor,
    count,
    prev_tail: torch.Tensor,
    *,
    la: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode a chunk of tokens given the tail of already-decoded output.

    Args:
      off, ln, nxt: (T,) integer token fields (padded past ``count``).
      count: scalar (int or tensor) — number of valid tokens.
      prev_tail: (H,) uint8 — last H decoded bytes before this chunk,
        tail-aligned (prev_tail[-1] is the byte immediately preceding this
        chunk's output).  H must be >= the largest representable offset.
      la: lookahead parameter (bounds per-token output to ``la``).

    Returns:
      (out, out_len): out is (T * la,) uint8 with the first out_len bytes
      valid; out_len is a 0-d int64 tensor on the device.
    """
    T = off.shape[0]
    H = prev_tail.shape[0]
    OUT = T * la
    W = H + OUT
    dev = off.device
    i64 = dict(dtype=torch.int64, device=dev)
    off, ln = off.to(torch.int64), ln.to(torch.int64)
    if T == 0:
        return torch.zeros(0, dtype=torch.uint8, device=dev), torch.zeros((), **i64)

    valid = torch.arange(T, **i64) < torch.as_tensor(count).to(**i64)
    sz = torch.where(valid, ln + 1, 0)
    ends = torch.cumsum(sz, 0)
    starts = ends - sz  # exclusive cumsum
    out_len = ends[T - 1]

    # Which token covers each output byte: +1 at every token start, cumsum.
    # Slot W takes what the padding tokens would add, and what tokens that
    # a corrupt length puts past the buffer add (JAX's mode="drop"): no
    # byte reads it.
    ind = torch.zeros(W + 1, **i64).index_add_(
        0, torch.where(valid, H + starts, W).clamp(max=W),
        valid.to(torch.int64)
    )
    tok_of = torch.cumsum(ind, 0)[:W] - 1
    tclamp = torch.clamp(tok_of, 0, T - 1)

    w = torch.arange(W, **i64)
    delta = w - (H + starts[tclamp])
    is_lit = delta == ln[tclamp]
    ptr = torch.where((w < H) | is_lit, w, w - off[tclamp])
    ptr = torch.clamp(ptr, 0, W - 1)

    val = torch.zeros(W + 1, dtype=torch.uint8, device=dev)
    val[:H] = prev_tail
    val[torch.where(valid, H + starts + ln, W).clamp(max=W)] = \
        nxt.to(torch.uint8)

    # Collapse copy chains: after k rounds every chain of length <= 2^k is
    # resolved; ceil(log2(W)) rounds resolve everything.
    for _ in range(max(1, (W - 1).bit_length())):
        ptr = ptr[ptr]

    return val[ptr][H:], out_len
