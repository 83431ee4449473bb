"""Greedy parse as a parallel orbit computation (plain tensor functions).

The reference's encode loop walks ``p <- p + len + 1`` one token at a time
(lz77.c:89-136).  That jump chain is the only sequential dependency left in
encoding once the match table is known.  Pointer doubling resolves it:
maintain S[i] = f^i(entry) and the table of f^(2^k); each round doubles the
number of known token starts, so the whole parse is log2(B) gathers instead
of a length-T serial walk.

Because the previous block's final token may overhang into this block by up
to la-1 bytes, the parse takes an ``entry`` offset and reports its
``exit_pos`` (first chain position >= the block's token-start limit, which
lands in [B, B + la - 1] mid-stream).  Chaining entry offsets block to block
reproduces the exact global serial parse.

These functions hold no kernel; the walk kernels (``ops.parse_walk``,
``ops.fused_walk``) compute the same parse on the fused path.
"""

from __future__ import annotations

import torch


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v).to(device=like.device, dtype=torch.int64)


def greedy_parse(
    L: torch.Tensor,
    valid_len,
    entry=0,
    *,
    la: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Token start positions of the greedy parse from ``entry``.

    Args:
      L: (B,) integer match lengths (capped so p + L + 1 <= valid data end).
      valid_len: scalar (int or tensor) — token-start limit: min(block valid
        bytes, B).
      entry: scalar in [0, la-1] — first unconsumed position.
      la: lookahead parameter (bounds overhang past the block).

    Returns:
      (starts, count, exit_pos): starts is (B,) int32 with
      starts[i] = f^i(entry); count (0-d int32) is the number of starts <
      valid_len; exit_pos = f^B(entry) (0-d int32) is where the chain leaves
      the block (>= valid_len).
    """
    B = L.shape[0]
    BE = B + la  # chain values never exceed B-1 + (la-1) + 1 = B + la - 1
    dev = L.device
    valid_len = _scalar(valid_len, L)
    pos = torch.arange(BE, dtype=torch.int64, device=dev)
    Lp = torch.cat([L.to(torch.int64),
                    torch.zeros(la, dtype=torch.int64, device=dev)])
    # Positions >= valid_len are fixpoints: the chain parks at its exit.
    J = torch.where(pos < valid_len, torch.clamp(pos + Lp + 1, max=BE - 1), pos)

    S = torch.zeros(B + 1, dtype=torch.int64, device=dev)
    S[0] = _scalar(entry, L)
    m = 1
    while m <= B:
        span = min(m, B + 1 - m)
        S[m : m + span] = J[S[:span]]  # f^m of the first `span` entries
        J = J[J]
        m *= 2
    count = (S[:B] < valid_len).sum().to(torch.int32)
    return S[:B].to(torch.int32), count, S[B].to(torch.int32)


def gather_tokens(
    starts: torch.Tensor,
    valid_len,
    L: torch.Tensor,
    O: torch.Tensor,
    block_ext: torch.Tensor,
    *,
    la: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Materialize (off, len, next) at the parse's token starts.

    ``block_ext`` is the block plus its (la-1)-byte right extension so that
    ``next = block_ext[start + len]`` is always a real byte even when the
    final token's lookahead overhangs the block (lz77.c:221 + matcher cap).
    Outputs are (B,) int32 tensors: real tokens first, zeroed padding after.
    """
    B = starts.shape[0]
    E = block_ext.shape[0]
    starts = starts.to(torch.int64)
    idx = torch.clamp(starts, max=B - 1)
    valid = starts < _scalar(valid_len, starts)
    ln = torch.where(valid, L.to(torch.int64)[idx], 0)
    off = torch.where(valid & (ln > 0), O.to(torch.int64)[idx], 0)
    nxt = torch.where(
        valid, block_ext[torch.clamp(idx + ln, max=E - 1)].to(torch.int64), 0
    )
    return off.to(torch.int32), ln.to(torch.int32), nxt.to(torch.int32)
