"""Bit-plane (bit-sliced) exact match finder, as plain tensor code.

The port of the JAX package's ``ops.bitplane`` (an XLA formulation, no
Pallas kernel; K1, ``ops.match.match_sweep``, is what replaces its Pallas
form).  It keeps that formulation:

* The (halo, block, right) buffer is decomposed into 8 *bit-planes*, each
  packed 32 positions to an int32 word in a STRIDED layout: bit j of word w
  holds position ``w + j * nw`` (nw = word count).  Shifting a plane by one
  position is then a rotation of the word array by one word, the word that
  wraps moving one stripe.
* Distances are swept incrementally: the source planes (and a
  source-validity plane) advance one position a distance, and byte equality
  at distance d is ``~OR_b(P_b ^ SP_b) & V_d``, 32 positions a word op.
* Run masks by prefix-AND: ``M_k[t] = eq[t] & eq[t+1] & ... & eq[t+k]``.
* First-touch distance planes: where a position's ``found_k`` first flips,
  d's bits are ORed into per-k distance bit-planes.  Within a window of 32
  distances the low 5 bits of d are the row's index; the high bits are the
  window's and folded once a window.  The first touch is the smallest
  distance, the codec's tie-break.

Where eager PyTorch would launch a kernel for every operation of every
distance, a pass of windows (one on a 1 MiB block, more on small inputs)
goes as one tensor: the shifted source planes of its distances by one
gather; their run masks, the first 16 levels by the recurrence and the
deeper ones by doubling (``M_{n+j} = M_{n-1} & shift_n(M_j)``), stopping at
a level where every mask is empty (the deeper ones are empty too); and
their first touches by a prefix-OR across the pass's rows in distance
order.  First touches are disjoint bits, so the OR of a set of them is
their sum.  Words are int32 as in JAX; a right shift is arithmetic in
PyTorch, so a logical one masks the sign bit after it.

JAX's lane rounding of the word count (``nw += (-nw) % 128``) serves the
TPU and is gone, and so is its ``nw > depth`` limit ("block too small for
bitplane matcher"): single-position shifts are exact at any nw, and the
source shifts roll by ``k mod nw`` words and move ``k // nw`` stripes, so
every block is covered (a test pins it at la 255 on a small block, where
JAX raises).
"""

from __future__ import annotations

import torch

from .. import spec
from . import match as match_ops

_WORD = 32   # positions per int32 word (one per bit)
_WIN = 32    # distances per window (their low 5 bits are the row's index)
_SIGN = 1 << 31
# int32 words of one pass's run masks (distances x 32 levels x words) on
# the CPU and on a card; a pass takes at least one window, and holds more
# where more than 32 levels have a match
SWEEP_WORDS = {"cpu": 1 << 22, "cuda": 1 << 27}
# run-mask levels built one at a time; the deeper ones by doubling
_FIRST_LEVELS = 16


def _as_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 words with those bits."""
    return torch.where(x >= _SIGN, x - (1 << 32), x).to(torch.int32)


def _to_planes(buf: torch.Tensor, nw: int) -> torch.Tensor:
    """(G, 32*nw) uint8 -> (8, G, nw) int32 bit-planes, strided layout."""
    G = buf.shape[0]
    b = buf.reshape(G, _WORD, nw).to(torch.int64)  # [g, j, w] = pos j*nw + w
    sh = torch.arange(8, device=buf.device)[:, None, None, None]
    js = torch.arange(_WORD, device=buf.device)[None, None, :, None]
    return _as_int32((((b[None] >> sh) & 1) << js).sum(dim=2))


def _pack_mask(cond: torch.Tensor) -> torch.Tensor:
    """(G, 32, nw) bool -> (G, nw) int32 packed along the stripe axis."""
    js = torch.arange(_WORD, device=cond.device)[None, :, None]
    return _as_int32((cond.to(torch.int64) << js).sum(dim=1))


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int32 words by ``s >= 0`` bits."""
    if s == 0:
        return x
    if s >= _WORD:
        return torch.zeros_like(x)
    return (x >> s) & ((1 << (_WORD - s)) - 1)


def _shift_src_k(x: torch.Tensor, ks: torch.Tensor) -> torch.Tensor:
    """Source planes advanced by each of ``ks`` positions: (len(ks), ...).

    y holds the bit at (position - k): the words roll by ``r = k % nw``,
    the r wrapped words moving up one stripe (``<< 1``), then everything
    moves up ``q = k // nw`` stripes; bits past stripe 31 drop (their
    sources precede the buffer).  JAX takes each of a window's shifts as a
    static k < nw; here the window's (or pass's) shifts are one gather.
    """
    nw = x.shape[-1]
    w = torch.arange(nw, device=x.device)
    q, r = ks // nw, ks % nw
    src = (w[None, :] - r[:, None]) % nw                      # (K, nw)
    y = x[..., src]                                           # (..., K, nw)
    y = y.movedim(-2, 0)                                      # (K, ..., nw)
    view = (-1,) + (1,) * (y.dim() - 2) + (nw,)
    y = torch.where((w[None, :] < r[:, None]).reshape(view), y << 1, y)
    qv = q.reshape((-1,) + (1,) * (y.dim() - 1)).to(torch.int32)
    return torch.where(qv < _WORD, y << torch.clamp(qv, max=_WORD - 1), 0)


def _shift_pos_fwd(x: torch.Tensor, k: int) -> torch.Tensor:
    """y holds x's bit at (position + k), ``k >= 0`` a host int: the words
    roll back ``r = k % nw``, everything moves down ``q = k // nw``
    stripes and the r wrapped words one more (logical right shifts, so the
    sign bit does not smear); bits from past the buffer are 0."""
    nw = x.shape[-1]
    q, r = divmod(k, nw)
    if r == 0:
        return _shr(x, q)
    return torch.cat([_shr(x[..., r:], q), _shr(x[..., :r], q + 1)], dim=-1)


def _shift_src_by(x: torch.Tensor, k: int, nw: int) -> torch.Tensor:
    """Bulk-advance source planes by ``k >= 0`` positions (a host int)."""
    if k == 0:
        return x
    return _shift_src_k(x, torch.tensor([k], device=x.device))[0]


def _or_disjoint(rows: torch.Tensor) -> torch.Tensor:
    """OR over dim 0 of int32 rows whose set bits are disjoint: their sum
    (int64, exact), back in int32."""
    return rows.sum(dim=0).to(torch.int32)


def _setup(blocks, halos, rights, avails, valid_exts, dlim, depth):
    """(planes (8, G, nw), vplane (G, nw), pos (32, nw), nw)."""
    G, B = blocks.shape
    H = dlim
    dev = blocks.device
    n_real = H + B + depth
    nw = -(-n_real // _WORD)
    buf = torch.cat([halos, blocks, rights,
                     torch.zeros((G, _WORD * nw - n_real), dtype=torch.uint8,
                                 device=dev)], dim=1)
    planes = _to_planes(buf, nw)
    pos = (torch.arange(_WORD, device=dev)[:, None] * nw
           + torch.arange(nw, device=dev)[None, :])
    # position t is a usable match SOURCE iff it is a real input byte:
    # t in [H - avail, H + valid_ext)
    vplane = _pack_mask((pos[None] >= H - avails[:, None, None])
                        & (pos[None] < H + valid_exts[:, None, None]))
    return planes, vplane, pos, nw


def find_matches_bitplane(
    blocks: torch.Tensor,
    halos: torch.Tensor,
    rights: torch.Tensor,
    avails: torch.Tensor,
    valid_exts: torch.Tensor,
    *,
    la: int,
    sb: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The bit-plane sweep (JAX ``ops.bitplane.find_matches_bitplane``):
    the contract of ``ops.match.find_matches_brute``; (G, B) batches or one
    (B,) block.  The halo must be d_limit long, as in JAX."""
    return _bitplane(blocks, halos, rights, avails, valid_exts, la, sb, None)


def find_matches_bitplane_range(
    blocks: torch.Tensor,
    halos: torch.Tensor,
    rights: torch.Tensor,
    avails: torch.Tensor,
    valid_exts: torch.Tensor,
    d_lo,
    d_hi,
    *,
    la: int,
    sb: int,
    span: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The bit-plane sweep over the distances ``[d_lo, d_hi)`` (JAX
    ``find_matches_bitplane_range``), for the window axis, members
    combined by ``ops.match.combine_key``'s max.  As in JAX: ``span`` (the
    member's distance count) a multiple of 32, and ``d_lo`` 1 (mod 32), so
    that a window's low 5 distance bits stay its rows' indices."""
    return _bitplane(blocks, halos, rights, avails, valid_exts, la, sb,
                     (int(d_lo), int(d_hi), span))


@match_ops.one_block
def _bitplane(blocks, halos, rights, avails, valid_exts, la, sb, ranged):
    G, B = blocks.shape
    depth = spec.len_limit(la)
    dlim = spec.d_limit(sb)
    if dlim == 0 or depth == 0:
        return match_ops.zero_tables(blocks)
    H = halos.shape[1]
    if H != dlim:
        raise ValueError(
            f"bitplane matcher requires halo size == d_limit ({dlim}), got {H}"
        )
    match_ops.check_batch(blocks, halos, rights, avails, valid_exts, dlim,
                          depth)
    if ranged is None:
        d_base, d_hi, n_windows = 0, dlim + 1, -(-dlim // _WIN)
    else:
        d_lo, d_hi, span = ranged
        if span % _WIN:
            raise ValueError(f"span must be a multiple of {_WIN}, got {span}")
        if (d_lo - 1) % _WIN:
            raise ValueError(
                f"d_lo must be 1 (mod {_WIN}) for the static distance-plane "
                f"selection to hold, got {d_lo}"
            )
        d_base, d_hi, n_windows = d_lo - 1, min(d_hi, dlim + 1), span // _WIN
    if G * B == 0:
        return match_ops.zero_tables(blocks)
    planes, vplane, pos, nw = _setup(blocks, halos, rights, avails,
                                     valid_exts, dlim, depth)
    dbits = max(dlim.bit_length(), 6)  # distance bit-planes actually needed
    # windows wholly beyond every position's reach find nothing
    reach = match_ops.reach_of(avails, B)
    n_windows = max(0, min(n_windows, -(-(reach - d_base) // _WIN)))
    found, dp = _sweep(planes, vplane, d_base=d_base, d_hi=d_hi,
                       n_windows=n_windows, nw=nw, depth=depth, dlim=dlim,
                       dbits=dbits)
    return _extract(found, dp, dbits=dbits, depth=depth, H=dlim, B=B,
                    valid_exts=valid_exts, pos=pos)


def _run_masks(eq: torch.Tensor, depth: int) -> torch.Tensor:
    """Run masks by prefix-AND: level k holds ``eq[t] & ... & eq[t+k]``,
    (K, ...) for the K <= depth levels up to the first empty one (every
    deeper level is empty too).  The first levels by the recurrence
    ``M_k = eq & shift1(M_{k-1})``; then, with levels 0..n-1 known,
    ``M_{n+j} = M_{n-1} & shift_n(M_j)`` gives the next n at once."""
    levels = [eq]
    for _ in range(1, min(depth, _FIRST_LEVELS)):
        levels.append(eq & _shift_pos_fwd(levels[-1], 1))
    M = torch.stack(levels)
    while M.shape[0] < depth and bool(M[-1].any()):
        n = M.shape[0]
        M = torch.cat([M, M[-1][None] & _shift_pos_fwd(M[: depth - n], n)])
    return M


def _sweep(planes, vplane, *, d_base: int, d_hi: int, n_windows: int,
           nw: int, depth: int, dlim: int, dbits: int):
    """Incremental distance sweep -> (found (depth, G, nw), dp (dbits,
    depth, G, nw)).

    Window ``widx`` covers ``d_base + 32 widx + (1..32)``; ``d_base`` is a
    multiple of 32, so a distance's low 5 bits are its row's index (0 for
    the window's last row) and its high bits the window's.  A pass takes
    ``nwin`` windows (their rows in distance order): a prefix-OR over the
    rows gives each row's first touches, the rows' low bits go into the
    low distance planes and each window's high bits into the high ones.
    """
    G = planes.shape[1]
    dev = planes.device
    found = torch.zeros((depth, G, nw), dtype=torch.int32, device=dev)
    dp = torch.zeros((dbits, depth, G, nw), dtype=torch.int32, device=dev)
    # source planes pre-advanced to distance d_base
    sp0 = _shift_src_by(torch.cat([planes, vplane[None]]), min(d_base, dlim),
                        nw)
    words = SWEEP_WORDS["cuda" if planes.is_cuda else "cpu"]
    per = max(1, words // (_WIN * min(depth, 32) * G * nw))  # windows a pass
    # rows (of 0..30) whose distance has low bit b set: (row + 1) >> b & 1
    low_rows = [torch.tensor([i for i in range(_WIN - 1) if (i + 1) >> b & 1],
                             device=dev) for b in range(5)]
    for w0 in range(0, n_windows, per):
        nwin = min(per, n_windows - w0)
        D = nwin * _WIN
        ks = torch.arange(1, D + 1, device=dev)
        d = d_base + w0 * _WIN + ks
        sp = _shift_src_k(sp0, ks)                       # (D, 9, G, nw)
        neq = planes[None] ^ sp[:, :8]
        neq = neq[:, :4] | neq[:, 4:]
        neq = neq[:, :2] | neq[:, 2:]
        eq = ~(neq[:, 0] | neq[:, 1]) & sp[:, 8]        # (D, G, nw)
        eq = torch.where(((d <= dlim) & (d < d_hi))[:, None, None], eq, 0)
        del sp, neq
        M = _run_masks(eq, depth)                        # (K, D, G, nw)
        K = M.shape[0]
        C = M  # inclusive prefix OR over the pass's rows
        s = 1
        while s < D:
            C = torch.cat([C[:, :s], C[:, s:] | C[:, :-s]], dim=1)
            s *= 2
        before = torch.cat([torch.zeros_like(C[:, :1]), C[:, :-1]], dim=1)
        newly = M & ~(found[:K, None] | before)          # first touches
        found[:K] |= C[:, -1]
        del M, C, before
        newly = newly.reshape(K, nwin, _WIN, G, nw)
        # the rows' first touches are disjoint bits: an OR is their sum
        for b in range(5):  # d's low bits: the row's index + 1
            dp[b, :K] |= newly[:, :, low_rows[b]].sum(dim=(1, 2)).to(
                torch.int32)
        # each window's rows 0..30 share its high bits, its row 31 (d =
        # base + 32) has those of base + 32: 2 nwin rows, each window's
        # high bits a row; the sum of a set of rows is shared by the bits
        # that select the same set
        rows = torch.cat([newly[:, :, : _WIN - 1].sum(dim=2),
                          newly[:, :, _WIN - 1]], dim=1)  # (K, 2 nwin, ...)
        highs = [d_base + (w0 + i) * _WIN for i in range(nwin)]
        highs += [v + _WIN for v in highs]
        sums = {}
        for b in range(5, dbits):
            of = tuple(i for i, v in enumerate(highs) if v >> b & 1)
            if of:
                if of not in sums:
                    sums[of] = rows[:, list(of)].sum(dim=1).to(torch.int32)
                dp[b, :K] |= sums[of]
        del newly, rows, sums
        sp0 = _shift_src_by(sp0, D, nw)
    return found, dp


def _extract(found, dp, *, dbits: int, depth: int, H: int, B: int,
             valid_exts: torch.Tensor, pos: torch.Tensor):
    """Found masks + distance bit-planes -> per-position (L, O), (G, B).

    L = the count of set found_k (monotone in k), capped by the lookahead
    shrinkage; O = the distance recorded at k = L.
    """
    _, G, nw = found.shape
    js = torch.arange(_WORD, device=found.device)[:, None, None]
    l_raw = torch.zeros((_WORD, G, nw), dtype=torch.int32,
                        device=found.device)
    for k in range(depth):
        l_raw += (found[k][None] >> js) & 1
    cap = torch.clamp(valid_exts[None, :, None] - (pos[:, None, :] - H) - 1,
                      max=depth)
    l_full = torch.minimum(l_raw, torch.clamp(cap, min=0))   # (32, G, nw)
    ksel = torch.clamp(l_full - 1, min=0).to(torch.int64)
    picked = torch.gather(dp, 1, ksel[None].expand(dbits, -1, -1, -1))
    bits = (picked >> js[None]) & 1                          # (dbits, 32, ...)
    weights = (1 << torch.arange(dbits, device=found.device))[:, None, None,
                                                              None]
    o_full = torch.where(l_full > 0, (bits * weights).sum(dim=0), 0)

    def positions(t):  # (32, G, nw) strided -> (G, B) block positions
        return t.movedim(1, 0).reshape(G, -1)[:, H : H + B].to(torch.int32)

    return positions(l_full), positions(o_full)
