"""Exact longest-match finder: contract, plain PyTorch version, CUDA kernel.

Replaces the reference's binary-search-tree match finder (tree.c:118-152)
with the **true** longest match for every position of a block at once, which
dominates the BST's path-limited answer and so guarantees a compressed size
<= the reference's (SURVEY.md §2.4).

Coordinates (the contract of the JAX package's ``ops.match``, kept so the
two packages are compared like with like): a block of B bytes comes with an
H-byte *halo* of preceding input bytes (H = d_limit, tail-aligned) and an
(la-1)-byte *right extension* of following bytes, so distances and lookahead
see exactly the bytes one serial pass over the whole input would.  ``avail``
is the number of valid halo bytes (< H only near the start of the stream);
``valid_ext`` is the number of valid bytes counting from block[0], possibly
exceeding B.  Per-position results are therefore block-size-invariant.

Kernel note — ``csrc/match.cu::match_kernel`` replaces the TPU kernel
``lz77_tpu/ops/pallas_bitplane.py::_kernel`` (the bit-sliced distance sweep).
The TPU form exists because that machine compares 32 positions per word op
and has no cheap byte addressing.  On Hopper the kernel is the sweep itself:
one thread per position, distances ascending, strict ``>`` (smallest
distance wins ties), early exit once the position's cap is reached, so a
thread on a run of zeros stops at distance 1.  It is bound by operations,
not bytes: it reads ~1 B and writes 8 B per input byte, but does up to
``d_limit`` compares per position, so what counts is the instructions and
shared-memory loads a distance costs.  The tile and its whole window sit in
shared memory (dynamic, up to ~66 KB at sb=65535), and the sweep
(``csrc/match_common.cuh::sweep_position``, which K5 runs too) takes four
distances a step: the sources of four consecutive distances are one aligned
window word, which XORed with the position's first byte repeated four
times, ORed with the same test at index ``best`` (the word ``best`` bytes
further on, which slides down one aligned word a step and so costs one load
and one funnel shift), gives through one zero-byte test the distances that
can still beat the best run.  Only those measure their run, four bytes at a
time, nearest first.  That is about ten instructions and two 32-bit loads
for four distances, where a distance at a time took some thirty-four and
eight byte loads.  :func:`match_sweep_words_plain` is the same
decomposition in tensors.  It covers la 2..255 and sb 1..65535 itself;
there is no second formulation to give way to.

The sweep also takes a range of distances ``[d_lo, d_hi)``: the window
axis of a sharded encode (``parallel.sharded``) gives each mesh member one
range, and the members' tables meet through :func:`combine_key`'s max.  A
ranged sweep starts at the word step that holds ``d_lo`` (masked below it
as step 0 is masked below 1) and stages only the ``d_hi - 1`` window bytes
it can reach; the full range runs the unranged code that K5 shares.

Beside K1 this module holds three of the JAX package's XLA matchers,
``find_matches_brute`` (and its ranged form), ``find_matches_sorted`` and
``find_matches_chunked``, as plain tensor code; the fourth,
``bitplane``, is ``ops.bitplane``.  :func:`get_matcher` gives any of them
by name.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from .. import _build, spec
from .. import device as device_lib


def capped_runs(X: torch.Tensor, Y: torch.Tensor, depth: int,
                cap: torch.Tensor) -> torch.Tensor:
    """Run length of X against Y at each of the first ``cap.shape[-1]``
    columns, at most ``cap``; X and Y are (..., B + ext) uint8 with ext >=
    depth (broadcast against each other).  By doubling: log2(depth)
    shifted adds, whatever the depth."""
    rl = (X == Y).to(torch.int16)
    m = 1
    while m < depth:
        rl = rl + torch.where(rl == m, F.pad(rl[..., m:], (0, m)), 0)
        m <<= 1
    return torch.minimum(rl[..., : cap.shape[-1]].to(torch.int32), cap)


# Elements of one pass of :func:`match_sweep_plain` (distances x bytes):
# small batches take many distances a pass, the main path's one.
PLAIN_PASS_ELEMENTS = 1 << 20


def match_sweep_plain(
    blocks: torch.Tensor,
    halos: torch.Tensor,
    rights: torch.Tensor,
    avails: torch.Tensor,
    valid_exts: torch.Tensor,
    *,
    la: int,
    sb: int,
    d_lo: int = 1,
    d_hi: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the sweep: same inputs, same (L, O).

    Passes over the whole (G, B) batch, each taking as many distances of
    ``[d_lo, d_hi)`` (see :func:`distance_range`) as keep it near
    ``PLAIN_PASS_ELEMENTS`` (one for the main path's 8 MiB batch); run
    lengths by doubling (log2(la) shifted adds), so a deep ``la`` costs no
    more passes.  Within a pass the longest run wins, then the smallest
    distance; across passes only a longer run replaces the best.
    Distances no position can reach (``d > max(pos + avail)``) are skipped.
    """
    G, B = blocks.shape
    H = halos.shape[1]
    depth = spec.len_limit(la)
    dlim = spec.d_limit(sb)
    d_lo, d_hi = distance_range(dlim, d_lo, d_hi)
    dev = blocks.device
    ext = 1
    while ext < depth:
        ext <<= 1
    pos = torch.arange(B, dtype=torch.int32, device=dev)[None, :]
    cap = torch.clamp(valid_exts[:, None] - pos - 1, max=depth)
    reach = pos + avails[:, None]
    buf = torch.cat(
        [halos, blocks, rights,
         torch.zeros((G, ext), dtype=torch.uint8, device=dev)], dim=1,
    )
    # win[:, j] = buf[:, j : j + B + ext]: the source window of distance
    # H - j, a view
    win = buf.unfold(1, B + ext, 1)
    X = win[:, H, None]
    best_l = torch.zeros((G, B), dtype=torch.int32, device=dev)
    best_o = torch.zeros((G, B), dtype=torch.int32, device=dev)
    dmax = min(d_hi - 1, int(reach.max())) if G * B else 0
    per = max(1, PLAIN_PASS_ELEMENTS // max(1, G * (B + ext)))
    for d0 in range(d_lo, dmax + 1, per):
        d1 = min(d0 + per, dmax + 1)
        # distances d1 - 1 down to d0
        ds = torch.arange(d1 - 1, d0 - 1, -1, dtype=torch.int32,
                          device=dev)[:, None]
        runs = capped_runs(X, win[:, H - d1 + 1 : H - d0 + 1], depth,
                           cap[:, None])
        runs = torch.where(reach[:, None] >= ds, runs, -1)
        longest = runs.amax(dim=1)
        nearest = torch.where(runs == longest[:, None], ds,
                              dlim + 1).amin(dim=1)
        upd = longest > best_l
        best_l = torch.where(upd, longest, best_l)
        best_o = torch.where(upd, nearest, best_o)
    return best_l, best_o


# Word steps the kernel filters with one best and tests with one branch
# (``GROUP`` in ``csrc/match_common.cuh``).
SWEEP_GROUP = 8


def match_sweep_words_plain(
    blocks: torch.Tensor,
    halos: torch.Tensor,
    rights: torch.Tensor,
    avails: torch.Tensor,
    valid_exts: torch.Tensor,
    *,
    la: int,
    sb: int,
    d_lo: int = 1,
    d_hi: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version under the kernel's decomposition; same (L, O).

    The tile stages ``win = min(d_limit, d_hi - 1)`` window bytes (all
    ``d_limit`` of them for the full range), so position p sits at byte
    index ``win + p`` of the staged window (modulo the tile, a multiple of
    4), its alignment phase is ``a = (win + p) % 4`` and its word step
    ``t`` holds the distances ``a + 4t - j``, ``j`` = 3..0.  Steps run from
    ``tf = (d_lo + 2 - a) // 4`` (0 for ``d_lo = 1``) to
    ``tmax = (dmax + 3 - a) // 4``; step ``tf`` keeps only its bytes
    ``j < a + 4 tf - d_lo + 1`` (distances from ``d_lo`` up), step ``tmax``
    its bytes ``j >= a + 4 tmax - dmax`` (up to dmax), with the kernel's
    formulas.  Steps from ``tf + 1`` go in groups of :data:`SWEEP_GROUP`
    while a whole group lies before ``tmax``, then one at a time.  Every
    distance of a group (or lone step) is filtered with the best run
    current when the group began (first byte, and the byte at index
    ``best``); the marked ones measure their capped run (by doubling)
    nearest first and update the best as they go; a position whose best run
    has reached its cap takes no further distance.  One tensor pass per
    distance, from ``d_lo - 3`` (step ``tf``'s lowest byte at most) to the
    last step's highest, so a mask that let a distance outside
    ``d_lo..dmax`` through would show in the tables.
    """
    G, B = blocks.shape
    H = halos.shape[1]
    depth = spec.len_limit(la)
    dlim = spec.d_limit(sb)
    d_lo, d_hi = distance_range(dlim, d_lo, d_hi)
    win = min(dlim, d_hi - 1)
    dev = blocks.device
    ext = 1
    while ext < depth:
        ext <<= 1
    pos = torch.arange(B, dtype=torch.int32, device=dev)[None, :]
    cap = torch.clamp(valid_exts[:, None] - pos - 1, max=depth)
    dmax = torch.clamp(pos + avails[:, None], max=win)
    a = (win + pos) % 4
    tf = torch.div(d_lo + 2 - a, 4, rounding_mode="floor")
    k = a + 4 * tf - d_lo + 1  # step tf's bytes j < k are at d_lo or above
    tmax = torch.div(dmax + 3 - a, 4, rounding_mode="floor")
    lo = a + 4 * tmax - dmax
    grouped_to = tf + SWEEP_GROUP * torch.div(
        torch.clamp(tmax - tf - 1, min=0), SWEEP_GROUP, rounding_mode="floor")
    pad = 3  # step 0 reaches 3 bytes past the position, the last 3 before
    buf = torch.cat(
        [torch.zeros((G, pad), dtype=torch.uint8, device=dev), halos, blocks,
         rights, torch.zeros((G, ext + pad), dtype=torch.uint8, device=dev)],
        dim=1,
    )
    X = buf[:, pad + H : pad + H + B + ext]
    pos64 = pos.to(torch.int64).expand(G, B)
    best_l = torch.zeros((G, B), dtype=torch.int32, device=dev)
    best_o = torch.zeros((G, B), dtype=torch.int32, device=dev)
    step_best = torch.zeros((G, B), dtype=torch.int64, device=dev)
    # no step for a position with nothing in range (the kernel returns
    # (0, 0) at once); its tmax < tf then
    live = dmax >= d_lo
    d_top = int((a + 4 * tmax).max()) if G * B else d_lo - 4
    for d in range(d_lo - 3, d_top + 1):
        t4 = d - a + 3  # 4t + 3 - j
        t = torch.div(t4, 4, rounding_mode="floor")
        j = a + 4 * t - d
        in_step = live & (t >= tf) & (t <= tmax)
        valid = (in_step & ((t > tf) | (j < k)) & ((t < tmax) | (j >= lo))
                 & (best_l < cap))
        # the filter's best is renewed at a group's (or lone step's) start
        grouped = (t >= tf + 1) & (t <= grouped_to)
        starts = (j == 3) & (~grouped | ((t - tf - 1) % SWEEP_GROUP == 0))
        step_best = torch.where(in_step & starts, best_l.to(torch.int64),
                                step_best)
        Y = buf[:, pad + H - d : pad + H - d + B + ext]
        passed = (
            valid & (X[:, :B] == Y[:, :B])
            & (X.gather(1, pos64 + step_best) == Y.gather(1, pos64 + step_best))
        )
        runs = capped_runs(X, Y, depth, cap)
        upd = passed & (runs > best_l)
        best_l = torch.where(upd, runs, best_l)
        best_o = torch.where(upd, d, best_o)
    return best_l, best_o


def distance_range(dlim: int, d_lo: int = 1,
                   d_hi: int | None = None) -> tuple[int, int]:
    """The searched distances ``[d_lo, d_hi)`` clipped as the JAX package's
    ``find_matches_brute_range`` clips them: ``d_lo`` into ``[1, dlim + 1]``,
    ``d_hi`` (``None``: ``dlim + 1``) into ``[d_lo, dlim + 1]``; empty when
    ``d_lo == d_hi``."""
    lo = min(max(int(d_lo), 1), dlim + 1)
    hi = dlim + 1 if d_hi is None else min(max(int(d_hi), lo), dlim + 1)
    return lo, hi


def combine_key(L: torch.Tensor, O: torch.Tensor, dlim: int) -> torch.Tensor:
    """Order-preserving int32 key of (L, O): the longer run wins, then the
    smaller distance (``L * (dlim + 2) + dlim + 1 - O`` < 2^24), so the
    elementwise max of partial tables over distance ranges is the table
    over their union."""
    return L.to(torch.int32) * (dlim + 2) + (dlim + 1 - O.to(torch.int32))


def split_key(key: torch.Tensor, dlim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(L, O) int32 from :func:`combine_key`'s key; O is 0 where L is 0."""
    L = torch.div(key, dlim + 2, rounding_mode="floor")
    O = (dlim + 1) - torch.remainder(key, dlim + 2)
    return L, torch.where(L > 0, O, 0)


def check_batch(blocks, halos, rights, avails, valid_exts, dlim: int,
                depth: int) -> None:
    """Raise ``ValueError`` unless the batch has the matcher contract's
    shapes and types (shared by both kernel wrappers)."""
    G = blocks.shape[0]
    if halos.shape != (G, dlim) or rights.shape != (G, depth):
        raise ValueError(
            f"matcher needs halos (G, {dlim}) and rights (G, {depth}), got "
            f"{tuple(halos.shape)} and {tuple(rights.shape)}"
        )
    if avails.shape != (G,) or valid_exts.shape != (G,):
        raise ValueError("avails and valid_exts must be (G,)")
    for t, dt in ((blocks, torch.uint8), (halos, torch.uint8),
                  (rights, torch.uint8), (avails, torch.int32),
                  (valid_exts, torch.int32)):
        if t.dtype != dt or t.device != blocks.device or not t.is_contiguous():
            raise ValueError(
                "matcher inputs must be contiguous uint8 bytes / int32 "
                "scalars on one device"
            )
    if blocks.is_cuda and G > 65535:
        raise ValueError("a match kernel takes at most 65535 blocks per batch")


def match_sweep(
    blocks: torch.Tensor,      # (G, B) uint8
    halos: torch.Tensor,       # (G, d_limit) uint8
    rights: torch.Tensor,      # (G, la-1) uint8
    avails: torch.Tensor,      # (G,) int32
    valid_exts: torch.Tensor,  # (G,) int32
    *,
    la: int,
    sb: int,
    d_lo: int = 1,
    d_hi: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 wrapper: (L, O) int32 (G, B) tables for a batch of blocks.

    Only the distances ``[d_lo, d_hi)`` are searched (default: all of
    ``1..d_limit``; clipped by :func:`distance_range`): the longest run in
    the range, its nearest distance, (0, 0) where nothing in it matches.
    CUDA tensors launch ``match_kernel`` (or raise); CPU tensors run
    :func:`match_sweep_plain`.  ``match_sweep.launches`` counts launches.
    """
    depth = spec.len_limit(la)
    dlim = spec.d_limit(sb)
    G, B = blocks.shape
    check_batch(blocks, halos, rights, avails, valid_exts, dlim, depth)
    d_lo, d_hi = distance_range(dlim, d_lo, d_hi)
    if dlim == 0 or depth == 0 or G * B == 0 or d_lo == d_hi:
        z = torch.zeros((G, B), dtype=torch.int32, device=blocks.device)
        return z, z.clone()
    if not blocks.is_cuda:
        return match_sweep_plain(
            blocks, halos, rights, avails, valid_exts, la=la, sb=sb,
            d_lo=d_lo, d_hi=d_hi,
        )
    lib = _build.kernels()
    L = torch.empty((G, B), dtype=torch.int32, device=blocks.device)
    O = torch.empty((G, B), dtype=torch.int32, device=blocks.device)
    with torch.cuda.device(blocks.device):
        err = lib.lz77_match(
            blocks.data_ptr(), halos.data_ptr(), rights.data_ptr(),
            avails.data_ptr(), valid_exts.data_ptr(),
            L.data_ptr(), O.data_ptr(), G, B, dlim, depth, d_lo, d_hi,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "match_kernel")
    match_sweep.launches += 1
    return L, O


match_sweep.launches = 0

# -------------------------------------------------- the XLA matchers -----
#
# The JAX package's four matchers that are no Pallas kernel (``brute``,
# ``sorted``, ``chunked`` here and ``bitplane`` in ``ops.bitplane``), each
# written from its JAX counterpart as plain tensor code that runs where its
# inputs lie.  XLA fuses a loop body into a few device loops where eager
# PyTorch launches a kernel an operation, so each takes a group of
# distances (or one k) a pass: the Python loops run at most d_limit / 32
# times or la - 1 times, never once a distance.  None calls K1, K4 or
# their plain versions.  Each takes (G, B) batches or one (B,) block.


def one_block(fn):
    """Let a batch matcher take one block: a (B,) block, (H,) halo, (R,)
    right and scalar avail / valid_ext give (B,) tables."""
    @functools.wraps(fn)
    def run(blocks, halos, rights, avails, valid_exts, *args, **kw):
        if blocks.dim() == 2:
            return fn(blocks, halos, rights, avails, valid_exts, *args, **kw)
        L, O = fn(blocks[None], halos[None], rights[None], avails.reshape(1),
                  valid_exts.reshape(1), *args, **kw)
        return L[0], O[0]

    return run


def zero_tables(blocks):
    """(L, O) of zeros shaped like ``blocks``: nothing matches."""
    z = torch.zeros(blocks.shape, dtype=torch.int32, device=blocks.device)
    return z, z.clone()


def reach_of(avails: torch.Tensor, B: int) -> int:
    """The largest distance any position of the batch can reach, ``B - 1 +
    max(avail)`` (one host read): the matchers skip the distances beyond
    it, where no position matches."""
    return B - 1 + int(avails.max()) if avails.numel() else 0


# Elements (distances x bytes) of one pass of the brute sweep.
BRUTE_PASS_ELEMENTS = 1 << 24


def _brute(blocks, halos, rights, avails, valid_exts, la, sb, d_lo, d_hi):
    G, B = blocks.shape
    depth = spec.len_limit(la)
    dlim = spec.d_limit(sb)
    check_batch(blocks, halos, rights, avails, valid_exts, dlim, depth)
    if dlim == 0 or depth == 0 or G * B == 0:
        return zero_tables(blocks)
    d_lo, d_hi = distance_range(dlim, d_lo, d_hi)
    H = dlim
    dev = blocks.device
    pos = torch.arange(B, dtype=torch.int32, device=dev)[None, :]
    cap = torch.clamp(valid_exts[:, None] - pos - 1, max=depth)
    reach = pos + avails[:, None]
    buf = torch.cat([halos, blocks, rights], dim=1)  # (G, H + B + depth)
    # Row i of the shift stack at position p is byte p + i, so the stack's
    # equality rows at distance d are one equality row E_d[t] = (buf[H + t]
    # == buf[H + t - d]), t < B + depth - 1, read at offsets 0..depth-1.
    n = B + depth - 1
    X = buf[:, H : H + n]
    win = buf.unfold(1, n, 1)  # win[:, j] = buf[:, j : j + n], distance H - j
    best_l = torch.zeros((G, B), dtype=torch.int32, device=dev)
    best_o = torch.zeros((G, B), dtype=torch.int32, device=dev)
    dmax = min(d_hi - 1, reach_of(avails, B))
    per = max(1, BRUTE_PASS_ELEMENTS // (G * B))
    for d0 in range(d_lo, dmax + 1, per):
        ds = torch.arange(d0, min(d0 + per, dmax + 1), dtype=torch.int32,
                          device=dev)
        E = win[:, H - ds] == X[:, None]  # (G, g, n)
        # the run: the cumulative AND down the stack's equality rows, a row
        # at a time, summed; once no run is alive the deeper rows add 0
        alive = E[..., :B].clone()
        runs = alive.to(torch.uint8)
        for i in range(1, depth):
            alive &= E[..., i : i + B]
            runs += alive
            if i % 16 == 0 and not bool(alive.any()):
                break
        runs = torch.minimum(runs.to(torch.int32), cap[:, None])
        runs = torch.where(reach[:, None] >= ds[:, None], runs, -1)
        # the distances in turn, a longer run replacing the best: the
        # group's longest run at its nearest distance, if it is longer
        longest = runs.amax(dim=1)
        nearest = torch.where(runs == longest[:, None], ds[:, None],
                              dlim + 1).amin(dim=1)
        upd = longest > best_l
        best_l = torch.where(upd, longest, best_l)
        best_o = torch.where(upd, nearest, best_o)
    return best_l, best_o


@one_block
def find_matches_brute(
    blocks: torch.Tensor,
    halos: torch.Tensor,
    rights: torch.Tensor,
    avails: torch.Tensor,
    valid_exts: torch.Tensor,
    *,
    la: int,
    sb: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The distance sweep (JAX ``ops.match.find_matches_brute``).

    For every distance d = 1..d_limit in turn, the run at every position is
    the cumulative AND of a depth-deep stack of byte-equality rows (the
    product down the stack, summed), capped at ``min(la, valid_ext - p) -
    1``, gated by ``d <= p + avail``; a strictly longer run replaces the
    best, so the smallest distance keeps a tie.  Distances go
    ``BRUTE_PASS_ELEMENTS / (G B)`` a pass, the stack's rows ANDed in one
    at a time (a pass whose runs have all ended skips the deeper rows);
    within a pass the longest run and then its nearest distance win,
    which is what the one-by-one strict update leaves.
    """
    return _brute(blocks, halos, rights, avails, valid_exts, la, sb, 1, None)


@one_block
def find_matches_brute_range(
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
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`find_matches_brute` over the distances ``[d_lo, d_hi)``,
    clamped as the JAX function clamps them (:func:`distance_range`): the
    window axis's building block, members combined by
    :func:`combine_key`'s max."""
    return _brute(blocks, halos, rights, avails, valid_exts, la, sb,
                  int(d_lo), int(d_hi))


@one_block
def find_matches_sorted(
    blocks: torch.Tensor,
    halos: torch.Tensor,
    rights: torch.Tensor,
    avails: torch.Tensor,
    valid_exts: torch.Tensor,
    *,
    la: int,
    sb: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest previous equal k-gram for each k (JAX
    ``ops.match.find_matches_sorted``); its cost does not grow with
    d_limit.

    For k = 1..depth the positions are sorted stably by their k-gram, so
    equal grams sit in position order and a position's in-order
    predecessor with the same gram is its nearest earlier occurrence.  A k
    is valid where that distance is at most ``min(d_limit, p + avail)`` and
    k at most the cap; an equal k-gram has an equal (k-1)-gram, so the
    valid k are 1..L, and O is the distance at k = L.

    JAX sorts ceil(k/4) packed int32 words with a multi-key ``lax.sort``;
    ``torch.sort`` takes one key.  So the k-grams are ranked incrementally:
    a k-gram's key is (the dense rank of its (k-1)-gram, its byte k-1) as
    one int64, ``rank * 256 + byte``, with the block in the 1-grams' rank,
    so each k is one single-key sort of G (H + B + la - 1) keys and no
    sort grows with k or d_limit.  Once no position has a valid k, no
    larger k is valid either, and the loop ends.
    """
    G, B = blocks.shape
    depth = spec.len_limit(la)
    dlim = spec.d_limit(sb)
    check_batch(blocks, halos, rights, avails, valid_exts, dlim, depth)
    if dlim == 0 or depth == 0 or G * B == 0:
        return zero_tables(blocks)
    H = dlim
    dev = blocks.device
    pos = torch.arange(B, dtype=torch.int32, device=dev)[None, :]
    cap = torch.clamp(valid_exts[:, None] - pos - 1, max=depth)
    limit = torch.clamp(pos + avails[:, None], max=dlim).to(torch.int64)
    buf = torch.cat([halos, blocks, rights], dim=1)
    N = buf.shape[1]
    # the k-gram at t ends at t + k - 1, zero-padded past the buffer
    nxt = torch.cat([buf, torch.zeros((G, depth), dtype=torch.uint8,
                                      device=dev)], dim=1).to(torch.int64)
    rank = nxt[:, :N] + 256 * torch.arange(G, device=dev)[:, None]
    far = torch.full((G * N,), 1 << 30, dtype=torch.int64, device=dev)
    L = torch.zeros((G, B), dtype=torch.int32, device=dev)
    O = torch.zeros((G, B), dtype=torch.int32, device=dev)
    for k in range(1, depth + 1):
        key = rank if k == 1 else rank * 256 + nxt[:, k - 1 : k - 1 + N]
        skey, perm = torch.sort(key.reshape(-1), stable=True)
        same = skey[1:] == skey[:-1]
        dist = far.clone()
        dist[perm[1:]] = torch.where(same, perm[1:] - perm[:-1], 1 << 30)
        Dk = dist.reshape(G, N)[:, H : H + B]
        valid = (Dk <= limit) & (cap >= k)
        if not bool(valid.any()):
            break
        L += valid.to(torch.int32)
        O = torch.where(valid, Dk.to(torch.int32), O)
        if k < depth:
            dense = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                               torch.cumsum(~same, 0)])
            rank = torch.empty_like(dense).scatter_(0, perm, dense).reshape(
                G, N)
    return L, O


CHUNKED_STEP = 128  # distances a step of the chunked sweep


@one_block
def find_matches_chunked(
    blocks: torch.Tensor,
    halos: torch.Tensor,
    rights: torch.Tensor,
    avails: torch.Tensor,
    valid_exts: torch.Tensor,
    *,
    la: int,
    sb: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The distance-chunked sweep (JAX ``ops.match.find_matches_chunked``).

    ``CHUNKED_STEP`` consecutive distances a step as one (G, 128, B + ext)
    tensor of shifted candidate rows (one gather of the padded buffer's
    windows), run lengths by doubling along the positions
    (:func:`capped_runs`, log2(la) shifted adds), and the best kept as the
    max of the order-preserving key ``L * (d_limit + 2) + d_limit + 1 - d``
    over the rows.  The halo must be d_limit long, as in JAX.  Steps
    beyond every position's reach are skipped.
    """
    G, B = blocks.shape
    depth = spec.len_limit(la)
    dlim = spec.d_limit(sb)
    if dlim == 0 or depth == 0:
        return zero_tables(blocks)
    H = halos.shape[1]
    if H != dlim:
        raise ValueError(
            f"chunked matcher requires halo size == d_limit ({dlim}), got {H}"
        )
    check_batch(blocks, halos, rights, avails, valid_exts, dlim, depth)
    if G * B == 0:
        return zero_tables(blocks)
    dev = blocks.device
    chunk = CHUNKED_STEP
    ext = 1
    while ext < depth:
        ext <<= 1
    pos = torch.arange(B, dtype=torch.int32, device=dev)[None, :]
    cap = torch.clamp(valid_exts[:, None] - pos - 1, max=depth)
    reach = pos + avails[:, None]
    # left pad so no step's rows start before the buffer; right pad for the
    # doubling's look ahead (real right bytes first, then zeros)
    buf = torch.cat([torch.zeros((G, chunk), dtype=torch.uint8, device=dev),
                     halos, blocks, rights,
                     torch.zeros((G, ext), dtype=torch.uint8, device=dev)],
                    dim=1)
    x_ext = buf[:, chunk + H : chunk + H + B + ext]
    win = buf.unfold(1, B + ext, 1)  # win[:, s] = buf[:, s : s + B + ext]
    kmul = dlim + 2
    best = torch.zeros((G, B), dtype=torch.int32, device=dev)
    rows = torch.arange(1, chunk + 1, dtype=torch.int32, device=dev)
    n_chunks = min(-(-dlim // chunk), -(-reach_of(avails, B) // chunk))
    for dc in range(n_chunks):
        d = dc * chunk + rows                # row r: distance dc*chunk + r + 1
        S = win[:, chunk + H - d]            # (G, chunk, B + ext)
        runs = capped_runs(S, x_ext[:, None], depth, cap[:, None])
        ok = (d[:, None] <= dlim) & (d[:, None] <= reach[:, None]) & (runs > 0)
        key = torch.where(ok, runs * kmul + (dlim + 1 - d[:, None]), 0)
        best = torch.maximum(best, key.amax(dim=1))
    L = torch.div(best, kmul, rounding_mode="floor")
    O = torch.where(L > 0, (dlim + 1) - torch.remainder(best, kmul), 0)
    return L, O


# ------------------------------------------------------ matchers by name --
#
# ``sweep`` is K1 above and ``chunk`` K4 (``ops.match_chunk``); ``brute``,
# ``sorted``, ``chunked`` and ``bitplane`` (``ops.bitplane``) are the JAX
# package's XLA matchers as plain tensor code.  The JAX names of the two
# TPU kernels that K1 and K4 replace are aliases, so a command line
# written for its CLI runs unchanged.
DEFAULT_MATCHER = "sweep"
MATCHER_ALIASES = {"pallas_bitplane": "sweep", "pallas": "chunk"}
MATCHER_NAMES = ("sweep", "chunk", "brute", "sorted", "chunked", "bitplane")
# the matchers this module defines; ``chunk`` and ``bitplane`` import theirs
MATCHERS = {
    "sweep": match_sweep,
    "brute": find_matches_brute,
    "sorted": find_matches_sorted,
    "chunked": find_matches_chunked,
}


def route_matcher(name: str) -> str:
    """Canonical matcher name for ``name`` (an alias resolved); every
    matcher covers every ``la`` and ``sb``, so nothing else routes."""
    name = MATCHER_ALIASES.get(name, name)
    if name not in MATCHER_NAMES:
        raise ValueError(
            f"unknown matcher {name!r}; available: "
            f"{sorted(MATCHER_NAMES + tuple(MATCHER_ALIASES))}"
        )
    return name


def get_matcher(name: str):
    """The batch matcher ``fn(blocks, halos, rights, avails, valid_exts, *,
    la, sb) -> (L, O)`` behind a matcher name."""
    name = route_matcher(name)
    if name == "chunk":
        from . import match_chunk  # deferred: match_chunk imports this module

        return match_chunk.match_chunk
    if name == "bitplane":
        from . import bitplane  # deferred: bitplane imports this module

        return bitplane.find_matches_bitplane
    return MATCHERS[name]


def find_matches(
    block,
    halo,
    right,
    avail,
    valid_ext,
    *,
    la: int,
    sb: int,
    device: str | torch.device | None = None,
    matcher: str = DEFAULT_MATCHER,
) -> tuple[torch.Tensor, torch.Tensor]:
    """True longest match per position.

    Args:
      block: (B,) or (G, B) uint8 — block bytes (zeros past validity).
      halo: (H,) or (G, H) uint8, H = d_limit — the input bytes preceding
        the block, tail-aligned (halo[-1] is the byte before block[0]).
      right: (la-1,) or (G, la-1) uint8 — input bytes following the block.
      avail: scalar or (G,) int32 — number of valid bytes at halo's tail.
      valid_ext: scalar or (G,) int32 — valid input bytes counting from
        block[0] (includes the right extension; may exceed B).
      la, sb: codec parameters.
      device: where to run; ``None`` is the GPU (see ``device.resolve``).
      matcher: which matcher, by name (see :func:`get_matcher`).

    Returns:
      (L, O): int32, shaped like ``block``.  L[p] in [0, la-1], capped at
      ``min(la, valid_ext - p) - 1`` (a negative cap gives 0) so the token's
      ``next`` byte is always real (lookahead shrinkage, lz77.c:87,134);
      distances 1..d_limit gated by ``d <= p + avail``; O[p] is the
      *smallest* distance achieving L[p], 0 when L[p] == 0.
    """
    dev = device_lib.resolve(device)
    blk = torch.as_tensor(block).to(dev)
    single = blk.dim() == 1

    def prep(a, dtype):
        t = torch.as_tensor(a).to(device=dev, dtype=dtype)
        return (t[None] if single else t).contiguous()

    L, O = get_matcher(matcher)(
        prep(blk, torch.uint8), prep(halo, torch.uint8),
        prep(right, torch.uint8), prep(avail, torch.int32),
        prep(valid_ext, torch.int32), la=la, sb=sb,
    )
    return (L[0], O[0]) if single else (L, O)
