"""Merged sweep + walk: match, greedy parse and token pack in one kernel.

The fused encode's walk route runs two kernels per batch: the match sweep
writes (L, O) tables to device memory (8 B per input byte), ``build_lox``
reads them and writes one word per byte, and the walk reads those words
again.  The merged route does all three in one kernel, so the match tables
never leave the chip: raw bytes and a parse entry go in, the exact serial
token words, their count and the exit entry come out.

Contract (the JAX package's ``ops.fused_walk``, without its geometry
gate): a batch of G consecutive blocks in the matcher's coordinates
(``ops.match``), the span's valid bytes ``valid_total`` and the entry the
previous batch left.  The walk starts at ``entry`` in [0, la), emits a
token at every chain position ``p < valid_total`` and leaves
``exit = p - valid_total``.  A token's ``next`` byte is the byte at
``p + len`` of the flat span and, past the span, of the last block's right
extension — what ``parse_walk.build_lox`` hands the walk kernel — so the
result equals match sweep + walk on any input, also one whose right
extensions are not the next block's head.

Kernel note — ``csrc/fused_walk.cu::sweepwalk_kernel`` replaces the TPU
kernel ``lz77_tpu/ops/fused_walk.py::_kernel``.  That kernel is a one-block
software pipeline (sweep block g while walking block g-1) because a
TensorCore runs one program at a time and the walk can ride in the sweep's
spare scalar slots; its bit planes, plane-strided addressing, slot counts
and geometry limits serve that machine.  On Hopper thread blocks run in
parallel, so the kernel is the match sweep with the parallel walk
(``parse_walk.cu``) folded into each tile: a thread block sweeps its tile of
:data:`TILE` positions into shared memory in passes of 512 threads (the
sweep is K1's, ``csrc/match_common.cuh::sweep_position``: one position a
thread, four distances a word step), walks the tile once per possible entry
offset, takes its true entry and token offset from the tile before it
through a 64-bit word in device memory, passes the state on, and packs its
tokens.  Tiles are numbered by an atomic ticket so a tile only ever waits
for one that is already running.  Two things bound it: the sweep's
operations (up to ``d_limit`` compares per position; it moves about 1 B
per input byte in and 4 B per token out) and the hand-off, a serial chain
over the batch's tiles of one device-memory round trip each (about 0.3 us).
The tile is long so that the chain is short: 2,048 hops for an 8 MiB batch
at 4096 positions, where 512 took 16,384; the maps and the emit walk grow
with the tile but lie off the chain.  :func:`sweep_walk_tiles_plain` is
the same decomposition in tensors.  It covers la 2..255 and sb 1..65535
like the two kernels it merges.
"""

from __future__ import annotations

import torch

from .. import _build, spec
from .. import device as device_lib
from . import match as match_ops
from . import parse_walk

# Positions a thread block of ``sweepwalk_kernel`` takes: one hop of the
# hand-off chain each.  The kernel takes it as an argument (1..16384).
TILE = 4096
# The merged kernel is not the fused pipeline's default route: ``parser=
# "merged"`` asks for it by name.
MERGED_DEFAULT = False


def _check(blocks, entry, valid_total, la):
    N = blocks.numel()
    if not 2 <= la <= 255:
        raise ValueError(f"merged kernel supports la in [2, 255], got {la}")
    if entry.dtype != torch.int32 or entry.shape != (1,) \
            or entry.device != blocks.device:
        raise ValueError("entry must be a (1,) int32 tensor on blocks' device")
    if not 0 <= valid_total <= N:
        raise ValueError(f"valid_total {valid_total} outside [0, {N}]")
    if N >= (1 << 31) - 256:
        raise ValueError("span too long for 32-bit positions")


def sweep_walk_plain(
    blocks: torch.Tensor,
    halos: torch.Tensor,
    rights: torch.Tensor,
    avails: torch.Tensor,
    valid_exts: torch.Tensor,
    entry: torch.Tensor,
    valid_total: int,
    *,
    la: int,
    sb: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the sweep's plain version, the LOX build and
    the walk's plain version in a row.  Token slots past the count are 0."""
    p = spec.Params(la=la, sb=sb)
    return parse_walk.walk_parse_pack_plain(
        _lox_plain(blocks, halos, rights, avails, valid_exts, la, sb), entry,
        valid_total, la=la, ob=p.off_bits, lb=p.len_bits,
    )


def _lox_plain(blocks, halos, rights, avails, valid_exts, la, sb):
    """The batch's LOX words (``parse_walk.build_lox``) from the sweep's
    plain version: what both plain versions walk."""
    G, B = blocks.shape
    N = G * B
    if N == 0 or spec.d_limit(sb) == 0:
        L = O = torch.zeros(N, dtype=torch.int32, device=blocks.device)
    else:
        L, O = match_ops.match_sweep_plain(
            blocks, halos, rights, avails, valid_exts, la=la, sb=sb
        )
    tail = rights[G - 1] if G else rights.reshape(-1)
    return parse_walk.build_lox(
        L.reshape(N), O.reshape(N), blocks.reshape(N), tail, la
    )


def sweep_walk_tiles_plain(
    blocks: torch.Tensor,
    halos: torch.Tensor,
    rights: torch.Tensor,
    avails: torch.Tensor,
    valid_exts: torch.Tensor,
    entry: torch.Tensor,
    valid_total: int,
    *,
    la: int,
    sb: int,
    tile: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version under the kernel's decomposition; the same
    result as :func:`sweep_walk_plain` for any ``tile`` (default
    :data:`TILE`).

    The span is cut into the kernel's tiles (``tile`` positions of one
    block, the last of a block short; only those that start before
    ``valid_total``).  Each tile's maps give, for every entry offset
    ``e < la``, the walk's exit position and token count inside the tile
    (an entry at or past the tile's end passes through).  The maps are
    chained from the batch entry in span order, which gives every tile its
    true entry, and each tile then emits its tokens from it.
    """
    tile = TILE if tile is None else tile
    if tile < 1:
        raise ValueError(f"tile must be at least 1, got {tile}")
    G, B = blocks.shape
    N = G * B
    p = spec.Params(la=la, sb=sb)
    dev = blocks.device
    lox = _lox_plain(blocks, halos, rights, avails, valid_exts, la, sb)
    ln = (lox.to(torch.int64) >> 16) & 0xFF
    tokens = torch.zeros(N, dtype=torch.int32, device=dev)
    p_abs = min(max(int(entry), 0), la - 1)
    if valid_total == 0:
        return (tokens, torch.zeros(1, dtype=torch.int32, device=dev),
                torch.tensor([p_abs], dtype=torch.int32, device=dev))
    # 1. the tiles, in span order
    t0 = torch.arange(0, B, tile, device=dev)
    base = (torch.arange(G, device=dev)[:, None] * B + t0[None, :]).reshape(-1)
    size = torch.clamp(B - t0, max=tile).repeat(G)
    keep = base < valid_total
    base, size = base[keep], size[keep]
    end = torch.minimum(size, valid_total - base)[:, None]

    def walk(P, record=False):
        """Walk every row from local positions P to its tile's end; the
        exit positions, the token counts and, if asked, the token starts
        (-1 where a row has ended), one column a step."""
        C = torch.zeros_like(P)
        starts = []
        while True:
            act = P < end
            if not bool(act.any()):
                return P, C, starts
            if record:
                starts.append(torch.where(act, base[:, None] + P, -1))
            step = ln[base[:, None] + torch.minimum(P, end - 1)] + 1
            P = torch.where(act, P + step, P)
            C = C + act

    # 2. the maps: exit position and token count by entry offset
    exit_map, cnt_map, _ = walk(
        torch.arange(la, device=dev)[None, :].expand(base.shape[0], la))
    # 3. chained from the batch entry: each tile's true entry
    entries, total = [], 0
    for b, e_end, ex, cn in zip(base.tolist(), end[:, 0].tolist(),
                                exit_map.tolist(), cnt_map.tolist()):
        e = p_abs - b
        entries.append(min(e, e_end))  # at or past the end: jumped over
        if e < e_end:
            total += cn[e]
            p_abs = b + ex[e]
    # 4. emit: every tile from its true entry, tiles in span order
    _, _, starts = walk(torch.tensor(entries, device=dev)[:, None], True)
    if starts:
        s = torch.cat(starts, dim=1).reshape(-1)
        s = s[s >= 0]
        tokens[: s.shape[0]] = parse_walk.token_words_at(
            lox, s, ob=p.off_bits, lb=p.len_bits)
    return (tokens, torch.tensor([total], dtype=torch.int32, device=dev),
            torch.tensor([p_abs - valid_total], dtype=torch.int32, device=dev))


def sweep_walk(
    blocks: torch.Tensor,      # (G, B) uint8
    halos: torch.Tensor,       # (G, d_limit) uint8
    rights: torch.Tensor,      # (G, la-1) uint8
    avails: torch.Tensor,      # (G,) int32
    valid_exts: torch.Tensor,  # (G,) int32
    entry: torch.Tensor,       # (1,) int32: parse entry into the span
    valid_total: int,          # valid bytes in the span, 0..G*B
    *,
    la: int,
    sb: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5 wrapper: raw batch -> (tokens, count, exit_entry).

    ``tokens`` is (G*B,) int32; its first ``count`` words are the packed
    tokens ``off | len<<off_bits | next<<(off_bits+len_bits)`` of the exact
    serial parse (the rest is unspecified).  ``count`` and ``exit_entry``
    are (1,) int32 tensors on the inputs' device.  CUDA tensors launch
    ``sweepwalk_kernel`` (or raise); CPU tensors run
    :func:`sweep_walk_plain`.  ``sweep_walk.launches`` counts launches.
    """
    p = spec.Params(la=la, sb=sb)
    G, B = blocks.shape
    N = G * B
    match_ops.check_batch(
        blocks, halos, rights, avails, valid_exts, p.d_limit, p.len_limit
    )
    _check(blocks, entry, valid_total, la)
    if not blocks.is_cuda:
        return sweep_walk_plain(
            blocks, halos, rights, avails, valid_exts, entry, valid_total,
            la=la, sb=sb,
        )
    dev = blocks.device
    tokens = torch.empty(N, dtype=torch.int32, device=dev)
    if valid_total == 0:  # nothing to walk: the entry passes through
        return (tokens, torch.zeros(1, dtype=torch.int32, device=dev),
                entry.clamp(0, la - 1))
    # tiles never straddle blocks; only those that start before valid_total
    tile = TILE
    full, rem = divmod(valid_total, B)
    n_tiles = full * -(-B // tile) + -(-rem // tile)
    lib = _build.kernels()
    sync = torch.zeros(n_tiles + 1, dtype=torch.int64, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    exit_e = torch.empty(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.lz77_sweepwalk(
            blocks.data_ptr(), halos.data_ptr(), rights.data_ptr(),
            avails.data_ptr(), valid_exts.data_ptr(), entry.data_ptr(),
            sync.data_ptr(), tokens.data_ptr(), count.data_ptr(),
            exit_e.data_ptr(), G, B, p.d_limit, p.len_limit, la, valid_total,
            tile, n_tiles, p.off_bits, p.len_bits,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "sweepwalk_kernel")
    sweep_walk.launches += 1
    return tokens, count, exit_e


sweep_walk.launches = 0


def encode_batch_sweepwalk(
    blocks,       # (G, B) uint8
    halos,        # (G, H) uint8
    rights,       # (G, R) uint8
    avails,       # (G,) int32
    valid_exts,   # (G,) int32
    valid_total: int,   # valid bytes in the batch span
    entry0,       # (1,) int32 tensor (or int): parse entry into the batch
    *,
    la: int,
    sb: int,
    device: str | torch.device | None = None,
):
    """One merged-kernel device step; same contract as
    ``models.fused.encode_batch_walk``.

    Returns (payload, counts, total_tokens, exit_entry): payload is
    (G*B*nb,) uint8 whose first ``total_tokens * nb`` bytes are the packed
    tokens; counts is a (G,) zero placeholder; total_tokens and exit_entry
    are (1,) int32 tensors that stay on the device, so batches chain without
    a host round trip.
    """
    params = spec.Params(la=la, sb=sb)
    if params.width % 8 != 0:
        raise ValueError("fused pipeline requires byte-aligned token width")
    dev = device_lib.resolve(device)

    def prep(a, dtype):
        return torch.as_tensor(a).to(device=dev, dtype=dtype).contiguous()

    blocks = prep(blocks, torch.uint8)
    tokens, total, exit_e = sweep_walk(
        blocks, prep(halos, torch.uint8), prep(rights, torch.uint8),
        prep(avails, torch.int32), prep(valid_exts, torch.int32),
        prep(entry0, torch.int32).reshape(1), int(valid_total), la=la, sb=sb,
    )
    payload = parse_walk.token_bytes(tokens, params.width // 8)
    counts = torch.zeros(blocks.shape[0], dtype=torch.int32, device=dev)
    return payload, counts, total, exit_e
