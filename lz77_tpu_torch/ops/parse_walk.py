"""Greedy parse + token pack: LOX build, plain PyTorch version, CUDA kernel.

The greedy jump chain ``p <- p + L[p] + 1`` (the reference's encode loop,
lz77.c:89-136) is the only serial dependency of the encoder once the match
tables are known.  All per-position inputs are fused into one int32 word per
byte ("LOX" = next_char<<24 | len<<16 | off), so a token costs two loads:
the jump word at ``p`` and the next-char word at ``p + len``.

Contract (the JAX package's ``ops.parse_walk``): the walk starts at
``entry`` in [0, la), emits a token at every chain position
``p < valid_total``, reads ``next`` at ``p + len`` (which may lie in the
la-word tail past the span: the last block's right extension), and leaves
``exit = p - valid_total`` in [0, la) as the next batch's entry.  A token
word is ``off | len<<ob | next<<(ob+lb)``.  ``entry``, the count and the
exit are one-element int32 tensors on the device, so batches chain without
a host round trip.

Kernel note — ``csrc/parse_walk.cu`` replaces the TPU kernel
``lz77_tpu/ops/parse_walk.py::_kernel``, which walks the chain on the
scalar unit because that machine has no vector gather.  Hopper has, so the
walk is the parallel form: the span is cut into sub-blocks of ``sub_block``
bytes; a token overhangs a sub-block's end by at most la-1 bytes, so a
sub-block's parse state is its entry offset.  (1) one thread block per
sub-block stages the lengths of its LOX words in shared memory and walks
the sub-block from every entry: its map entry -> (exit offset, token
count); (2) one thread block composes the maps, which are associative,
with a scan (groups of 32 maps composed in a row, the group maps scanned in
log2 rounds, then each group applied from its true entry): every
sub-block's true entry and output offset, and the total and the exit;
(3) one thread block per sub-block stages its LOX words with the la-1
after them, one thread walks from the true entry recording token starts in
shared memory, and all threads pack the token words and store them
coalesced at the offset.  The kernel is bound by latency, not by bytes (4 B
read per input byte, 4 B written per token): every step is a dependent
load, here from shared memory, and no thread walks more than one sub-block
or 32 maps in a row (the first port had one thread compose all the maps
in order).  The staging tiles, the 128-word overlap and the la <= 128
limit of the TPU kernel are gone, and la goes up to 255 (the LOX length
field is 8 bits).  :func:`walk_parse_pack_plain` with ``sub_block`` follows
the three steps.
"""

from __future__ import annotations

import torch

from .. import _build

# Sub-block of the parallel walk: the bytes one thread walks from one entry,
# and one thread block's work.  Larger means fewer maps to compose and
# fewer, longer walks.
DEFAULT_SUB_BLOCK = 4096
# csrc/parse_walk.cu's scan: maps a chunk holds times la, maps a group
SCAN_ENTRIES = 32768
SCAN_GROUP = 32


def build_lox(
    L_flat: torch.Tensor,
    O_flat: torch.Tensor,
    x_flat: torch.Tensor,
    tail: torch.Tensor,
    la: int,
) -> torch.Tensor:
    """Fuse match tables + bytes into LOX words: (N + la,) int32.

    L_flat/O_flat: (N,) int32 match tables; x_flat: (N,) uint8 input bytes;
    tail: uint8 bytes following the span (the last block's right extension),
    cut or zero-padded to ``la`` words that carry only their byte.  The word
    is assembled as four little-endian bytes (off lo, off hi, len, byte) and
    reinterpreted, which keeps bytes >= 128 clear of int32 overflow; the
    byte planes are filled in place to avoid N-sized temporaries.
    """
    N = L_flat.shape[0]
    q = torch.zeros((N + la, 4), dtype=torch.uint8, device=L_flat.device)
    q[:N, 0] = O_flat & 0xFF
    q[:N, 1] = O_flat >> 8
    q[:N, 2] = L_flat
    q[:N, 3] = x_flat
    k = min(tail.shape[0], la)
    q[N : N + k, 3] = tail[:k]
    return q.view(torch.int32).reshape(N + la)


def token_bytes(tokens: torch.Tensor, nb: int) -> torch.Tensor:
    """(N,) int32 token words -> (N*nb,) uint8: the low ``nb`` bytes of each
    word, little-endian — the payload of a byte-aligned token width."""
    N = tokens.shape[0]
    return tokens.view(torch.uint8).reshape(N, 4)[:, :nb].reshape(N * nb)


def token_words_at(lox: torch.Tensor, starts: torch.Tensor, *, ob: int,
                   lb: int) -> torch.Tensor:
    """The packed token words ``off | len<<ob | next<<(ob+lb)`` (int32) of
    the tokens that start at span positions ``starts`` (int64), read from
    the LOX words; ``next`` is the byte at ``start + len``."""
    w = lox.to(torch.int64)
    head = w[starts]
    ln = (head >> 16) & 0xFF
    nxt = (w[torch.clamp(starts + ln, max=lox.shape[0] - 1)] >> 24) & 0xFF
    word = (head & 0xFFFF) | (ln << ob) | (nxt << (ob + lb))
    # 32-bit token words set the sign bit: fold into int32's range first
    return torch.where(word >= (1 << 31), word - (1 << 32), word).to(
        torch.int32)


def _walk_maps_plain(lox: torch.Tensor, valid_total: int, sub_block: int,
                    la: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Step 1: every sub-block's map, (M, la) exit offsets and (M, la)
    token counts (int64), by walking all M * la walks a step at a time."""
    n_ext = lox.shape[0]
    dev = lox.device
    ln = (lox.to(torch.int64) >> 16) & 0xFF
    M = -(-valid_total // sub_block)
    base = torch.arange(M, dtype=torch.int64, device=dev) * sub_block
    end = torch.clamp(base + sub_block, max=valid_total)[:, None]
    p = base[:, None] + torch.arange(la, dtype=torch.int64, device=dev)
    c = torch.zeros_like(p)
    while True:
        live = p < end
        if not bool(live.any()):
            break
        p = torch.where(live, p + ln[torch.clamp(p, max=n_ext - 1)] + 1, p)
        c += live
    return torch.clamp(p - end, max=la - 1), c


def _compose_maps_plain(ex: torch.Tensor, cnt: torch.Tensor,
                       entry: torch.Tensor, la: int):
    """Step 2: the maps' scan as the kernel runs it -> (entries (M,),
    offsets (M,), count, exit), int64.  Chunks of ``SCAN_ENTRIES // la``
    maps; in each, groups of ``SCAN_GROUP`` maps composed in a row, the
    group maps scanned (Hillis-Steele: S_j <- S_j o S_{j-d}), then each
    group applied from its true entry; the chunk's exit carries on."""
    M = ex.shape[0]
    dev = ex.device
    G = SCAN_GROUP
    ident = torch.arange(la, dtype=torch.int64, device=dev)
    e_in = int(entry.to(torch.int64).clamp(0, la - 1)[0])
    o_in = 0
    entries = torch.empty(M, dtype=torch.int64, device=dev)
    offsets = torch.empty(M, dtype=torch.int64, device=dev)
    C = SCAN_ENTRIES // la
    for c0 in range(0, M, C):
        n = min(C, M - c0)
        ng = -(-n // G)
        # pad the chunk to whole groups with identity maps of count 0
        exg = ident.repeat(ng * G, 1)
        cntg = torch.zeros(ng * G, la, dtype=torch.int64, device=dev)
        exg[:n] = ex[c0 : c0 + n]
        cntg[:n] = cnt[c0 : c0 + n]
        exg = exg.reshape(ng, G, la)
        cntg = cntg.reshape(ng, G, la)
        gx = ident.repeat(ng, 1)
        gc = torch.zeros(ng, la, dtype=torch.int64, device=dev)
        for k in range(G):
            gc = gc + cntg[:, k].gather(1, gx)
            gx = exg[:, k].gather(1, gx)
        d = 1
        while d < ng:
            x = gx[:-d]
            gx, gc = (torch.cat([gx[:d], gx[d:].gather(1, x)]),
                      torch.cat([gc[:d], gc[:-d] + gc[d:].gather(1, x)]))
            d *= 2
        x = torch.cat([torch.tensor([e_in], device=dev), gx[:-1, e_in]])
        o = o_in + torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                              gc[:-1, e_in]])
        rows = torch.arange(ng, device=dev)
        for k in range(G):
            idx = rows * G + k
            keep = idx < n
            entries[c0 + idx[keep]] = x[keep]
            offsets[c0 + idx[keep]] = o[keep]
            o = o + cntg[rows, k, x]
            x = exg[rows, k, x]
        o_in += int(gc[-1, e_in])
        e_in = int(gx[-1, e_in])
    return entries, offsets, o_in, e_in


def _emit_plain(lox: torch.Tensor, valid_total: int, sub_block: int,
               entries: torch.Tensor, offsets: torch.Tensor, *, la: int,
               ob: int, lb: int) -> torch.Tensor:
    """Step 3: every sub-block walked from its true entry, its token words
    written from its offset -> (N,) int32, zero past the count."""
    n_ext = lox.shape[0]
    dev = lox.device
    ln = (lox.to(torch.int64) >> 16) & 0xFF
    M = entries.shape[0]
    base = torch.arange(M, dtype=torch.int64, device=dev) * sub_block
    end = torch.clamp(base + sub_block, max=valid_total)
    p = base + entries
    slot = offsets.clone()
    tokens = torch.zeros(n_ext - la, dtype=torch.int32, device=dev)
    while True:
        live = p < end
        if not bool(live.any()):
            break
        tokens[slot[live]] = token_words_at(lox, p[live], ob=ob, lb=lb)
        slot = slot + live
        p = torch.where(live, p + ln[torch.clamp(p, max=n_ext - 1)] + 1, p)
    return tokens


def walk_parse_pack_plain(
    lox: torch.Tensor,
    entry: torch.Tensor,
    valid_total: int,
    *,
    la: int,
    ob: int,
    lb: int,
    sub_block: int | None = None,
    sub_blocks: bool = False,
):
    """Plain PyTorch version.  Token slots past the count are zero.

    ``sub_block=None``: the chain as a pointer-doubling orbit, S[i] =
    f^i(entry) over the jump table f(p) = p + L[p] + 1 (fixpoints at and
    past ``valid_total``): each round doubles the number of known chain
    positions with one gather, log2(N) rounds in all.  With ``sub_block``
    it follows the kernel: the sub-blocks' maps, their scan, and the walks
    from the true entries (:func:`_walk_maps_plain`,
    :func:`_compose_maps_plain`, :func:`_emit_plain`).  ``sub_blocks=True``
    (which needs ``sub_block``) adds the scan's (M,) int32 ``entries`` and
    ``offsets`` to the return, as :func:`walk_parse_pack` does.
    """
    if sub_blocks and sub_block is None:
        raise ValueError("sub_blocks=True needs a sub_block")
    if sub_block is not None:
        if sub_block < 1:
            raise ValueError(f"sub_block {sub_block} must be positive")
        ex, cnt = _walk_maps_plain(lox, valid_total, sub_block, la)
        entries, offsets, count, exit_e = _compose_maps_plain(
            ex, cnt, entry, la)
        tokens = _emit_plain(lox, valid_total, sub_block, entries, offsets,
                            la=la, ob=ob, lb=lb)
        dev = lox.device
        out = (tokens,
               torch.tensor([count], dtype=torch.int32, device=dev),
               torch.tensor([exit_e], dtype=torch.int32, device=dev))
        if sub_blocks:
            out += (entries.to(torch.int32), offsets.to(torch.int32))
        return out
    n_ext = lox.shape[0]
    N = n_ext - la
    dev = lox.device
    ln = (lox.to(torch.int64) >> 16) & 0xFF
    pos = torch.arange(n_ext, dtype=torch.int64, device=dev)
    J = torch.where(
        pos < valid_total, torch.clamp(pos + ln + 1, max=n_ext - 1), pos
    )
    S = torch.zeros(N + 1, dtype=torch.int64, device=dev)
    S[0:1] = entry.to(torch.int64).clamp(0, la - 1)
    m = 1
    while m <= N:
        span = min(m, N + 1 - m)
        S[m : m + span] = J[S[:span]]
        J = J[J]
        m *= 2
    starts = S[:N]
    valid = starts < valid_total
    word = torch.where(valid, token_words_at(lox, starts, ob=ob, lb=lb), 0)
    count = valid.sum().to(torch.int32).reshape(1)
    exit_e = (S[N] - valid_total).to(torch.int32).reshape(1)
    return word, count, exit_e


def walk_parse_pack(
    lox: torch.Tensor,      # (N + la,) int32 LOX words
    entry: torch.Tensor,    # (1,) int32: parse entry into the span
    valid_total: int,       # valid bytes in the span, 0..N
    *,
    la: int,
    ob: int,
    lb: int,
    sub_block: int = DEFAULT_SUB_BLOCK,
    sub_blocks: bool = False,
):
    """K2 wrapper: greedy parse + pack -> (tokens, count, exit_entry).

    ``tokens`` is (N,) int32; its first ``count`` words are the packed
    tokens of the exact serial parse (the rest is unspecified).  ``count``
    and ``exit_entry`` are (1,) int32 tensors on ``lox``'s device.
    ``sub_block`` is the bytes one thread walks from one entry (and one
    thread block's share of the span); it never changes the result.
    ``sub_blocks=True`` also returns what the scan learnt of the M =
    ceil(valid_total / sub_block) sub-blocks: ``entries`` (M,) int32, each
    one's true entry (the offset of its first token start from its own
    start), and ``offsets`` (M,) int32, the number of tokens before it; the
    CPU then runs the plain version's ``sub_block`` form.  CUDA
    tensors launch the kernel (or raise); CPU tensors run the plain
    version.  ``walk_parse_pack.launches`` counts launches and
    ``walk_parse_pack.scratch_bytes`` is the device-memory scratch of the
    last one (the maps, the sub-blocks' entries and offsets).
    """
    N = lox.shape[0] - la
    if not 2 <= la <= 255:
        raise ValueError(f"walk parser supports la in [2, 255], got {la}")
    if lox.dtype != torch.int32 or lox.dim() != 1 or N < 0 \
            or not lox.is_contiguous():
        raise ValueError("lox must be a contiguous (N + la,) int32 tensor")
    if entry.dtype != torch.int32 or entry.shape != (1,) \
            or entry.device != lox.device:
        raise ValueError("entry must be a (1,) int32 tensor on lox's device")
    if not 0 <= valid_total <= N:
        raise ValueError(f"valid_total {valid_total} outside [0, {N}]")
    if N >= (1 << 31) - 256 or sub_block < 1 or ob + lb > 24:
        raise ValueError("span, sub_block or field widths out of range")
    if not lox.is_cuda:
        return walk_parse_pack_plain(
            lox, entry, valid_total, la=la, ob=ob, lb=lb,
            sub_block=sub_block if sub_blocks else None,
            sub_blocks=sub_blocks,
        )
    lib = _build.kernels()
    dev = lox.device
    M = -(-valid_total // sub_block)
    exit_map = torch.empty(M * la, dtype=torch.uint8, device=dev)
    cnt_map = torch.empty(M * la, dtype=torch.int32, device=dev)
    entries = torch.empty(M, dtype=torch.int32, device=dev)
    offsets = torch.empty(M, dtype=torch.int32, device=dev)
    tokens = torch.empty(N, dtype=torch.int32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    exit_e = torch.empty(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.lz77_walk_parse_pack(
            lox.data_ptr(), entry.data_ptr(), exit_map.data_ptr(),
            cnt_map.data_ptr(), entries.data_ptr(), offsets.data_ptr(),
            tokens.data_ptr(), count.data_ptr(), exit_e.data_ptr(),
            valid_total, sub_block, la, ob, lb,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "walk_parse_pack_kernel")
    walk_parse_pack.launches += 1
    walk_parse_pack.scratch_bytes = 5 * M * la + 8 * M
    if sub_blocks:
        return tokens, count, exit_e, entries, offsets
    return tokens, count, exit_e


walk_parse_pack.launches = 0
walk_parse_pack.scratch_bytes = 0
