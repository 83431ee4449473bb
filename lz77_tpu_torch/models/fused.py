"""Device-resident fused encode: match -> parse -> pack per batch, on the device.

Replaces the reference's serial token loop (lz77.c:89-136) AND its bit
writer (lz77.c:246-251, bitio.c:203-236) with one device computation per
batch; the host only uploads raw bytes and fetches the packed payload prefix
and two scalars.

A batch is G consecutive blocks, one contiguous span of the input.  The
pipeline's batch step is :func:`encode_batch_walk`: the match sweep gives
(L, O) for every position (``ops.match``; any matcher by name, K1 by
default); ``build_lox`` fuses them with the bytes into one word per
position; the walk kernel (``ops.parse_walk``) follows the greedy chain
from the entry the previous batch left and writes packed token words, their
count and the next entry; the pack kernel (``ops.parse_walk.pack_bits``)
writes them ``width`` bits each from the bit phase the previous batch left,
and the next phase, all on the device.  It takes every token width.

Two more steps keep the JAX package's batch contract and are called as
steps, not through the pipeline: ``ops.fused_walk.encode_batch_sweepwalk``
(K5: the same result from one kernel that keeps the match tables on the
chip) and :func:`encode_batch_device` (the scan step: the parse in plain
tensor code, which also reports per-block token counts and, on request, the
batch's entry->exit map; the multi-process route runs it).  Both cut each
token word to bytes, so they take only widths that are byte multiples (the
default 12+4+8 = 24 bits is).  Streams are byte-identical across the
three, to the numpy executable spec and to the native host encoder.

The batch inputs keep the JAX package's contract — (G, B) blocks, each with
its own halo and right extension — so the two packages are compared like
with like.  Shapes cost nothing to change in eager PyTorch, so the last
batch carries only its real blocks, a block is no longer than the input,
and the host fetches the exact payload prefix.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .. import bitio, spec
from .. import device as device_lib
from ..ops import match as match_ops
from ..ops import parse_walk
from ..utils import faults as faults_lib
from ..utils import metrics as metrics_lib
from ..utils import profiling
from ..utils import transfer as transfer_lib

# Batch geometry: 8 blocks of 1 MiB.  An 8 MiB span gives the match kernel
# 16 Ki thread blocks and the walk 2 Ki sub-blocks — enough to fill the
# card — while its tables (L, O, LOX, tokens: 16 B per input byte) stay
# near 130 MB.  Both stay arguments.
DEFAULT_BLOCK_SIZE = 1 << 20
DEFAULT_BATCH_BLOCKS = 8
# Sub-block of the scan step: its tables are (span / s, s + la) wide.
DEFAULT_SCAN_SUB_BLOCK = 1 << 10


def _log2_ceil(n: int) -> int:
    return max(1, (n - 1).bit_length())


def encode_batch_walk(
    blocks,       # (G, B) uint8
    halos,        # (G, H) uint8
    rights,       # (G, R) uint8
    avails,       # (G,) int32
    valid_exts,   # (G,) int32
    valid_total: int,   # valid bytes in the batch span
    entry0,       # (1,) int32 tensor (or int): parse entry into the batch
    phase0=None,  # (1,) int32 tensor (or int): bit phase the batch starts at
    *,
    la: int,
    sb: int,
    sub_block: int = parse_walk.DEFAULT_SUB_BLOCK,
    matcher: str = match_ops.DEFAULT_MATCHER,
    counters=None,
    device: str | torch.device | None = None,
):
    """One fused device step over a batch of consecutive blocks, at any
    token width.

    Returns (payload, counts, total_tokens, exit_entry), and with
    ``phase0`` given ``exit_phase`` after them: payload is uint8 whose
    first ``ceil((phase0 + total_tokens * width) / 8)`` bytes are the
    tokens packed from bit ``phase0`` on, every other bit zero (without
    ``phase0`` the batch starts at bit 0); counts is a (G,) zero placeholder
    (the walk does not split its count by block); total_tokens, exit_entry
    and exit_phase are (1,) int32 tensors that stay on the device, so the
    next batch can take ``exit_entry`` and ``exit_phase`` as its ``entry0``
    and ``phase0`` without a host round trip.  ``matcher`` names the match
    tables' finder (``ops.match.get_matcher``; K1 by default); ``counters``
    (``ops.match.new_counters``), given with K1 only, gets its wide-window
    route's counts added.
    """
    params = spec.Params(la=la, sb=sb)
    dev = device_lib.resolve(device)

    def prep(a, dtype):
        return torch.as_tensor(a).to(device=dev, dtype=dtype).contiguous()

    blocks = prep(blocks, torch.uint8)
    rights = prep(rights, torch.uint8)
    entry0 = prep(entry0, torch.int32).reshape(1)
    G, B = blocks.shape
    N = G * B
    L, O = match_ops.get_matcher(matcher)(
        blocks, prep(halos, torch.uint8), rights, prep(avails, torch.int32),
        prep(valid_exts, torch.int32), la=la, sb=sb,
        **({} if counters is None else {"counters": counters}),
    )
    lox = parse_walk.build_lox(
        L.reshape(N), O.reshape(N), blocks.reshape(N), rights[G - 1], la
    )
    del L, O  # their memory serves the pack's output
    vt = int(valid_total)
    tokens, total, exit_e = parse_walk.walk_parse_pack(
        lox, entry0, vt,
        la=la, ob=params.off_bits, lb=params.len_bits, sub_block=sub_block,
    )
    del lox
    if phase0 is not None and not isinstance(phase0, int):
        phase0 = prep(phase0, torch.int32).reshape(1)
    payload, exit_phase = parse_walk.pack_bits(
        tokens, total, params.width, 0 if phase0 is None else phase0, vt)
    out = (payload, torch.zeros(G, dtype=torch.int32, device=dev), total,
           exit_e)
    return out if phase0 is None else out + (exit_phase,)


def encode_batch_device(
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
    sub_block: int = DEFAULT_SCAN_SUB_BLOCK,
    with_map: bool = False,
    head_w: int = 8192,
    matcher: str = match_ops.DEFAULT_MATCHER,
    device: str | torch.device | None = None,
):
    """One fused device step, the scan variant (plain tensor code);
    ``matcher`` names the match tables' finder (K1 by default).

    Returns (payload, counts, total_tokens, exit_entry):
      payload: (M*s*nb,) uint8 — packed token bytes, valid prefix only
        (M = ceil(G*B / s) sub-blocks of s = ``sub_block`` bytes);
      counts: (G,) int32 — tokens per block (for stats/manifest);
      total_tokens, exit_entry: (1,) int32 tensors on the device.

    ``with_map=True`` additionally returns (bmap, l_head, o_head): the
    batch's full (la,) entry->exit-overhang map (free — the sub-block map
    composition already produces it) and the first ``head_w`` positions'
    match tables.  With them a range can be parsed from entry 0 while the
    exact exit for any entry rides in the composed map, and a nonzero true
    entry needs only a head-window resync.
    """
    params = spec.Params(la=la, sb=sb)
    if params.width % 8 != 0:
        raise ValueError("fused pipeline requires byte-aligned token width")
    if sub_block < 1:
        raise ValueError("sub_block must be positive")
    dev = device_lib.resolve(device)
    nb = params.width // 8

    def prep(a, dtype):
        return torch.as_tensor(a).to(device=dev, dtype=dtype).contiguous()

    blocks = prep(blocks, torch.uint8)
    rights = prep(rights, torch.uint8)
    G, B = blocks.shape
    s = sub_block
    N = G * B
    M = -(-N // s)
    NP = M * s  # padded span length
    vt = int(valid_total)
    i64 = dict(dtype=torch.int64, device=dev)

    # ---- 1. match tables (the hot phase), flattened to the batch span ----
    L, O = match_ops.get_matcher(matcher)(
        blocks, prep(halos, torch.uint8), rights, prep(avails, torch.int32),
        prep(valid_exts, torch.int32), la=la, sb=sb,
    )
    L_flat = L.reshape(N).to(torch.int64)
    O_flat = O.reshape(N).to(torch.int64)

    # ---- 2. per-sub-block jump tables and entry->exit maps ----------------
    # J[m, p]: local chain position p in [0, s+la) of sub-block m.  Token
    # starts are positions with global index < valid_total; everything else
    # is a fixpoint (greedy_parse semantics, ops/parse.py).
    L_pad = torch.cat([L_flat, torch.zeros(NP - N + la, **i64)])
    pos_l = torch.arange(s + la, **i64)[None, :]        # (1, s+la)
    base = (torch.arange(M, **i64) * s)[:, None]        # (M, 1)
    gpos = base + pos_l                                 # (M, s+la)
    live = (pos_l < s) & (gpos < vt)
    J = torch.where(
        live, torch.clamp(pos_l + L_pad[gpos] + 1, max=s + la - 1), pos_l
    )
    # f^s by squaring: log2(s) gathers over (M, s+la).
    F = J
    for _ in range(_log2_ceil(s)):
        F = torch.gather(F, 1, F)
    # next-entry map, rebased against the sub-block's VALID span: chains
    # stop at the first position >= the valid boundary, so the overhang is
    # exit - vl_local.  For full sub-blocks vl_local == s; for the batch's
    # ragged tail it is the true end-of-batch boundary; for fully-padded
    # sub-blocks (vl_local == 0) the map is the identity.
    vl_local = torch.clamp(vt - base, 0, s)             # (M, 1)
    nmap = torch.clamp(F[:, :la] - vl_local, 0, la - 1)  # (M, la)

    # ---- 3. compose maps across sub-blocks: inclusive prefix scan ---------
    # (a then b)[e] = b[a[e]] is associative, so log2(M) rounds of "compose
    # with the prefix d rows up" give every prefix.
    P = nmap
    d = 1
    while d < M:
        P = torch.cat([P[:d], torch.gather(P[d:], 1, P[:-d])])
        d *= 2
    e0 = prep(entry0, torch.int64).reshape(1).clamp(0, la - 1)
    entries = torch.cat([e0, P[:-1].index_select(1, e0).reshape(-1)])  # (M,)
    exit_entry = P[-1].index_select(0, e0)

    # ---- 4. token starts: batched pointer-doubling orbit -----------------
    # S[m, i] = f^i(entry_m); chain values never exceed s+la-1.
    S = torch.zeros((M, s), **i64)
    S[:, 0] = entries
    Jp = J
    m_fill = 1
    while m_fill < s:
        span = min(m_fill, s - m_fill)
        S[:, m_fill : m_fill + span] = torch.gather(Jp, 1, S[:, :span])
        Jp = torch.gather(Jp, 1, Jp)
        m_fill *= 2
    counts_m = (S < vl_local).sum(dim=1)                # (M,)

    # ---- 5. compact + pack ------------------------------------------------
    ccum = torch.cat([torch.zeros(1, **i64), torch.cumsum(counts_m, 0)])
    total_tokens = ccum[-1:]
    t = torch.arange(NP, **i64)
    mi = torch.clamp(torch.searchsorted(ccum, t, right=True) - 1, 0, M - 1)
    li = t - ccum[mi]
    # slots past the total index anywhere; they are zeroed below
    start_l = S.reshape(-1)[torch.clamp(mi * s + li, max=NP - 1)]
    gstart = torch.clamp(mi * s + start_l, max=N - 1)
    ln = L_flat[gstart]
    x_ext = torch.cat([blocks.reshape(N), rights[G - 1]]).to(torch.int64)
    nxt = x_ext[torch.clamp(gstart + ln, max=N + rights.shape[1] - 1)]
    v = (
        O_flat[gstart]
        | (ln << params.off_bits)
        | (nxt << (params.off_bits + params.len_bits))
    )
    v = torch.where(t < total_tokens, v, 0)
    # 32-bit token words set the sign bit: fold into int32's range first
    v = torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)
    payload = parse_walk.token_bytes(v, nb)

    # per-block counts for stats/manifest
    if B % s == 0:
        counts_b = counts_m.reshape(G, B // s).sum(dim=1)
    else:
        blk = base[:, 0] // B  # block of each sub-block's first byte
        counts_b = torch.zeros(G, **i64).index_add_(0, blk, counts_m)
    out = (payload, counts_b.to(torch.int32), total_tokens.to(torch.int32),
           exit_entry.to(torch.int32))
    if with_map:
        w = min(head_w, N)
        out += (P[-1].to(torch.int32),          # (la,) batch entry->exit map
                L_flat[:w].to(torch.int32), O_flat[:w].to(torch.int32))
    return out


def _sizes(n: int, block_size: int | None, sub_block: int | None):
    """(block_size, sub_block) for an n-byte input: the defaults where
    None, each checked positive."""
    if block_size is None:
        block_size = min(DEFAULT_BLOCK_SIZE, max(n, 1))
    if sub_block is None:
        sub_block = parse_walk.DEFAULT_SUB_BLOCK
    if block_size < 1 or sub_block < 1:
        raise ValueError("block_size and sub_block must be positive")
    return block_size, sub_block


def _span_start(gn: int, H: int) -> int:
    """Where a batch's span starts in its staging buffer: after the
    ``2 * gn`` int32 of ``avails`` and ``valid_exts``, so that its blocks
    start on a 16-byte boundary."""
    return 8 * gn + (-(8 * gn + H)) % 16


def span_bytes(gn: int, B: int, H: int, R: int) -> int:
    """Bytes of the staging buffer of a batch of ``gn`` blocks."""
    return _span_start(gn, H) + gn * B + H + R


def stage_span(x: np.ndarray, n: int, g0: int, gn: int, B: int, H: int,
               R: int, buf: np.ndarray) -> None:
    """Stage blocks ``g0 .. g0+gn`` of ``x`` in ``buf`` (uint8, at least
    :func:`span_bytes` long): the int32 ``avails`` and ``valid_exts`` of
    ``codec._batch_inputs``, then the one span ``x[g0*B - H : (g0+gn)*B +
    R]`` that holds every block, halo and right extension, with zeros before
    byte 0 and past byte ``n``."""
    gs = (g0 + np.arange(gn, dtype=np.int64)) * B
    ints = buf[: 8 * gn].view(np.int32)
    ints[:gn] = np.minimum(H, gs)
    ints[gn:] = np.minimum(B + R, n - gs)
    lo = g0 * B - H
    span = buf[_span_start(gn, H): span_bytes(gn, B, H, R)]
    a, b = max(lo, 0), min((g0 + gn) * B + R, n)
    span[: a - lo] = 0
    span[a - lo: b - lo] = x[a:b]
    span[b - lo:] = 0


def rows_from_span(span: torch.Tensor, gn: int, B: int, H: int, R: int):
    """The matcher's batch (blocks, halos, rights, avails, valid_exts) from
    a staged buffer (:func:`stage_span`) wherever it lies: the blocks a
    view of the span, halos and rights one strided gather each."""
    s0 = _span_start(gn, H)
    ints = span[: 8 * gn].view(torch.int32)
    blocks = span[s0 + H: s0 + H + gn * B].view(gn, B)
    base = span.storage_offset() + s0
    halos = span.as_strided((gn, H), (B, 1), base).contiguous()
    rights = span.as_strided((gn, R), (B, 1), base + H + B).contiguous()
    return blocks, halos, rights, ints[:gn], ints[gn:]


def iter_batches_fused(
    x: np.ndarray,
    params: spec.Params,
    *,
    block_size: int | None = None,
    batch_blocks: int = DEFAULT_BATCH_BLOCKS,
    sub_block: int | None = None,
    matcher: str = match_ops.DEFAULT_MATCHER,
    start_batch: int = 0,
    entry: int = 0,
    phases=None,
    stats=None,
    retries: int = 2,
    device: str | torch.device | None = None,
):
    """Yield (batch_index, e_in, e_out, token_count, payload) per batch.

    The fused device pipeline as a resumable iterator.  ``start_batch`` /
    ``entry`` resume mid-stream at bit phase 0, so at a byte-multiple token
    width (the file route, the one that resumes, takes no other); a payload
    is the batch's tokens packed from the bit phase the batches before it
    left (no header) as a read-only ``memoryview``, valid until the next
    batch is drawn (its fetch buffer is then refilled).  Where that phase is
    not 0, the payload's first byte holds the stream's last bits as zeros
    and is OR-ed into the stream's last byte
    (``utils.transfer.BytesBuilder.write``).  Two-deep software pipeline:
    batch k+1 is submitted before batch k is fetched, and the parse entry
    and the bit phase ride from batch to batch as device tensors, so
    nothing on the dependency chain waits for the host; the host keeps its
    own phase to size each fetch.

    A batch's blocks, halos and right extensions are slices of one span of
    ``x`` (:func:`stage_span`), uploaded whole and cut into rows on the
    device (:func:`rows_from_span`).  On a CUDA device the span is staged in
    a page-locked buffer and uploaded on a copy stream without blocking the
    host, the compute stream waiting on the copy's event; each batch records
    an event after its last kernel, and its fetch waits on that event alone
    and copies the results on the copy stream while the next batch computes
    (``utils.transfer``).  On the CPU the same steps run with a numpy span
    and no stream or event.

    Each batch runs :func:`encode_batch_walk` (match sweep, walk kernel,
    pack kernel; any token width); ``matcher`` names its match tables'
    finder (``ops.match.get_matcher``) and ``sub_block`` its walk's
    sub-block (``parse_walk.DEFAULT_SUB_BLOCK`` where None).
    """
    dev = device_lib.resolve(device)
    n = x.shape[0]
    block_size, sub_block = _sizes(n, block_size, sub_block)
    width = params.width
    B, G = block_size, batch_blocks
    H, R = params.d_limit, params.len_limit
    # K1's wide-window route counts its walk on the device; the counts ride
    # in each batch's (total, exit) fetch
    counted = (stats is not None
               and match_ops.route_matcher(matcher) == "sweep"
               and match_ops.takes_chain(H))
    nblocks = -(-n // B)
    num_batches = -(-nblocks // G)
    if phases is None and stats is not None:
        phases = stats.phases
    ph = phases if phases is not None else metrics_lib.PhaseTimes()
    cuda = dev.type == "cuda"

    with (transfer_lib.borrow(dev) if cuda
          else contextlib.nullcontext()) as tr:
        prev_done = None  # the event of the batch submitted last
        # the bit phase the next batch starts at: on the device (an int
        # before the first batch), and on the host
        phase_dev, phase_host = 0, 0

        # Under a profiler each step below is a span
        # (utils.profiling.annotate) kept in ``stats.spans``; ``phases.io``
        # and ``phases.match`` time the same code with or without one.
        def submit(bi: int, entry_dev):
            nonlocal prev_done, phase_dev
            g0 = bi * G
            gn = min(G, nblocks - g0)
            size = span_bytes(gn, B, H, R)
            with profiling.annotate("encode.stage", stats):
                buf = (tr.staging(bi % 2, size) if cuda
                       else np.empty(size, np.uint8))
                stage_span(x, n, g0, gn, B, H, R, buf)
            vt = min(gn * B, n - g0 * B)
            with profiling.annotate("encode.upload", stats):
                # the card still runs the previous batch: this one's host
                # work was hidden behind it
                hidden = prev_done is not None and not prev_done.query()
                span = (tr.upload(bi % 2, size) if cuda
                        else torch.from_numpy(buf))
            with profiling.annotate("encode.launch", stats):
                counters = match_ops.new_counters(dev) if counted else None
                payload, _, total, exit_entry, exit_phase = encode_batch_walk(
                    *rows_from_span(span, gn, B, H, R), vt, entry_dev,
                    phase_dev, la=params.la, sb=params.sb,
                    sub_block=sub_block, matcher=matcher, counters=counters,
                    device=dev,
                )
                # the counters' int64 words as int32 halves
                pair = torch.cat([total, exit_entry] + (
                    [counters.view(torch.int32)] if counted else []))
                done = tr.done() if cuda else None
            if stats is not None:
                stats.h2d_bytes += size
                stats.batches += 1
                stats.batches_overlapped += hidden
            prev_done = done
            phase_dev = exit_phase
            return bi, payload, pair, done, exit_entry

        def fetch(handle, e_in: int):
            nonlocal phase_host
            bi, payload, pair, done, _ = handle
            with metrics_lib.StopwatchPhase(ph, "match"):
                with profiling.annotate("encode.wait", stats):
                    tot, ex, *halves = (tr.scalars(pair, done) if cuda
                                        else pair.tolist())
                bits = phase_host + tot * width
                nbytes = -(-bits // 8)
                with profiling.annotate("encode.fetch", stats):
                    buf = (tr.fetch(payload, nbytes) if cuda
                           else memoryview(payload[:nbytes].numpy()))
                if stats is not None:
                    stats.d2h_bytes += nbytes + 4 * len(pair)
                    stats.seams += phase_host != 0
                if halves:
                    walked, hops, fell = np.array(
                        halves, np.int32).view(np.int64).tolist()
                    stats.match_positions += walked
                    stats.match_hops += hops
                    stats.match_fallbacks += fell
            phase_host = bits & 7
            return bi, e_in, ex, tot, buf

        yield from two_deep(submit, fetch, range(start_batch, num_batches),
                            entry, device=dev, phases=ph, stats=stats,
                            retries=retries)


def two_deep(submit, fetch, batches, entry: int, *, device, phases, stats,
             retries: int):
    """The device pipelines' two-deep loop over ``batches``: batch k+1 is
    submitted before batch k is fetched, and the parse entry rides from
    batch to batch as a (1,) int32 tensor on ``device``.

    ``submit(bi, entry_dev)`` launches a batch and returns its handle, whose
    last item is the batch's exit entry on the device; ``fetch(handle,
    e_in)`` returns the batch's ``(bi, e_in, e_out, ...)``, which is
    yielded.  Each is retried ``retries`` times (``stats.retries`` counts
    them): batches are independent up to the entry, and a retried submit
    reads the previous batch's exit tensor again, still live because the
    kernels only read it (SURVEY.md §5).
    """
    def count_retry():
        if stats is not None:
            stats.retries += 1

    entry_dev = torch.tensor([entry], dtype=torch.int32, device=device)
    e_in = int(entry)
    pending = None
    for bi in batches:
        with metrics_lib.StopwatchPhase(phases, "io"):
            nxt = faults_lib.with_retries(
                submit, bi, entry_dev, retries=retries, on_retry=count_retry
            )
            entry_dev = nxt[-1]
        if pending is not None:
            out = faults_lib.with_retries(
                fetch, pending, e_in, retries=retries, on_retry=count_retry
            )
            e_in = out[2]
            yield out
        pending = nxt
    if pending is not None:
        yield faults_lib.with_retries(
            fetch, pending, e_in, retries=retries, on_retry=count_retry
        )


def encode_bytes_fused(
    data: bytes,
    params: spec.Params | None = None,
    *,
    block_size: int | None = None,
    batch_blocks: int = DEFAULT_BATCH_BLOCKS,
    sub_block: int | None = None,
    stats=None,
    matcher: str = match_ops.DEFAULT_MATCHER,
    device: str | torch.device | None = None,
) -> bytes:
    """Compress via the fused device pipeline (:func:`iter_batches_fused`:
    match sweep, walk kernel and pack kernel a batch, any token width);
    ``matcher``: any name of ``ops.match.get_matcher``."""
    from . import codec as codec_model  # lazy: avoid import cycle

    params = params or spec.Params()
    dev = device_lib.resolve(device)
    x = np.frombuffer(data, dtype=np.uint8)
    n = x.shape[0]
    block_size, sub_block = _sizes(n, block_size, sub_block)
    st = stats if stats is not None else codec_model.EncodeStats()
    st.input_bytes = n

    if n == 0:
        st.output_bytes = spec.HEADER_BYTES
        return bitio.header_bytes(params)

    total_tokens = 0
    # a token covers at least one input byte: the stream is no longer
    with metrics_lib.StopwatchPhase(st.phases, "total"), \
            transfer_lib.BytesBuilder(
                spec.HEADER_BYTES + -(-n * params.width // 8)) as out:
        out.write(bitio.header_bytes(params))
        for _, _, _, tok, payload in iter_batches_fused(
            x, params, block_size=block_size, batch_blocks=batch_blocks,
            sub_block=sub_block, matcher=matcher, stats=st,
            device=dev,
        ):
            # from the fetch buffer to its place; a batch that starts
            # inside a byte shares it with the stream's last
            with profiling.annotate("encode.write", st):
                out.write(payload, seam=total_tokens * params.width % 8 != 0)
            total_tokens += tok
        st.tokens = total_tokens
        st.blocks = -(-n // block_size)
        with profiling.annotate("encode.assemble", st):
            stream = out.finish()
        st.output_bytes = len(stream)
    return stream
