"""Device-resident fused encode: match -> parse -> pack per batch, on the device.

Replaces the reference's serial token loop (lz77.c:89-136) AND its bit
writer (lz77.c:246-251, bitio.c:203-236) with one device computation per
batch; the host only uploads raw bytes and fetches the packed payload prefix
and two scalars.  Token widths must be byte multiples (the default 12+4+8 =
24 bits is).

A batch is G consecutive blocks, one contiguous span of the input.  The
batch step has three forms, chosen by ``parser``:

* ``"walk"`` (the default, :func:`encode_batch_walk`): the match sweep gives
  (L, O) for every position (``ops.match``; any matcher by name, K1 by
  default); ``build_lox`` fuses them with
  the bytes into one word per position; the walk kernel (``ops.parse_walk``)
  follows the greedy chain from the entry the previous batch left and writes
  packed token words, their count and the next entry; the words are cut to
  ``width/8`` bytes each.
* ``"merged"`` (``ops.fused_walk.encode_batch_sweepwalk``): the same result
  from one kernel that keeps the match tables on the chip; it runs its own
  sweep, so any matcher but ``sweep`` raises.
* ``"scan"`` (:func:`encode_batch_device`): the match sweep, then the parse
  as plain tensor code — per-sub-block jump tables squared into entry->exit
  maps, the maps composed by a prefix scan, token starts by a batched
  pointer-doubling orbit, compaction and pack.  It holds no kernel of its
  own; it also reports per-block token counts and, on request, the batch's
  entry->exit map.

Streams are byte-identical across the three, to the numpy executable spec
and to the native host encoder.

The batch inputs keep the JAX package's contract — (G, B) blocks, each with
its own halo and right extension — so the two packages are compared like
with like.  Shapes cost nothing to change in eager PyTorch, so the last
batch carries only its real blocks, a block is no longer than the input,
and the host fetches the exact payload prefix.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import bitio, spec
from .. import device as device_lib
from ..ops import fused_walk
from ..ops import match as match_ops
from ..ops import parse_walk
from ..utils import faults as faults_lib
from ..utils import metrics as metrics_lib

# Batch geometry: 8 blocks of 1 MiB.  An 8 MiB span gives the match kernel
# 16 Ki thread blocks and the walk 2 Ki sub-blocks — enough to fill the
# card — while its tables (L, O, LOX, tokens: 16 B per input byte) stay
# near 130 MB.  Both stay arguments.
DEFAULT_BLOCK_SIZE = 1 << 20
DEFAULT_BATCH_BLOCKS = 8
# Sub-block of the scan parser: its tables are (span / s, s + la) wide.
DEFAULT_SCAN_SUB_BLOCK = 1 << 10
PARSERS = ("walk", "merged", "scan")


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
    *,
    la: int,
    sb: int,
    sub_block: int = parse_walk.DEFAULT_SUB_BLOCK,
    matcher: str = match_ops.DEFAULT_MATCHER,
    device: str | torch.device | None = None,
):
    """One fused device step over a batch of consecutive blocks.

    Returns (payload, counts, total_tokens, exit_entry): payload is
    (G*B*nb,) uint8 whose first ``total_tokens * nb`` bytes are the packed
    tokens; counts is a (G,) zero placeholder (the walk does not split its
    count by block); total_tokens and exit_entry are (1,) int32 tensors
    that stay on the device, so the next batch can take ``exit_entry`` as
    its ``entry0`` without a host round trip.  ``matcher`` names the match
    tables' finder (``ops.match.get_matcher``; K1 by default).
    """
    params = spec.Params(la=la, sb=sb)
    if params.width % 8 != 0:
        raise ValueError("fused pipeline requires byte-aligned token width")
    dev = device_lib.resolve(device)
    nb = params.width // 8

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
    )
    lox = parse_walk.build_lox(
        L.reshape(N), O.reshape(N), blocks.reshape(N), rights[G - 1], la
    )
    tokens, total, exit_e = parse_walk.walk_parse_pack(
        lox, entry0, int(valid_total),
        la=la, ob=params.off_bits, lb=params.len_bits, sub_block=sub_block,
    )
    payload = parse_walk.token_bytes(tokens, nb)
    return payload, torch.zeros(G, dtype=torch.int32, device=dev), total, exit_e


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
    """One fused device step, scan-parser variant (plain tensor code);
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


def _resolve_fused_config(
    params: spec.Params,
    n: int,
    block_size: int | None,
    sub_block: int | None,
    parser: str = "walk",
    matcher: str = match_ops.DEFAULT_MATCHER,
):
    """Shared knob resolution: (block_size, sub_block, parser) for an
    n-byte input.  ``sub_block`` is the walk's or the scan's; the merged
    kernel has its own fixed tile and takes none, and its own sweep: with
    any other matcher it raises (the JAX package quietly runs the walk
    there; this one has no quiet route switch)."""
    if params.width % 8 != 0:
        raise ValueError("fused pipeline requires byte-aligned token width")
    if parser not in PARSERS:
        raise ValueError(
            f"unknown parser {parser!r}; available: {', '.join(PARSERS)}"
        )
    if parser == "walk" and fused_walk.MERGED_DEFAULT:
        parser = "merged"
    if parser == "merged" and match_ops.route_matcher(matcher) != "sweep":
        raise ValueError(
            "parser 'merged' runs its own sweep (matcher 'sweep'); "
            f"matcher {matcher!r} runs with parser 'walk' or 'scan'"
        )
    if block_size is None:
        block_size = min(DEFAULT_BLOCK_SIZE, max(n, 1))
    if sub_block is None:
        sub_block = (DEFAULT_SCAN_SUB_BLOCK if parser == "scan"
                     else parse_walk.DEFAULT_SUB_BLOCK)
    if block_size < 1 or sub_block < 1:
        raise ValueError("block_size and sub_block must be positive")
    return block_size, sub_block, parser


def iter_batches_fused(
    x: np.ndarray,
    params: spec.Params,
    *,
    block_size: int | None = None,
    batch_blocks: int = DEFAULT_BATCH_BLOCKS,
    sub_block: int | None = None,
    parser: str = "walk",
    matcher: str = match_ops.DEFAULT_MATCHER,
    start_batch: int = 0,
    entry: int = 0,
    phases=None,
    stats=None,
    retries: int = 2,
    device: str | torch.device | None = None,
):
    """Yield (batch_index, e_in, e_out, token_count, payload_bytes) per batch.

    The fused device pipeline as a resumable iterator.  ``start_batch`` /
    ``entry`` resume mid-stream; payloads are byte-aligned token bytes (no
    header).  Two-deep software pipeline: batch k+1 is submitted before
    batch k is fetched, and the parse entry rides from batch to batch as a
    device tensor, so nothing on the dependency chain waits for the host.
    Launches are asynchronous: while the host stages and fetches, the one
    CUDA stream keeps working through what was submitted.

    ``parser`` names the batch step: ``"walk"`` (match sweep + walk kernel),
    ``"merged"`` (the one merged kernel; it never gives way to the walk) or
    ``"scan"`` (match sweep + the scan parser in plain tensor code).
    ``matcher`` names the walk's and the scan's match tables' finder
    (``ops.match.get_matcher``); ``"merged"`` takes only ``"sweep"``.
    """
    from . import codec as codec_model  # lazy: avoid import cycle

    dev = device_lib.resolve(device)
    n = x.shape[0]
    block_size, sub_block, parser = _resolve_fused_config(
        params, n, block_size, sub_block, parser, matcher
    )
    if parser == "merged":
        step = fused_walk.encode_batch_sweepwalk
    else:
        step = functools.partial(
            encode_batch_walk if parser == "walk" else encode_batch_device,
            sub_block=sub_block, matcher=matcher,
        )
    nb_bytes = params.width // 8
    B, G = block_size, batch_blocks
    H, R = params.d_limit, params.len_limit
    nblocks = -(-n // B)
    num_batches = -(-nblocks // G)
    if phases is None and stats is not None:
        phases = stats.phases
    ph = phases if phases is not None else metrics_lib.PhaseTimes()

    def submit(bi: int, entry_dev):
        g0 = bi * G
        gn = min(G, nblocks - g0)
        gb, gh, gr, ga, gv = codec_model._batch_inputs(
            x, n, g0, gn, gn, B, H, R
        )
        vt = min(gn * B, n - g0 * B)
        if stats is not None:
            stats.h2d_bytes += sum(a.nbytes for a in (gb, gh, gr, ga, gv))
        payload, _, total, exit_entry = step(
            gb, gh, gr, ga, gv, vt, entry_dev,
            la=params.la, sb=params.sb, device=dev,
        )
        return bi, payload, total, exit_entry

    def fetch(handle, e_in: int):
        bi, payload, total, exit_entry = handle
        with metrics_lib.StopwatchPhase(ph, "match"):
            tot, ex = torch.cat([total, exit_entry]).tolist()
            nbytes = tot * nb_bytes
            buf = payload[:nbytes].cpu().numpy().tobytes() if nbytes else b""
            if stats is not None:
                stats.d2h_bytes += nbytes + 8
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
    parser: str = "walk",
    matcher: str = match_ops.DEFAULT_MATCHER,
    device: str | torch.device | None = None,
) -> bytes:
    """Compress via the fused device pipeline (byte-aligned widths only).

    ``parser``: "walk" (match sweep + walk kernel, the default), "merged"
    (one kernel for match, parse and pack) or "scan" (match sweep + the
    plain-tensor scan parser); the three give one stream.  ``matcher``:
    any name of ``ops.match.get_matcher`` for the walk and the scan; the
    merged kernel runs its own sweep and refuses every other.
    """
    from . import codec as codec_model  # lazy: avoid import cycle

    params = params or spec.Params()
    dev = device_lib.resolve(device)
    x = np.frombuffer(data, dtype=np.uint8)
    n = x.shape[0]
    block_size, sub_block, parser = _resolve_fused_config(
        params, n, block_size, sub_block, parser, matcher
    )
    st = stats if stats is not None else codec_model.EncodeStats()
    st.input_bytes = n

    if n == 0:
        st.output_bytes = spec.HEADER_BYTES
        return bitio.header_bytes(params)

    parts: list[bytes] = [bitio.header_bytes(params)]
    total_tokens = 0
    with metrics_lib.StopwatchPhase(st.phases, "total"):
        for _, _, _, tok, payload in iter_batches_fused(
            x, params, block_size=block_size, batch_blocks=batch_blocks,
            sub_block=sub_block, parser=parser, matcher=matcher, stats=st,
            device=dev,
        ):
            total_tokens += tok
            if payload:
                parts.append(payload)
        st.tokens = total_tokens
        st.blocks = -(-n // block_size)
        stream = b"".join(parts)
        st.output_bytes = len(stream)
    return stream
