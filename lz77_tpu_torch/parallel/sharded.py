"""Block-parallel encode over a (data, win) mesh of devices.

The port of the JAX package's ``parallel.sharded``, with the same contract:
streams byte-identical to the serial host parse, for any mesh.

* :func:`sharded_match_fn` — the match phase of a batch split over the
  mesh, for ``models.codec.encode_bytes(match_fn=...)`` (the host-parse
  pipeline: the parse stays on the host, so its stream is unchanged).  The
  batch's rows go to the ``data`` axis in contiguous shards; with a ``win``
  axis each member of a shard searches one range of distances (K1 with
  ``d_lo``/``d_hi`` for ``sweep``, or the ranged form that the JAX
  package's ``_win_match`` picks for its matchers), and the members'
  tables meet on the shard's first member through a max over
  ``match.combine_key`` (the JAX package's ``lax.pmax``).
* :func:`make_sharded_walk_step` / :func:`iter_batches_sharded` /
  :func:`encode_bytes_sharded` — the device-resident pipeline: per shard
  the match, ``build_lox`` and the walk parse+pack (K2), the shards' walks
  chained through their entries.

One process drives the mesh (``parallel.mesh``).  It launches every
member's match before any walk, so that members on different cards
overlap, and then the walks in shard order: shard d's K2 takes shard
d - 1's exit entry, a (1,) tensor moved to its device and never read on the
host.  Every walk therefore starts from its true entry, and the JAX
package's speculative entry-0 walk, head-window resync and re-walk
(``_resync_shard``, ``_rewalk_span``, ``RESYNC_WINDOW``) have nothing to
do: a TPU mechanism (every shard's walk runs in one SPMD program, so none
can wait for its predecessor), not a contract.  ``resyncs``,
``resync_head_tokens`` and ``resync_bulk`` are 0 by construction.  K2 is a
small part of a batch's device time beside K1, so walking the shards in
turn costs little while their matches overlap.

Widths that are not byte multiples take K2's words as they are, fetched
once a batch and packed on the host by ``native.pack_tokens_phase`` with a
carried bit phase (the JAX package's ``_encode_bytes_sharded_xla``), at
the same stream: K2 writes compact words, so the stream needs neither
padded rows nor ``_compact_tokens``.

* :func:`make_sharded_exact_step` — the JAX package's exact entry-carried
  step: the same match and K2 walks, chained shard to shard through K2's
  exit, with K2's sub-block offsets turning each shard's compact words
  into padded ``(off, len, next)`` rows, per-block counts and the exit
  entry.  Where the JAX step all-gathers every shard's (la,) entry -> exit
  map and composes a prefix (one SPMD program, so no shard can wait for
  another), K2's scan already gives each block its true entry.
* :func:`make_sharded_pipeline_step` — the JAX package's block-aligned
  dry-run step: the sharded match, then every block parsed from entry 0
  with its lengths clamped at the block's end (``ops.parse``), padded
  ``(off, len, next, counts)`` per block.  Its stream is valid but not the
  reference parse's (blocks do not chain); no pipeline runs it.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import bitio, spec
from .. import native as native_lib
from ..ops import match as match_ops
from ..models import fused as fused_model
from ..ops import parse as parse_ops
from ..ops import parse_walk
from ..utils import metrics as metrics_lib
from . import mesh as mesh_lib


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _win_ranges(dlim: int, n_win: int) -> list[tuple[int, int | None]]:
    """The window axis's distance ranges ``[d_lo, d_hi)``, one a member:
    ``per = ceil(dlim / n_win)`` distances each, the last cut at dlim; the
    whole range (``(1, None)``) when the axis has one member."""
    if n_win == 1:
        return [(1, None)]
    per = _cdiv(max(dlim, 1), n_win)
    return [(1 + w * per, min(dlim + 1, 1 + (w + 1) * per))
            for w in range(n_win)]


def _matcher_for(matcher: str, n_win: int) -> str:
    """The canonical matcher name; ``chunk`` (K4) has no ranged form."""
    name = match_ops.route_matcher(matcher)
    if name == "chunk" and n_win > 1:
        raise ValueError(
            "matcher 'chunk' has no range of distances; a mesh with a win "
            "axis runs matcher 'sweep'"
        )
    return name


def _win_match(matcher: str, params: spec.Params, n_win: int):
    """(ranges, fn) of the window axis for a canonical matcher name, the
    ranged form the JAX package's ``_win_match`` picks: ``sweep`` is K1
    over its range; ``bitplane`` is ``find_matches_bitplane_range`` with
    the member span rounded up to 32, so that every member starts at
    1 (mod 32); ``brute``, ``sorted`` and ``chunked`` run
    ``find_matches_brute_range``.  ``fn(*inputs, d_lo, d_hi)`` -> (L, O)."""
    la, sb, dlim = params.la, params.sb, params.d_limit
    if matcher == "sweep":
        def fn(*inputs, d_lo, d_hi):
            return match_ops.match_sweep(*inputs, la=la, sb=sb, d_lo=d_lo,
                                         d_hi=d_hi)
        return _win_ranges(dlim, n_win), fn
    if matcher == "bitplane":
        from ..ops import bitplane

        span = -(-_cdiv(max(dlim, 1), n_win) // 32) * 32
        ranges = [(1 + w * span, min(dlim + 1, 1 + (w + 1) * span))
                  for w in range(n_win)]

        def fn(*inputs, d_lo, d_hi):
            return bitplane.find_matches_bitplane_range(
                *inputs, d_lo, d_hi, la=la, sb=sb, span=span)
        return ranges, fn

    def fn(*inputs, d_lo, d_hi):
        return match_ops.find_matches_brute_range(*inputs, d_lo, d_hi, la=la,
                                                  sb=sb)
    return _win_ranges(dlim, n_win), fn


def check_batch_blocks(G: int, n_data: int) -> None:
    """A batch of ``G`` blocks must split evenly over the ``data`` axis."""
    if G % n_data:
        raise ValueError(
            f"batch_blocks={G} must be a multiple of data-axis size {n_data}"
        )


_DTYPES = (torch.uint8, torch.uint8, torch.uint8, torch.int32, torch.int32)


def _match_shards(mesh, params: spec.Params, matcher: str, arrays,
                  shard_rows: int, stats=None):
    """Launch the match of every member of every shard, nothing else.

    ``arrays`` = (blocks, halos, rights, avails, valid_exts) of a batch
    (numpy or tensors); shard d holds rows ``[d * shard_rows, (d + 1) *
    shard_rows)`` cut at the batch.  Each member's rows are copied once to
    its device.  Returns one entry a shard: None for a shard with no rows,
    else (first row, inputs on the shard's first member, [(L, O) a
    member]).
    """
    n_data = mesh.shape[mesh_lib.DATA_AXIS]
    n_win = mesh.shape[mesh_lib.WIN_AXIS]
    find = match_ops.get_matcher(matcher)
    if n_win == 1:
        ranges = _win_ranges(params.d_limit, 1)
    else:
        ranges, ranged = _win_match(matcher, params, n_win)
    rows = arrays[0].shape[0]
    shards = []
    for d in range(n_data):
        r0, r1 = min(rows, d * shard_rows), min(rows, (d + 1) * shard_rows)
        if r0 == r1:
            shards.append(None)
            continue
        on = {}  # device -> the shard's inputs there
        parts = []
        for w, (d_lo, d_hi) in enumerate(ranges):
            dev = mesh.devices[d, w]
            if dev not in on:
                on[dev] = [
                    torch.as_tensor(a[r0:r1]).to(device=dev, dtype=dt)
                    .contiguous() for a, dt in zip(arrays, _DTYPES)
                ]
                if stats is not None:
                    stats.h2d_bytes += sum(
                        t.numel() * t.element_size() for t in on[dev])
            if n_win == 1:
                parts.append(find(*on[dev], la=params.la, sb=params.sb))
            else:
                parts.append(ranged(*on[dev], d_lo=d_lo, d_hi=d_hi))
        shards.append((r0, on[mesh.devices[d, 0]], parts))
    return shards


def _combine(parts, dev: torch.device, dlim: int):
    """One shard's (L, O) on ``dev`` from its members' partial tables: the
    max of their ``combine_key``s (the JAX package's ``lax.pmax``)."""
    if len(parts) == 1:
        return parts[0]
    keys = [match_ops.combine_key(L, O, dlim).to(dev) for L, O in parts]
    return match_ops.split_key(torch.amax(torch.stack(keys), dim=0), dlim)


def sharded_match_fn(mesh, params: spec.Params, *, matcher: str = "sweep"):
    """A ``match_fn`` for ``codec.encode_bytes`` sharded over ``mesh``.

    ``match_fn(gb, gh, gr, ga, gv) -> (L, O)``: the batch's G rows split
    into ``n_data`` contiguous shards of ``ceil(G / n_data)`` rows (a short
    last batch leaves the trailing shards empty); with a ``win`` axis each
    member sweeps one range of distances and the tables are combined.  The
    int32 (G, B) tables come back on the mesh's first device.
    ``match_fn.data_shards`` is ``n_data``: the host pipeline needs
    ``batch_blocks`` to be a multiple of it.  ``matcher``: any name of
    ``ops.match.get_matcher``, but ``chunk`` (K4) only on a mesh without a
    ``win`` axis.
    """
    n_data = mesh.shape[mesh_lib.DATA_AXIS]
    matcher = _matcher_for(matcher, mesh.shape[mesh_lib.WIN_AXIS])
    dlim = params.d_limit
    dev0 = mesh.devices[0, 0]

    def match_fn(gb, gh, gr, ga, gv):
        shards = _match_shards(mesh, params, matcher, (gb, gh, gr, ga, gv),
                               _cdiv(gb.shape[0], n_data))
        Ls, Os = [], []
        for d, shard in enumerate(shards):
            if shard is not None:
                L, O = _combine(shard[2], mesh.devices[d, 0], dlim)
                Ls.append(L.to(dev0))
                Os.append(O.to(dev0))
        return torch.cat(Ls), torch.cat(Os)

    match_fn.data_shards = n_data
    return match_fn


def make_sharded_pipeline_step(mesh, params: spec.Params, *,
                               matcher: str = "sweep"):
    """Block-aligned device step: blocks -> (off, len, next, counts).

    Returns ``step(blocks, halos, rights, avails, valid_exts)``: the G rows
    split over the ``data`` axis in shards of ``G / n_data`` (G must be a
    multiple of it), each shard's (L, O) from its members (ranged and
    combined with a ``win`` axis, as :func:`sharded_match_fn`), lengths
    clamped so that every token ends inside its block (``min(L, B - pos -
    1)``, as the parse always starts at entry 0), then per block the greedy
    parse from entry 0 and the token gather (``ops.parse``).  ``off``,
    ``len`` and ``next`` are (G, B) int32, the first ``counts[g]`` of row g
    its tokens; ``counts`` is (G,) int32; all on the mesh's first device.
    The stream they make is valid but not the reference parse's: only the
    entry-carried pipelines keep the size <= reference guarantee.
    """
    n_data = mesh.shape[mesh_lib.DATA_AXIS]
    matcher = _matcher_for(matcher, mesh.shape[mesh_lib.WIN_AXIS])
    la, dlim = params.la, params.d_limit
    dev0 = mesh.devices[0, 0]

    def step(blocks, halos, rights, avails, valid_exts):
        G, B = blocks.shape
        check_batch_blocks(G, n_data)
        shards = _match_shards(mesh, params, matcher,
                               (blocks, halos, rights, avails, valid_exts),
                               G // n_data)
        outs = []
        for d, (_, inputs, parts) in enumerate(shards):
            dev = mesh.devices[d, 0]
            L, O = _combine(parts, dev, dlim)
            pos = torch.arange(B, dtype=torch.int32, device=dev)
            L = torch.clamp(torch.minimum(L, B - pos - 1), min=0)
            blk, rgt, vext = inputs[0], inputs[2], inputs[4]
            for i in range(L.shape[0]):
                vl = torch.clamp(vext[i], max=B)
                starts, count, _ = parse_ops.greedy_parse(L[i], vl, 0, la=la)
                off, ln, nxt = parse_ops.gather_tokens(
                    starts, vl, L[i], O[i], torch.cat([blk[i], rgt[i]]),
                    la=la)
                outs.append([t.to(dev0) for t in (off, ln, nxt,
                                                   count.reshape(1))])
        off, ln, nxt, counts = (torch.stack([o[k] for o in outs])
                                for k in range(4))
        return off, ln, nxt, counts.reshape(G)

    return step


def exact_sub_block(B: int) -> int:
    """The exact step's K2 sub-block for blocks of ``B`` bytes: the largest
    divisor of B that is at most ``parse_walk.DEFAULT_SUB_BLOCK``, so that
    every block starts a sub-block.  A block size with no divisor near it
    (a prime) drives it down to 1: right, but K2 then scans B maps a
    block."""
    for s in range(min(B, parse_walk.DEFAULT_SUB_BLOCK), 0, -1):
        if B % s == 0:
            return s
    raise ValueError(f"block size {B} must be positive")


def _unpack_rows(tok, count, offsets, k: int, nvb: int, rows: int, B: int):
    """One shard's K2 words -> padded (off, len, next, counts) rows.

    ``tok`` (N,) int32 holds the shard's ``count`` token words
    ``off | len<<16 | next<<24``, block after block; ``offsets`` are K2's
    sub-block offsets, ``k`` sub-blocks a block, so block g's first token
    is word ``offsets[g * k]``.  Its first ``nvb`` of ``rows`` blocks hold
    valid bytes; the rest have count 0.  Row g's first ``counts[g]``
    entries are its tokens, the rest 0 (``off`` is 0 where ``len`` is 0,
    as every matcher's table has it)."""
    dev = tok.device
    first = torch.zeros(rows, dtype=torch.int64, device=dev)
    counts = torch.zeros(rows, dtype=torch.int32, device=dev)
    if nvb:
        first[:nvb] = offsets[: (nvb - 1) * k + 1 : k]
        counts[:nvb] = torch.diff(first[:nvb], append=count.to(torch.int64))
    col = torch.arange(B, dtype=torch.int64, device=dev)
    src = torch.clamp(first[:, None] + col, max=max(tok.shape[0] - 1, 0))
    w = torch.where(col < counts[:, None], tok[src], 0)
    return w & 0xFFFF, (w >> 16) & 0xFF, (w >> 24) & 0xFF, counts


def make_sharded_exact_step(mesh, params: spec.Params, *,
                            matcher: str = "sweep"):
    """Sharded device step with the exact entry-carried parse.

    Returns ``step(blocks, halos, rights, avails, valid_exts, entry0) ->
    (off, ln, nxt, counts, exit_entry)``.  ``blocks`` (G, B) uint8,
    ``halos`` (G, d_limit), ``rights`` (G, la-1), ``avails`` and
    ``valid_exts`` (G,) int32, as numpy arrays or tensors; ``entry0`` an int
    or an int32 tensor, clipped to [0, la-1].  The rows go to the ``data``
    axis in shards of ``G / n_data`` (G must be a multiple of it); each
    shard's (L, O) comes from its members (ranged and combined with a
    ``win`` axis, as :func:`sharded_match_fn`), and K2 walks the shard's
    span from the exit of the shard before it, a device tensor never read
    on the host.  K2 runs at ``ob = 16, lb = 8`` with a sub-block that
    divides B (:func:`exact_sub_block`), so its sub-block offsets give
    every block's first token and count.  ``off``, ``ln`` and ``nxt`` are
    (G, B) int32: row g's first ``counts[g]`` entries are block g's tokens
    of the serial parse from the block's true entry, the rest 0; ``counts``
    is (G,) int32 and ``exit_entry`` a 0-d int32 tensor, the entry into the
    next batch; all on the mesh's first device.  A shard with no valid
    bytes passes its entry through with zero rows.

    The rows must be consecutive blocks of one input staged as
    ``codec._batch_inputs`` stages them, a valid prefix: full rows
    (``valid_exts >= B``), at most one short row, then empty ones.  K2
    walks a shard as one span, so a short row followed by a non-empty one
    raises ``ValueError`` (the JAX step gives each block its own valid
    length).  ``valid_exts`` is read on the host: a CUDA tensor costs one
    sync.  ``matcher``: any name of ``ops.match.get_matcher`` (``sweep``,
    K1, by default), ``chunk`` (K4) only without a ``win`` axis.
    """
    n_data = mesh.shape[mesh_lib.DATA_AXIS]
    matcher = _matcher_for(matcher, mesh.shape[mesh_lib.WIN_AXIS])
    la, dlim = params.la, params.d_limit
    dev0 = mesh.devices[0, 0]

    def step(blocks, halos, rights, avails, valid_exts, entry0):
        G, B = blocks.shape
        check_batch_blocks(G, n_data)
        vls = np.clip(torch.as_tensor(valid_exts).cpu().numpy()
                      .astype(np.int64), 0, B)
        short = np.flatnonzero(vls < B)
        if short.size and vls[short[0] + 1:].any():
            raise ValueError(
                f"block {short[0]} holds {vls[short[0]]} of {B} valid bytes "
                "and a later block holds more: the exact step takes a valid "
                "prefix (full blocks, at most one short one, then empty ones)"
            )
        sub = exact_sub_block(B)
        k = B // sub
        rows = G // n_data
        shards = _match_shards(mesh, params, matcher,
                               (blocks, halos, rights, avails, valid_exts),
                               rows)
        entry = torch.as_tensor(entry0).reshape(1).clamp(0, la - 1).to(
            torch.int32)
        outs = []
        for d, (r0, inputs, parts) in enumerate(shards):
            dev = mesh.devices[d, 0]
            shard_vls = vls[r0 : r0 + rows]
            vt = int(shard_vls.sum())
            if vt == 0:
                z = torch.zeros((rows, B), dtype=torch.int32, device=dev0)
                outs.append((z, z, z, torch.zeros(rows, dtype=torch.int32,
                                                  device=dev0)))
                continue
            L, O = _combine(parts, dev, dlim)
            blk, rgt = inputs[0], inputs[2]
            N = blk.numel()
            lox = parse_walk.build_lox(
                L.reshape(N), O.reshape(N), blk.reshape(N), rgt[-1], la)
            tok, cnt, entry, _, offsets = parse_walk.walk_parse_pack(
                lox, entry.to(dev), vt, la=la, ob=16, lb=8, sub_block=sub,
                sub_blocks=True)
            outs.append(tuple(
                t.to(dev0) for t in _unpack_rows(
                    tok, cnt, offsets, k, int((shard_vls > 0).sum()), rows,
                    B)))
        off, ln, nxt, counts = (torch.cat([o[i] for o in outs])
                                for i in range(4))
        return off, ln, nxt, counts, entry.to(dev0).reshape(())

    return step


def make_sharded_walk_step(mesh, params: spec.Params, *,
                           matcher: str = "sweep",
                           sub_block: int | None = None):
    """The device-resident sharded step: match + LOX + walk per shard.

    Returns ``step(blocks, halos, rights, avails, valid_exts, valid_total,
    entry_dev, *, shard_rows=None) -> (words_by_shard, counts, exits)``.
    The batch's rows go to ``n_data`` contiguous shards of ``shard_rows``
    rows (default ``ceil(rows / n_data)``).  Each shard runs its match on
    its members (ranged and combined with a ``win`` axis), ``build_lox``
    and K2 on its first member's device, from the exit entry of the shard
    before it (the first from ``entry_dev``).  For each shard: its (N,)
    int32 token words (the first ``count`` are its tokens), its (1,) count
    and its (1,) exit, all left on its device; a shard with no valid bytes
    (no rows, or padded rows past ``valid_total``) has None for words and
    count and passes its entry through as its exit.
    Every member's match is launched before any walk.
    """
    n_data = mesh.shape[mesh_lib.DATA_AXIS]
    matcher = _matcher_for(matcher, mesh.shape[mesh_lib.WIN_AXIS])
    la, dlim = params.la, params.d_limit
    sub_block = sub_block or parse_walk.DEFAULT_SUB_BLOCK

    def step(blocks, halos, rights, avails, valid_exts, valid_total,
             entry_dev, *, shard_rows=None, stats=None):
        rows, B = blocks.shape
        shards = _match_shards(
            mesh, params, matcher, (blocks, halos, rights, avails, valid_exts),
            shard_rows or _cdiv(rows, n_data), stats,
        )
        entry = torch.as_tensor(entry_dev, dtype=torch.int32).reshape(1)
        words, counts, exits = [], [], []
        for d, shard in enumerate(shards):
            dev = mesh.devices[d, 0]
            vt = 0 if shard is None else min(
                shard[1][0].numel(), int(valid_total) - shard[0] * B)
            if vt <= 0:
                words.append(None)
                counts.append(None)
                exits.append(entry)
                continue
            r0, inputs, parts = shard
            L, O = _combine(parts, dev, dlim)
            sb_rows, rgt = inputs[0], inputs[2]
            N = sb_rows.numel()
            lox = parse_walk.build_lox(
                L.reshape(N), O.reshape(N), sb_rows.reshape(N), rgt[-1], la)
            tok, cnt, entry = parse_walk.walk_parse_pack(
                lox, entry.to(dev), vt, la=la, ob=params.off_bits,
                lb=params.len_bits, sub_block=sub_block,
            )
            words.append(tok)
            counts.append(cnt)
            exits.append(entry)
        return words, counts, exits

    return step


def _iter_sharded(x, params, *, mesh, block_size, batch_blocks, matcher,
                  sub_block, start_batch, entry, stats, retries, phases,
                  as_words):
    """The sharded walk pipeline as a resumable iterator: yields
    (batch_index, e_in, e_out, token_count, out), ``out`` the batch's token
    bytes (``as_words=False``, byte-aligned widths) or its int32 token words
    (numpy)."""
    from ..models import codec as codec_model  # lazy: avoid import cycle

    n_data = mesh.shape[mesh_lib.DATA_AXIS]
    B, G = block_size, batch_blocks
    check_batch_blocks(G, n_data)
    n = x.shape[0]
    H, R = params.d_limit, params.len_limit
    nblocks = _cdiv(n, B)
    num_batches = _cdiv(nblocks, G)
    step = make_sharded_walk_step(mesh, params, matcher=matcher,
                                  sub_block=sub_block)
    nb_bytes = params.width // 8
    dev0 = mesh.devices[0, 0]
    if phases is None and stats is not None:
        phases = stats.phases
    ph = phases if phases is not None else metrics_lib.PhaseTimes()

    def submit(bi: int, entry_dev):
        g0 = bi * G
        gn = min(G, nblocks - g0)
        arrs = codec_model._batch_inputs(x, n, g0, gn, gn, B, H, R)
        vt = min(gn * B, n - g0 * B)
        # a short last batch fills the leading shards of G / n_data rows,
        # as the JAX package's padded batch does
        words, counts, exits = step(*arrs, vt, entry_dev,
                                    shard_rows=G // n_data, stats=stats)
        return bi, words, counts, exits[-1]

    def fetch(handle, e_in: int):
        bi, words, counts, exit_dev = handle
        with metrics_lib.StopwatchPhase(ph, "match"):
            live = [d for d in range(n_data) if counts[d] is not None]
            # one round trip for every shard's count and the batch's exit
            head = torch.cat([counts[d].to(dev0) for d in live]
                             + [exit_dev.to(dev0)]).tolist()
            cs, ex = head[:-1], head[-1]
            pieces = [words[d][:c] if as_words
                      else parse_walk.token_bytes(words[d][:c], nb_bytes)
                      for d, c in zip(live, cs) if c]
            buf = (torch.cat([p.to(dev0) for p in pieces]).cpu().numpy()
                   if pieces else np.zeros(0, np.int32 if as_words
                                           else np.uint8))
            if stats is not None:
                stats.d2h_bytes += buf.nbytes + 4 * len(head)
                stats.shards += len(live)
        return bi, e_in, ex, sum(cs), buf if as_words else buf.tobytes()

    yield from fused_model.two_deep(
        submit, fetch, range(start_batch, num_batches), entry, device=dev0,
        phases=ph, stats=stats, retries=retries)


def iter_batches_sharded(
    x: np.ndarray,
    params: spec.Params,
    *,
    mesh,
    block_size: int,
    batch_blocks: int,
    matcher: str = "sweep",
    sub_block: int | None = None,
    start_batch: int = 0,
    entry: int = 0,
    stats=None,
    retries: int = 2,
    phases=None,
):
    """Yield (batch_index, e_in, e_out, token_count, payload_bytes) per batch.

    The device-resident sharded walk pipeline as a resumable iterator (the
    building block of ``encode_bytes_sharded`` and the manifest/file path),
    byte-aligned token widths only.  Two-deep, like
    ``models.fused.iter_batches_fused``: batch k+1 is submitted before batch
    k is fetched, and the entry rides from batch to batch as a device
    tensor.  The last batch sends only its real blocks.  ``stats`` (an
    ``EncodeStats``) counts ``shards`` (shards with valid bytes), the
    retries and the bytes moved each way; its resync counters stay 0.
    """
    if params.width % 8 != 0:
        raise ValueError("sharded walk pipeline requires byte-aligned width")
    return _iter_sharded(
        x, params, mesh=mesh, block_size=block_size,
        batch_blocks=batch_blocks, matcher=matcher, sub_block=sub_block,
        start_batch=start_batch, entry=entry, stats=stats, retries=retries,
        phases=phases, as_words=False,
    )


def resolve_mesh(mesh=None, device=None):
    """``mesh`` as given, else a one-member mesh on ``device``, else every
    visible card on the ``data`` axis; both at once is a TypeError."""
    if mesh is not None and device is not None:
        raise TypeError("pass a mesh or a device, not both")
    if mesh is not None:
        return mesh
    if device is not None:
        return mesh_lib.make_mesh(devices=[device])
    return mesh_lib.make_mesh()


def encode_bytes_sharded(
    data: bytes,
    params: spec.Params | None = None,
    *,
    mesh=None,
    block_size: int | None = None,
    batch_blocks: int | None = None,
    matcher: str = "sweep",
    stats=None,
    device=None,
) -> bytes:
    """Compress via the sharded device pipeline; stream == serial host parse.

    Blocks are sharded over the mesh's ``data`` axis (``batch_blocks``
    defaults to its size).  Byte-aligned widths write the token bytes of
    K2's words; other widths fetch the words once a batch and pack them
    with ``native.pack_tokens_phase``, carrying the bit phase.  ``mesh=None``
    is every visible card (``parallel.mesh.make_mesh()``), or a one-member
    mesh on ``device`` when one is given.
    """
    from ..models import codec as codec_model  # lazy: avoid import cycle

    params = params or spec.Params()
    mesh = resolve_mesh(mesh, device)
    n_data = mesh.shape[mesh_lib.DATA_AXIS]
    G = batch_blocks or n_data
    check_batch_blocks(G, n_data)
    _matcher_for(matcher, mesh.shape[mesh_lib.WIN_AXIS])
    x = np.frombuffer(data, dtype=np.uint8)
    n = x.shape[0]
    B = block_size or min(codec_model.DEFAULT_BLOCK_SIZE, max(n, 1))
    if B < 1:
        raise ValueError("block_size must be positive")
    st = stats if stats is not None else codec_model.EncodeStats()
    st.input_bytes = n
    if n == 0:
        st.output_bytes = spec.HEADER_BYTES
        return bitio.header_bytes(params)

    aligned = params.width % 8 == 0
    out = bytearray(bitio.header_bytes(params))
    bitpos = spec.HEADER_BITS
    total_tokens = 0
    ob, lb = params.off_bits, params.len_bits
    with metrics_lib.StopwatchPhase(st.phases, "total"):
        for _, _, _, tok, got in _iter_sharded(
            x, params, mesh=mesh, block_size=B, batch_blocks=G,
            matcher=matcher, sub_block=None, start_batch=0, entry=0,
            stats=st, retries=2, phases=None, as_words=not aligned,
        ):
            total_tokens += tok
            if aligned:
                out += got
            elif tok:
                with metrics_lib.StopwatchPhase(st.phases, "pack"):
                    buf, bits = native_lib.pack_tokens_phase(
                        got & ((1 << ob) - 1), (got >> ob) & ((1 << lb) - 1),
                        (got >> (ob + lb)) & 0xFF, params, bitpos % 8,
                    )
                    if bitpos % 8:
                        out[-1] |= int(buf[0])
                        out += buf[1:].tobytes()
                    else:
                        out += buf.tobytes()
                    bitpos += bits
        st.tokens = total_tokens
        st.blocks = _cdiv(n, B)
        stream = bytes(out)
        st.output_bytes = len(stream)
    return stream
