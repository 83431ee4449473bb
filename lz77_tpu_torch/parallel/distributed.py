"""Multi-process encode over ``torch.distributed`` (SURVEY.md §7 phase 3).

The port of the JAX package's ``parallel.distributed``, with its contract:
every process encodes one contiguous range of blocks, and the stream is
byte-identical to the single-process encoder's for every process count,
token width and route.

* :func:`initialize` sets up the process group on **Gloo**.  Everything the
  processes exchange is a small host array (entry maps, token counts,
  payload sizes, partial bytes) or a rank's payload bytes, all CPU tensors;
  Gloo also lets several ranks share one card, which NCCL refuses.
* Blocks need only raw input bytes (halo + right extension), so ranks share
  nothing while they match.  The greedy parse's serial entry chain is
  resolved without serialising the ranks: a token overhangs a block by at
  most la-1 bytes, so each rank computes its range's entry -> exit map for
  all la entries, one allgather shares the maps, and every rank composes
  the prefix to learn its true entry.
* Global bit offsets are affine in the token counts (``32 + width *
  cumsum(counts)``), so every rank knows where its payload lands.

Two range encoders (``pipeline``; ``auto`` is ``fused`` for byte-aligned
widths and ``host`` otherwise, by the width alone):

* ``host`` (:func:`_encode_range`): the match on the rank's device (K1 for
  matcher ``sweep``, K4 for ``chunk``, or any other matcher name of
  ``ops.match.get_matcher``) with nibble-packed lengths fetched
  and offsets left on the device; la native walks give the map; after the
  allgather the final parse, the offsets gathered at its starts, and the
  tokens kept as int32 words, packed by ``native.pack_tokens_phase`` once
  the rank's bit phase is known.
* ``fused`` (:func:`_encode_range_fused`): a speculative entry-0 pass
  through ``models.fused.encode_batch_device(with_map=True)`` (the
  matcher, K1 by default, and the scan parser), whose composed (la,) map
  is exact for any entry; a nonzero
  true entry is fixed by a head-window splice where the two parses meet,
  and by an exact re-run of the range where they never do.

Payloads: :func:`encode_bytes_multihost` broadcasts each rank's exact-size
payload in rank order to rank 0; :func:`encode_file_multihost` has every
rank write its own segment of the shared output at its byte offset, from a
per-rank scratch file, so a rank holds about one batch and one chunk of
payload whatever its range.  Where the JAX module differs, this one does
so by decision:

* ``torch.distributed`` on Gloo in place of ``jax.distributed`` and
  ``multihost_utils``; the group has a finite timeout, so a dead peer fails
  the run.
* Each rank runs on its own device: ``device=None`` is ``cuda:{rank %
  device_count}`` (raises without a card), anything else is used as given.
* The default matcher is ``sweep`` (K1), where the JAX module's is its
  XLA ``chunked``; both routes take every matcher name, ``chunked``
  included.
* A width that is not a byte multiple keeps token words (4 B a token), not
  one byte a bit.
* The solo fast path is ``codec.encode_bytes`` with only what the chosen
  pipeline takes; a ``fault_injector`` keeps the distributed code, whose
  injector counts blocks (batch starts), as in the JAX module.

Run ranks by hand (each process calls :func:`initialize`) or through
:func:`launch`, which starts local ranks of this module's command line::

    python -m lz77_tpu_torch.parallel.distributed -i IN -o OUT.lz --nproc 2
        [-l 15] [-s 4095] [--mode file|bytes] [--pipeline auto|host|fused]
        [--matcher NAME] [--device cuda|cpu]

It prints one JSON line per rank and one for the run.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import resource
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import _build, bitio, spec
from .. import device as device_lib
from .. import native as native_lib
from ..models import codec as codec_model
from ..models import encoder as encoder_model
from ..models import fused as fused_model
from ..ops import match as match_ops
from ..utils import faults as faults_lib

RESYNC_WINDOW = 8192  # head match-table span for the cross-rank splice
GROUP_TIMEOUT_S = 300  # a collective that waits longer fails the run
COPY_TOKENS = 1 << 20  # tokens a rank copies into the output at a time


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """Join the Gloo process group at ``tcp://coordinator_address``
    (``host:port``, served by rank 0); a no-op for a solo run."""
    if num_processes is None or num_processes <= 1:
        return
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S),
    )


def process_count() -> int:
    """Processes in the group; 1 when none is initialised."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank; 0 when no group is initialised."""
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device=None) -> torch.device:
    """The rank's device: ``device`` through the device rule, or for None
    ``cuda:{rank % device_count}`` (raises without a card)."""
    if device is not None:
        return device_lib.resolve(device)
    device_lib.resolve("cuda")
    return torch.device("cuda", process_index() % torch.cuda.device_count())


def block_range(num_blocks: int, num_processes: int, process_id: int):
    """Contiguous near-even split of blocks over processes."""
    base, extra = divmod(num_blocks, num_processes)
    lo = process_id * base + min(process_id, extra)
    hi = lo + base + (1 if process_id < extra else 0)
    return lo, hi


def global_bit_offsets(counts: np.ndarray, width: int) -> np.ndarray:
    """Bit offset of each block's payload in the final stream (affine)."""
    return spec.HEADER_BITS + width * np.concatenate(
        [[0], np.cumsum(counts.astype(np.int64))[:-1]]
    )


class _Comm:
    """The collectives of one call over the default group (identities in a
    world of one), with the seconds spent in them."""

    def __init__(self):
        self.size = process_count()
        self.rank = process_index()
        self.seconds = 0.0

    def allgather(self, a) -> np.ndarray:
        """(size, *a.shape) int64: every rank's ``a``, in rank order."""
        t0 = time.perf_counter()
        t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64))
        if self.size == 1:
            out = t.numpy()[None]
        else:
            got = [torch.empty_like(t) for _ in range(self.size)]
            dist.all_gather(got, t)
            out = torch.stack(got).numpy()
        self.seconds += time.perf_counter() - t0
        return out

    def broadcast(self, buf: np.ndarray | None, nbytes: int, src: int):
        """Rank ``src``'s ``nbytes`` uint8 ``buf``, on every rank."""
        t0 = time.perf_counter()
        t = (torch.from_numpy(buf) if self.rank == src
             else torch.empty(nbytes, dtype=torch.uint8))
        if self.size > 1:
            dist.broadcast(t, src)
        self.seconds += time.perf_counter() - t0
        return t.numpy()

    def barrier(self) -> None:
        t0 = time.perf_counter()
        if self.size > 1:
            dist.barrier()
        self.seconds += time.perf_counter() - t0


class _Spool:
    """A rank's range payload in order, in memory or in a scratch file:
    token bytes (``dtype`` uint8, ``width / 8`` a token) or token words
    (uint32, one a token).  ``close`` deletes the scratch file."""

    def __init__(self, dtype, per_token: int, path: str | None = None):
        self.dtype = np.dtype(dtype)
        self.per_token = per_token
        self.path = path
        self.tokens = 0
        self._mem = bytearray()
        self._f = open(path, "w+b") if path else None

    def write(self, a: np.ndarray) -> None:
        raw = np.ascontiguousarray(a, self.dtype).tobytes()
        if self._f is None:
            self._mem += raw
        else:
            self._f.write(raw)
        self.tokens += a.shape[0] // self.per_token

    def reset(self) -> None:
        self.tokens = 0
        if self._f is None:
            self._mem = bytearray()
        else:
            self._f.seek(0)
            self._f.truncate()

    def read(self, t0: int, count: int) -> np.ndarray:
        """Tokens ``[t0, t0 + count)`` as items of ``dtype``."""
        size = self.dtype.itemsize * self.per_token
        if self._f is None:
            raw = bytes(self._mem[t0 * size : (t0 + count) * size])
        else:
            self._f.flush()
            raw = os.pread(self._f.fileno(), count * size, t0 * size)
        return np.frombuffer(raw, self.dtype)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
            os.unlink(self.path)


class _Range:
    """A rank's encoded range: token counts over ALL blocks (its own filled
    in) and its payload, which starts with ``head`` (the splice's tokens)
    and goes on with ``spool``'s tokens from ``skip``."""

    def __init__(self, counts, spool, head=None, skip=0):
        self.counts = counts
        self.spool = spool
        self.head = head if head is not None else np.zeros(0, spool.dtype)
        self.skip = skip

    @property
    def tokens(self) -> int:
        return self.head.shape[0] // self.spool.per_token + (
            self.spool.tokens - self.skip)

    def chunks(self, tokens: int = COPY_TOKENS):
        """The payload's items, at most ``tokens`` tokens a chunk."""
        if self.head.shape[0]:
            yield self.head
        for t0 in range(self.skip, self.spool.tokens, tokens):
            yield self.spool.read(t0, min(tokens, self.spool.tokens - t0))


def _pack(items: np.ndarray, params: spec.Params, phase: int):
    """(bytes, bits) of a chunk at bit ``phase``: token bytes as they are
    (phase 0), token words packed by ``native.pack_tokens_phase``."""
    if items.dtype == np.uint8:
        return items, items.shape[0] * 8
    ob, lb = params.off_bits, params.len_bits
    w = items.astype(np.int64)
    return native_lib.pack_tokens_phase(
        w & ((1 << ob) - 1), (w >> ob) & ((1 << lb) - 1),
        (w >> (ob + lb)) & 0xFF, params, phase,
    )


def _token_words(off, ln, nxt, params: spec.Params) -> np.ndarray:
    ob, lb = params.off_bits, params.len_bits
    return (off.astype(np.int64) | (ln.astype(np.int64) << ob)
            | (nxt.astype(np.int64) << (ob + lb))).astype(np.uint32)


def _parse_range(Ls, vls, entry: int):
    """Chain the per-block parse across a range from ``entry``."""
    all_starts = []
    for L, vl in zip(Ls, vls):
        starts, exit_pos = native_lib.parse_block(L, vl, entry)
        all_starts.append(starts)
        entry = max(0, exit_pos - L.shape[0])
    return all_starts, entry


class _Work:
    """Wall and CPU seconds of the work regions (collectives outside)."""

    def __init__(self):
        self.wall = self.cpu = 0.0

    def __enter__(self):
        self._t = (time.perf_counter(), time.process_time())
        return self

    def __exit__(self, *exc):
        self.wall += time.perf_counter() - self._t[0]
        self.cpu += time.process_time() - self._t[1]
        return False


def _encode_range(x, n, params, *, block_size, batch_blocks, matcher,
                  retries, fault_injector, spool, device, comm, stats,
                  work, release) -> _Range:
    """The host route for this rank's block range (any token width)."""
    matcher = match_ops.route_matcher(matcher)
    la = params.la
    B = codec_model._host_block_size(block_size, n)
    nb = -(-n // B) if n else 0
    lo, hi = block_range(nb, comm.size, comm.rank)
    G = batch_blocks
    H, R = params.d_limit, params.len_limit

    def count_retry():
        stats.retries += 1

    with work:
        # Phase 1: match tables for my range on my device; the lengths come
        # to the host (half a byte a position for la <= 16), the offsets
        # stay on the device until the final parse picks its starts.  A
        # failed batch is retried: blocks are independent (SURVEY.md §5).
        Ls: list[np.ndarray] = []
        vls: list[int] = []
        O16s = []
        for g0 in range(lo, hi, G):
            gn = min(G, hi - g0)

            def run_batch(g0=g0, gn=gn):
                if fault_injector is not None:
                    fault_injector.check(g0)
                arrs = codec_model._batch_inputs(x, n, g0, gn, gn, B, H, R)
                packed, O16 = encoder_model.match_blocks_compact(
                    *(torch.from_numpy(a).to(device) for a in arrs),
                    la=la, sb=params.sb, matcher=matcher,
                )
                stats.h2d_bytes += sum(a.nbytes for a in arrs)
                return packed.cpu().numpy(), O16

            packed, O16 = faults_lib.with_retries(
                run_batch, retries=retries, on_retry=count_retry)
            stats.d2h_bytes += packed.nbytes
            O16s.append(O16)
            for i in range(gn):
                Ls.append(encoder_model.unpack_lengths(packed[i], B, la))
                vls.append(min(B, n - (g0 + i) * B))
            release((g0 + gn) * B)

        # Phase 2: entry -> exit map of my range, one walk per entry.
        exits = np.array([_parse_range(Ls, vls, e)[1] for e in range(la)],
                         np.int64)
    all_exits = comm.allgather(exits)
    entry = 0
    for h in range(comm.rank):
        entry = int(all_exits[h][entry])

    with work:
        # Phase 3: the final parse from my true entry; offsets gathered on
        # the device at its starts; token words to the spool.
        counts = np.zeros(nb, np.int64)
        starts_list, _ = _parse_range(Ls, vls, entry)
        for bi, g0 in enumerate(range(lo, hi, G)):
            k0 = g0 - lo
            batch = starts_list[k0 : k0 + G]
            for i, s in enumerate(batch):
                counts[g0 + i] = s.shape[0]
            if not sum(s.shape[0] for s in batch):
                continue
            flat = np.concatenate(
                [i * B + s for i, s in enumerate(batch)]).astype(np.int32)
            off = encoder_model.gather_offsets(
                O16s[bi], torch.from_numpy(flat).to(device)).cpu().numpy()
            O16s[bi] = None
            stats.h2d_bytes += flat.nbytes
            stats.d2h_bytes += off.nbytes
            ln = np.concatenate([Ls[k0 + i][s] for i, s in enumerate(batch)])
            nxt = x[g0 * B + flat.astype(np.int64) + ln]
            spool.write(_token_words(off, ln, nxt, params))
    return _Range(counts, spool)


def _encode_range_fused(x, n, params, *, block_size, batch_blocks, matcher,
                        retries, fault_injector, spool, device, comm, stats,
                        work, release) -> _Range:
    """The fused route for this rank's block range (byte-aligned widths).

    The range parses SPECULATIVELY from entry 0 on the device (the entry
    riding between batches as a (1,) device tensor), fetching the packed
    payload (width / 8 bytes a token) instead of match tables; the EXACT
    (la,) entry -> exit map of the whole range falls out of the scan
    parser's sub-block map composition, so one allgather gives every rank
    its true entry with no merge assumption.  A nonzero true entry is fixed
    by a head-window splice (greedy chains from different entries merge at
    the first shared token start, the native MT encoder's property,
    lz77host.cpp:269-528); where they never meet, the range is re-run from
    the true entry, exactly.
    """
    la = params.la
    nb_bytes = params.width // 8
    B = block_size
    nb = -(-n // B) if n else 0
    lo, hi = block_range(nb, comm.size, comm.rank)
    G = batch_blocks
    H, R = params.d_limit, params.len_limit
    span_end = min(hi * B, n)
    my_span = max(0, span_end - lo * B)

    def submit(g0: int, entry_dev):
        if fault_injector is not None:
            fault_injector.check(g0)
        # Stage real blocks PAST the range end for a ragged final batch: a
        # token starting before span_end may overhang into the next rank's
        # bytes, and its next-byte gather reads the staged block space.
        # valid_total caps token starts at the range end, so the extra
        # blocks emit nothing.
        gn_stage = min(G, nb - g0)
        arrs = codec_model._batch_inputs(x, n, g0, gn_stage, gn_stage, B, H,
                                         R)
        stats.h2d_bytes += sum(a.nbytes for a in arrs)
        payload, counts_b, total, exit_e, bmap, lh, oh = (
            fused_model.encode_batch_device(
                *arrs, min(gn_stage * B, span_end - g0 * B), entry_dev,
                la=la, sb=params.sb, with_map=True, head_w=RESYNC_WINDOW,
                matcher=matcher, device=device,
            ))
        return g0, payload, counts_b, total, bmap, lh, oh, exit_e

    def fetch(handle, e_in: int):
        g0, payload, counts_b, total, bmap, lh, oh, exit_e = handle
        small = torch.cat([total, exit_e, bmap, counts_b]).cpu().numpy()
        tot, ex = int(small[0]), int(small[1])
        buf = (payload[: tot * nb_bytes].cpu().numpy() if tot
               else np.zeros(0, np.uint8))
        head = ((lh.cpu().numpy(), oh.cpu().numpy()) if g0 == lo else None)
        stats.d2h_bytes += small.nbytes + buf.nbytes + (
            head[0].nbytes + head[1].nbytes if head else 0)
        return (g0, e_in, ex, tot, buf, small[2 : 2 + la].astype(np.int64),
                small[2 + la :], head)

    def run_range(entry0: int):
        """Speculative (or exact, once the entry is known) range encode."""
        spool.reset()
        counts = np.zeros(nb, np.int64)
        cum_map = np.arange(la, dtype=np.int64)
        head = None
        for g0, _, _, _, buf, bmap, cnt, hd in fused_model.two_deep(
                submit, fetch, range(lo, hi, G), entry0, device=device,
                phases=stats.phases, stats=stats, retries=retries):
            gn = min(G, hi - g0)
            spool.write(buf)
            counts[g0 : g0 + gn] = cnt[:gn]
            cum_map = bmap[cum_map]
            head = head or hd
            release((g0 + gn) * B)
        return counts, cum_map, head

    with work:
        counts, cum_map, head = run_range(0)

    # One collective: the exact (la,) range maps -> my true entry.
    all_maps = comm.allgather(cum_map)
    entry = 0
    for h in range(comm.rank):
        entry = int(all_maps[h][entry])

    with work:
        if entry == 0 or my_span == 0:
            return _Range(counts, spool)
        stats.resyncs += 1
        # w_eff <= B keeps the splice inside block ``lo`` (the counts
        # adjustment below touches only that block's token count).
        w_eff = min(RESYNC_WINDOW, my_span, B)
        if my_span > w_eff:
            # True-entry parse over the head window; speculative starts
            # from the payload's leading tokens (each token covers >= 1
            # byte, so w_eff tokens always span the window).
            Lh = head[0][:w_eff].astype(np.uint8)
            Oh = head[1][:w_eff]
            starts, _ = native_lib.parse_block(Lh, w_eff, entry)
            k = min(spool.tokens, w_eff)
            _, len0, _ = native_lib.unpack_tokens(spool.read(0, k), params)
            s0_all = np.concatenate(
                [[0], np.cumsum(len0.astype(np.int64) + 1)[:-1]])
            s0 = s0_all[s0_all < w_eff]
            common = np.intersect1d(starts, s0)
            if common.shape[0]:
                m = int(common[0])
                pre = starts[starts < m]
                r = int(np.searchsorted(s0, m))
                xs = np.zeros(w_eff + la, np.uint8)
                got = x[lo * B : min(n, lo * B + w_eff + la)]
                xs[: got.shape[0]] = got
                ln_h = Lh[pre].astype(np.int64)
                head_bytes = bitio.tokens_to_bytes(
                    Oh[pre].astype(np.int64), ln_h, xs[pre + ln_h], params)
                # the splice lives inside the first block (w_eff <= B)
                counts[lo] += pre.shape[0] - r
                stats.resync_head_tokens += int(pre.shape[0])
                return _Range(counts, spool, head_bytes, r)
        # A tiny range or a never-resync chain: the exact re-run from the
        # true entry (the maps already gave later ranks their entries, so
        # this stays a local fix).
        stats.resync_bulk += 1
        counts, _, _ = run_range(entry)
        return _Range(counts, spool)


def _range_encoder(params: spec.Params, pipeline: str):
    """The range encoder for ``pipeline``.

    'auto' = the fused device pipeline for byte-aligned token widths (a
    device-packed payload, less device-to-host traffic), else the
    host-parse pipeline; 'host'/'fused' force a choice.
    """
    if pipeline == "auto":
        pipeline = "fused" if bitio.byte_aligned(params) else "host"
    if pipeline == "fused":
        if not bitio.byte_aligned(params):
            raise ValueError(
                "multihost pipeline='fused' requires a byte-aligned token "
                f"width (width={params.width}); use pipeline='host'"
            )
        return _encode_range_fused
    if pipeline != "host":
        raise ValueError(f"unknown multihost pipeline {pipeline!r}")
    return _encode_range


def _run_range(x, n, params, spool_path, *, pipeline, block_size,
               batch_blocks, matcher, retries, fault_injector, device, comm,
               stats, release=lambda _pos: None):
    """This rank's range through the pipeline's encoder: (range, work)."""
    encode_range = _range_encoder(params, pipeline)
    if encode_range is _encode_range_fused:
        spool = _Spool(np.uint8, params.width // 8, spool_path)
    else:
        spool = _Spool(np.uint32, 1, spool_path)
    work = _Work()
    try:
        rng = encode_range(
            x, n, params, block_size=block_size, batch_blocks=batch_blocks,
            matcher=matcher, retries=retries, fault_injector=fault_injector,
            spool=spool, device=device, comm=comm, stats=stats, work=work,
            release=release,
        )
    except BaseException:
        spool.close()
        raise
    return rng, work


def _report_work(work_seconds, work: _Work, comm: _Comm) -> None:
    if work_seconds is not None:
        work_seconds.append({"wall": work.wall, "cpu": work.cpu,
                             "collectives": comm.seconds})


def encode_bytes_multihost(
    data: bytes,
    params: spec.Params | None = None,
    *,
    block_size: int = codec_model.DEFAULT_BLOCK_SIZE,
    batch_blocks: int = codec_model.DEFAULT_BATCH_BLOCKS,
    matcher: str = match_ops.DEFAULT_MATCHER,
    retries: int = 2,
    fault_injector: faults_lib.FaultInjector | None = None,
    work_seconds: list | None = None,
    force: bool = False,
    pipeline: str = "auto",
    stats: codec_model.EncodeStats | None = None,
    device: str | torch.device | None = None,
) -> bytes | None:
    """Encode with blocks partitioned across processes (in-memory API).

    Every process matches and parses only its contiguous block range; the
    stream is identical to the single-process encoder's (exact global parse
    via the entry-map composition).  Payloads are collected to process 0 in
    rank order at their EXACT sizes (one broadcast per rank, no padding to
    the global max).  Process 0 returns the stream; the others return None.

    ``work_seconds`` (a list) receives ``{"wall", "cpu", "collectives"}``:
    the work regions' wall and CPU seconds, collectives left out (on the
    card a region ends at a host read of its batch's results, so it holds
    the device's time), and the seconds spent in collectives.  ``stats``
    (an ``EncodeStats``) receives this rank's counters.  ``force=True``
    keeps the distributed code in a world of one.

    For file outputs prefer :func:`encode_file_multihost`, which ships no
    payload bytes between processes.
    """
    params = params or spec.Params()
    matcher = match_ops.route_matcher(matcher)
    encode_range = _range_encoder(params, pipeline)
    dev = rank_device(device)
    comm = _Comm()
    if comm.size == 1 and not force and fault_injector is None:
        # Solo fast path: the single-process encoder with what its
        # pipeline takes (only the host pipeline takes ``retries``).
        if encode_range is _encode_range_fused:
            return codec_model.encode_bytes(
                data, params, pipeline="fused", block_size=block_size,
                batch_blocks=batch_blocks, matcher=matcher, stats=stats,
                device=dev)
        return codec_model.encode_bytes(
            data, params, pipeline="host", block_size=block_size,
            batch_blocks=batch_blocks, matcher=matcher, retries=retries,
            stats=stats, device=dev)

    st = stats if stats is not None else codec_model.EncodeStats()
    x = np.frombuffer(data, dtype=np.uint8)
    n = x.shape[0]
    W = params.width
    rng, work = _run_range(
        x, n, params, None, pipeline=pipeline, block_size=block_size,
        batch_blocks=batch_blocks, matcher=matcher, retries=retries,
        fault_injector=fault_injector, device=dev, comm=comm, stats=st,
    )
    # Ordered exact-size collection: allgather the token counts, from
    # which every rank knows every payload's bit offset and size, then one
    # rank-ordered broadcast per rank of exactly its payload, packed at its
    # bit phase.
    tokens = comm.allgather([rng.tokens])[:, 0]
    starts = spec.HEADER_BITS + W * np.concatenate([[0], np.cumsum(tokens)])
    mine = None
    if rng.tokens:
        with work:
            base = int(starts[comm.rank]) // 8
            mine = np.zeros((int(starts[comm.rank + 1]) + 7) // 8 - base,
                            np.uint8)

            def put(pos, b):
                mine[pos - base : pos - base + b.shape[0]] = b

            for pos, val in _lay_out(rng, params, int(starts[comm.rank]),
                                     put):
                mine[pos - base] |= val
    rng.spool.close()
    out = bytearray(bitio.header_bytes(params))
    for h in range(comm.size):
        if not tokens[h]:
            continue
        phase = int(starts[h]) % 8
        got = comm.broadcast(mine, (phase + int(tokens[h]) * W + 7) // 8, h)
        if comm.rank == 0:
            if phase:
                out[-1] |= int(got[0])
                got = got[1:]
            out += got.tobytes()
    st.input_bytes = n
    st.tokens = int(tokens.sum())
    st.blocks = int(rng.counts.shape[0])
    st.output_bytes = spec.stream_size_bytes(st.tokens, W)
    _report_work(work_seconds, work, comm)
    return bytes(out) if comm.rank == 0 else None


def _lay_out(rng: _Range, params: spec.Params, start_bit: int,
             write) -> list[tuple[int, int]]:
    """Lay the range's payload out from bit ``start_bit`` of the stream, a
    chunk at a time: ``write(index, bytes)`` gets every byte that holds its
    bits only.  Returns the bytes ``(index, value)`` that it shares with its
    neighbours (its first when it starts mid-byte, its last when it ends
    mid-byte), which are left to the caller to merge."""
    partial = []
    bitpos = start_bit
    carry = 0  # bits already laid down in the byte at bitpos // 8
    for items in rng.chunks():
        pos = bitpos // 8
        phase = bitpos % 8
        buf, bits = _pack(items, params, phase)
        if phase:
            buf[0] |= carry
        bitpos += bits
        done = bitpos // 8 - pos  # bytes of ``buf`` now complete
        first = 0
        if done and phase and pos == start_bit // 8:
            partial.append((pos, int(buf[0])))
            first = 1
        if done > first:
            write(pos + first, buf[first:done])
        carry = int(buf[done]) if bitpos % 8 else 0
    if bitpos % 8:
        partial.append((bitpos // 8, carry))
    return partial


def encode_file_multihost(
    in_path: str,
    out_path: str,
    params: spec.Params | None = None,
    *,
    block_size: int = codec_model.DEFAULT_BLOCK_SIZE,
    batch_blocks: int = codec_model.DEFAULT_BATCH_BLOCKS,
    matcher: str = match_ops.DEFAULT_MATCHER,
    retries: int = 2,
    pipeline: str = "auto",
    fault_injector: faults_lib.FaultInjector | None = None,
    work_seconds: list | None = None,
    stats: codec_model.EncodeStats | None = None,
    device: str | torch.device | None = None,
) -> None:
    """Multi-process file encode over a shared filesystem: ordered
    parallel writes, no payload traffic between processes.

    Global bit offsets are affine in the allgathered token counts (SURVEY.md
    §7 insight 1), so every rank knows its segment's position.  Each rank
    spools its payload to a scratch file beside the output (``out_path +
    ".<rank>.partial"``, deleted on success and on error), then copies it
    into place a chunk at a time, packing token words at its bit phase on
    the way: a rank's host memory holds about one batch and one chunk of
    payload, whatever its range (the host route also keeps its range's
    match lengths, a byte a position).  A byte that two ranks' bits share
    is allgathered and merged by rank 0.  The result is byte-identical to
    the single-process stream.
    """
    params = params or spec.Params()
    matcher = match_ops.route_matcher(matcher)
    dev = rank_device(device)
    comm = _Comm()
    st = stats if stats is not None else codec_model.EncodeStats()
    n = os.path.getsize(in_path)
    x = (np.memmap(in_path, dtype=np.uint8, mode="r") if n
         else np.zeros(0, np.uint8))
    releaser = codec_model._PageReleaser(x, keep_margin=params.d_limit)
    st.page_release = releaser.active
    rng, work = _run_range(
        x, n, params, f"{out_path}.{comm.rank}.partial", pipeline=pipeline,
        block_size=block_size, batch_blocks=batch_blocks, matcher=matcher,
        retries=retries, fault_injector=fault_injector, device=dev,
        comm=comm, stats=st, release=releaser.release_to,
    )
    try:
        counts = comm.allgather(rng.counts).sum(axis=0)
        lo, hi = block_range(counts.shape[0], comm.size, comm.rank)
        W = params.width
        start_bit = spec.HEADER_BITS + W * int(counts[:lo].sum())
        total_tokens = int(counts.sum())
        if comm.rank == 0:
            with open(out_path, "wb") as f:
                f.write(bitio.header_bytes(params))
                f.truncate(spec.stream_size_bytes(total_tokens, W))
        # Barrier: the file must exist at full size before anyone writes.
        comm.barrier()
        with work:
            fd = os.open(out_path, os.O_WRONLY)
            try:
                partial = _lay_out(
                    rng, params, start_bit,
                    lambda pos, b: os.pwrite(fd, b.tobytes(), pos))
                os.fsync(fd)
            finally:
                os.close(fd)
    finally:
        rng.spool.close()
    if not bitio.byte_aligned(params):
        # A rank contributes at most two partial bytes: one fixed-size
        # record each for the allgather, (-1, 0) for none.
        rec = np.full((2, 2), (-1, 0), np.int64)
        for i, pv in enumerate(partial):
            rec[i] = pv
        allp = comm.allgather(rec).reshape(-1, 2)
        if comm.rank == 0:
            merged: dict[int, int] = {}
            for idx, val in allp:
                if idx >= 0:
                    merged[int(idx)] = merged.get(int(idx), 0) | int(val)
            fd = os.open(out_path, os.O_WRONLY)
            try:
                for idx, val in sorted(merged.items()):
                    os.pwrite(fd, bytes([val]), idx)
                os.fsync(fd)
            finally:
                os.close(fd)
    # Final barrier: every process returns only after the file is complete.
    comm.barrier()
    st.input_bytes = n
    st.tokens = total_tokens
    st.blocks = int(counts.shape[0])
    st.output_bytes = spec.stream_size_bytes(total_tokens, W)
    _report_work(work_seconds, work, comm)


# ---------------------------------------------------------------------------
# Local ranks: the worker command line and its launcher
# ---------------------------------------------------------------------------


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(args: list[str], nproc: int, *, timeout: float,
           env: dict | None = None) -> list[dict]:
    """Run ``nproc`` local ranks of this module's command line with
    ``args`` on a Gloo group at ``localhost``; returns every rank's report
    (the last line of its standard output, JSON), in rank order.

    A rank's nonzero exit raises ``RuntimeError`` with its error output; a
    timeout kills every rank and raises ``TimeoutError``.  The coordinator's
    port is chosen free and closed before rank 0 binds it, so a port taken
    in between (``EADDRINUSE``) is retried once on a new one.
    """
    env = dict(os.environ if env is None else env)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    # the ranks talk over the loopback device only
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    for attempt in range(2):
        port = _free_port()
        with tempfile.TemporaryDirectory() as tmp:
            logs = [(open(os.path.join(tmp, f"{r}.out"), "w+b"),
                     open(os.path.join(tmp, f"{r}.err"), "w+b"))
                    for r in range(nproc)]
            procs = [
                subprocess.Popen(
                    [sys.executable, "-m", f"{__package__}.distributed", *args,
                     "--nproc", str(nproc), "--rank", str(r),
                     "--coordinator", f"localhost:{port}"],
                    stdout=out, stderr=err, env=env)
                for r, (out, err) in enumerate(logs)
            ]
            deadline = time.monotonic() + timeout
            try:
                for p in procs:
                    p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise TimeoutError(
                    f"{nproc} ranks did not finish within {timeout} s"
                ) from None
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            texts = []
            for out, err in logs:
                out.seek(0)
                err.seek(0)
                texts.append((out.read().decode(), err.read().decode()))
                out.close()
                err.close()
        if attempt == 0 and any("EADDRINUSE" in e for _, e in texts):
            continue
        for r, (p, (_, err)) in enumerate(zip(procs, texts)):
            if p.returncode != 0:
                raise RuntimeError(
                    f"rank {r} of {nproc} exited {p.returncode}:\n"
                    f"{err[-3000:]}")
        return [json.loads(out.strip().splitlines()[-1]) for out, _ in texts]


def _fail_batches(text: str) -> dict[int, int]:
    """``"0:1,16:2"`` -> {0: 1, 16: 2} (block index: times to fail)."""
    return {int(k): int(v) for k, v in
            (item.split(":") for item in text.split(",") if item)}


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m lz77_tpu_torch.parallel.distributed",
        description="Encode one file over N local processes (Gloo), each "
                    "on its own block range; prints one JSON line per rank "
                    "and one for the run.",
    )
    p.add_argument("-i", dest="input", required=True)
    p.add_argument("-o", dest="output", required=True)
    p.add_argument("-l", dest="la", type=int, default=spec.DEFAULT_LA_SIZE)
    p.add_argument("-s", dest="sb", type=int, default=spec.DEFAULT_SB_SIZE)
    p.add_argument("--nproc", type=int, default=2)
    p.add_argument("--mode", choices=("file", "bytes"), default="file",
                   help="file: encode_file_multihost (each rank writes its "
                        "segment); bytes: encode_bytes_multihost (rank 0 "
                        "writes the stream)")
    p.add_argument("--pipeline", choices=("auto", "host", "fused"),
                   default="auto")
    p.add_argument("--matcher", default=match_ops.DEFAULT_MATCHER)
    p.add_argument("--block-size", type=int,
                   default=codec_model.DEFAULT_BLOCK_SIZE)
    p.add_argument("--batch-blocks", type=int,
                   default=codec_model.DEFAULT_BATCH_BLOCKS)
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="default: cuda:{rank %% device_count} (raises "
                        "without a card)")
    p.add_argument("--fail-batches", type=_fail_batches, default=None,
                   metavar="BLOCK:TIMES,...",
                   help="inject faults at these batch starts (retried)")
    p.add_argument("--force", action="store_true",
                   help="bytes mode: the distributed code in a world of one")
    p.add_argument("--timeout", type=float, default=3600.0,
                   help="seconds the launcher waits for its ranks")
    p.add_argument("--rank", type=int, default=None,
                   help="run as this rank (the launcher sets it)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT")
    return p


def prebuild(device=None) -> None:
    """Build what the ranks load (the kernel library unless ``device`` is
    the CPU, the native library) once, before they start, so that they do
    not all build it at once."""
    if device_lib.resolve(device).type == "cuda":
        _build.build_kernels()
    native_lib.load()


def _rank_main(a) -> int:
    """One rank: join the group, encode, print this rank's report.  The
    rank's CUDA context and the libraries it loads are set up before the
    timed encode (``setup_s``)."""
    from ..ops import match_chunk

    torch.set_num_threads(1)
    initialize(a.coordinator, a.nproc, a.rank)
    t0 = time.perf_counter()
    dev = rank_device(a.device)
    if dev.type == "cuda":
        torch.empty(1, device=dev)
        _build.kernels()
    native_lib.load()
    setup = time.perf_counter() - t0
    params = spec.Params(la=a.la, sb=a.sb)
    inj = (faults_lib.FaultInjector(a.fail_batches) if a.fail_batches
           else None)
    work: list[dict] = []
    st = codec_model.EncodeStats()
    kw = dict(block_size=a.block_size, batch_blocks=a.batch_blocks,
              matcher=a.matcher, pipeline=a.pipeline, fault_injector=inj,
              work_seconds=work, stats=st, device=dev)
    match_ops.match_sweep.launches = match_chunk.match_chunk.launches = 0
    t0 = time.perf_counter()
    if a.mode == "bytes":
        with open(a.input, "rb") as f:
            data = f.read()
        stream = encode_bytes_multihost(data, params, force=a.force, **kw)
        if stream is not None:
            with open(a.output, "wb") as f:
                f.write(stream)
    else:
        encode_file_multihost(a.input, a.output, params, **kw)
    wall = time.perf_counter() - t0
    w = work[0] if work else {"wall": wall, "cpu": wall, "collectives": 0.0}
    print(json.dumps({
        "rank": process_index(), "nproc": process_count(),
        "device": str(dev), "setup_s": setup, "wall": wall,
        "work": w["wall"], "work_cpu": w["cpu"],
        "collectives": w["collectives"],
        "launches": {"match_kernel": match_ops.match_sweep.launches,
                     "match_chunk_kernel": match_chunk.match_chunk.launches},
        "h2d_bytes": st.h2d_bytes, "d2h_bytes": st.d2h_bytes,
        "tokens": st.tokens, "retries": st.retries,
        "fault_checks": len(inj.calls) if inj else 0,
        "resyncs": st.resyncs, "resync_bulk": st.resync_bulk,
        "peak_rss_mb": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1024,
    }), flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


def main(argv: list[str] | None = None) -> int:
    a = _build_parser().parse_args(argv)
    if a.rank is not None:
        return _rank_main(a)
    # the ranks get the same arguments; the launcher's --nproc, --rank and
    # --coordinator come last, and argparse keeps the last of each
    args = list(sys.argv[1:] if argv is None else argv)
    prebuild(a.device)
    t0 = time.perf_counter()
    reports = launch(args, a.nproc, timeout=a.timeout)
    wall = time.perf_counter() - t0
    for r in reports:
        print(json.dumps(r))
    n = os.path.getsize(a.input)
    slowest = max(r["wall"] for r in reports)
    print(json.dumps({
        "nproc": a.nproc, "input_bytes": n,
        "stream_bytes": os.path.getsize(a.output),
        "launcher_wall_s": wall, "slowest_rank_wall_s": slowest,
        "encode_mb_s": n / slowest / 1e6 if slowest else None,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
