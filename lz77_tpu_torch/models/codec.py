"""Bytes- and file-level codec: block decomposition, batching, stream
assembly, checkpoint/resume, and the decode entry points.

Two encode pipelines, by name:

* ``host`` — device match + host parse (:func:`iter_block_bits`):

    input bytes -> fixed-size blocks (+ halo of preceding and la-1 following
                   input bytes)
               -> batched device match tables (the O(n * sb) hot phase)
               -> host global greedy parse: an entry-offset carry chains the
                  blocks, so the parse is exactly the serial one
               -> device gather of offsets at token starts
               -> host bit-pack of each block's tokens
               -> header + tokens + padding.

  It serves every token width, byte multiple or not.  The device returns
  nibble-packed match lengths (half a byte per input byte) and offsets are
  fetched only at token starts; a two-deep software pipeline overlaps the
  device match of batch k+1 with the host parse of batch k.

* ``fused`` — the device-resident match + parse + pack (``models.fused``):
  any token width in memory (:func:`encode_bytes`; its walk packs at any
  bit phase), byte-aligned widths only file to file (:func:`encode_file`,
  whose manifest records a batch's bytes).

* ``sharded`` — the same per data shard of a device mesh, the shards'
  walks chained through their entries (``parallel.sharded``), byte-aligned
  widths only at file scale (:func:`encode_file`); its bytes entry point is
  ``parallel.sharded.encode_bytes_sharded``.  The host pipeline takes a
  sharded match phase through ``match_fn``
  (``parallel.sharded.sharded_match_fn``).

Decode picks a backend by name: ``device`` (the walk-decode kernel,
``ops.decode_walk``; file to file it is chained stage by stage at bounded
host memory, :func:`decode_file_device`), ``device-chunked`` (the chunked
tensor decoder, ``models.decoder``), ``host`` (vectorized numpy) or
``native`` (the C++ host decoder).  Nothing here falls back from one
backend or pipeline to another: one that cannot run raises.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from .. import bitio, spec
from .. import device as device_lib
from .. import native as native_lib
from ..ops import match as match_ops
from ..utils import faults as faults_lib
from ..utils import manifest as manifest_lib
from ..utils import metrics as metrics_lib
from ..utils import profiling
from . import encoder as encoder_model
from . import fused

DEFAULT_BLOCK_SIZE = fused.DEFAULT_BLOCK_SIZE
DEFAULT_BATCH_BLOCKS = fused.DEFAULT_BATCH_BLOCKS
PIPELINES = ("host", "fused")  # codec.encode_bytes's
FILE_PIPELINES = ("host", "fused", "sharded")  # encode_file's


@dataclasses.dataclass
class EncodeStats:
    """Per-run observability record (the reference has none — SURVEY.md §5)."""

    input_bytes: int = 0
    output_bytes: int = 0
    tokens: int = 0
    blocks: int = 0
    retries: int = 0
    # Whether memmap page release (flat-RSS streaming) is active on this
    # run — False when the input is not a memmap or the private
    # numpy/mmap surface changed (makes RSS regressions diagnosable).
    page_release: bool = False
    # Host<->device transfer accounting: bytes staged to the device and
    # bytes fetched back.  The per-input-byte traffic ratio is the number
    # that explains end-to-end throughput once the kernels are fast.
    h2d_bytes: int = 0
    d2h_bytes: int = 0
    # Sharded pipeline (parallel/sharded.py): shards processed (those with
    # valid bytes).  The resync counters are the JAX package's keys: its
    # shards walk speculatively and splice; here every shard walks from its
    # true entry, so they stay 0.
    shards: int = 0
    resyncs: int = 0
    resync_head_tokens: int = 0
    resync_bulk: int = 0
    # Fused pipeline: the batches a call ran, and those after its first
    # that were staged and uploaded while the card still ran the batch
    # before (its event not yet passed): batches whose host work the card
    # hid.  The CPU runs a batch to its end, so there it stays 0.
    batches: int = 0
    batches_overlapped: int = 0
    # Fused pipeline: the batches that started inside a byte (a bit phase
    # other than 0), whose first byte was OR-ed into the stream's last.  0
    # at every token width that is a byte multiple.
    seams: int = 0
    # Fused pipeline, K1's wide-window route (``ops.match.takes_chain``):
    # the positions that walked earlier equal 4-grams, the hops they took,
    # and those that passed the hop budget and swept the rest.  0 where
    # the route is not taken.
    match_positions: int = 0
    match_hops: int = 0
    match_fallbacks: int = 0
    phases: metrics_lib.PhaseTimes = dataclasses.field(
        default_factory=metrics_lib.PhaseTimes
    )
    # The fused encode's spans, (name, t0_ns, t1_ns), kept only while a
    # torch profiler runs (``utils.profiling.annotate``).
    spans: list = dataclasses.field(default_factory=list)

    @property
    def ratio(self) -> float:
        return self.output_bytes / self.input_bytes if self.input_bytes else 0.0


@dataclasses.dataclass
class DecodeStats:
    """Decode observability: which backend ran, and the byte counts."""

    requested: str = ""
    backend: str = ""
    input_bytes: int = 0
    output_bytes: int = 0
    # Streamed device decode only: kernel stages run, and host seconds by
    # phase (read + token unpack, validate = the kernel's verdict, device
    # stage + fetch, write).
    stages: int = 0
    phases: dict = dataclasses.field(default_factory=dict)
    # The device decode's spans, as ``EncodeStats.spans``.
    spans: list = dataclasses.field(default_factory=list)


def _orbit_np(J: np.ndarray, entry: int, steps: int) -> np.ndarray:
    """S[i] = f^i(entry) for i in [0, steps], via pointer doubling."""
    S = np.zeros(steps + 1, np.int64)
    S[0] = entry
    m = 1
    Jm = J
    while m <= steps:
        span = min(m, steps + 1 - m)
        S[m : m + span] = Jm[S[:span]]
        Jm = Jm[Jm]
        m *= 2
    return S


def parse_block_np(
    L: np.ndarray, valid_len: int, entry: int, la: int
) -> tuple[np.ndarray, int]:
    """Host-side greedy parse of one block in numpy: (token starts, exit).

    Jump table f(p) = p + L[p] + 1 below ``valid_len``, fixpoints at/after
    it; the orbit of ``entry``.  The plain reference of
    ``native.parse_block``, which the pipeline runs: same answers.
    """
    B = L.shape[0]
    BE = B + la
    pos = np.arange(BE, dtype=np.int64)
    Lp = np.concatenate([L.astype(np.int64), np.zeros(la, np.int64)])
    J = np.where(pos < valid_len, np.minimum(pos + Lp + 1, BE - 1), pos)
    if entry >= valid_len:
        return np.zeros(0, np.int64), entry
    S = _orbit_np(J, entry, B)
    starts = S[:B][S[:B] < valid_len]
    return starts, int(S[B])


def _batch_inputs(x: np.ndarray, n: int, g0: int, gn: int, G: int, B: int,
                  H: int, R: int):
    """Blocks g0..g0+gn of ``x`` as (G, B) rows with halo and right extension."""
    gb = np.zeros((G, B), np.uint8)
    gh = np.zeros((G, H), np.uint8)
    gr = np.zeros((G, R), np.uint8)
    ga = np.zeros(G, np.int32)
    gv = np.zeros(G, np.int32)
    for i in range(gn):
        gs = (g0 + i) * B
        seg = x[gs : min(gs + B, n)]
        gb[i, : seg.shape[0]] = seg
        a = min(H, gs)
        if a > 0:
            gh[i, H - a :] = x[gs - a : gs]
        rseg = x[gs + B : min(gs + B + R, n)]
        gr[i, : rseg.shape[0]] = rseg
        ga[i] = a
        gv[i] = min(B + R, n - gs)
    return gb, gh, gr, ga, gv


def _host_block_size(block_size: int | None, n: int) -> int:
    """Block size of the host pipeline: the default is 1 MiB, or the input
    rounded up to even when that is shorter (nibble packing needs even)."""
    if block_size is None:
        block_size = min(DEFAULT_BLOCK_SIZE, max(n + (n & 1), 2))
    if block_size < 1:
        raise ValueError("block_size must be positive")
    if block_size % 2:
        raise ValueError("block_size must be even (nibble packing)")
    return block_size


def iter_block_bits(
    x: np.ndarray,
    params: spec.Params,
    *,
    block_size: int | None = None,
    batch_blocks: int = DEFAULT_BATCH_BLOCKS,
    matcher: str = match_ops.DEFAULT_MATCHER,
    retries: int = 2,
    fault_injector: faults_lib.FaultInjector | None = None,
    start_block: int = 0,
    entry: int = 0,
    phases: metrics_lib.PhaseTimes | None = None,
    stats: EncodeStats | None = None,
    device: str | torch.device | None = None,
    match_fn=None,
):
    """Yield (block_index, entry, next_entry, token_count, chunk) per block.

    The host-parse encode loop: batched device match phase, host
    entry-carried parse, device offset gather, host bit-pack.  ``chunk`` is
    the block's payload: packed bytes at a byte-aligned token width, else
    one uint8 per bit.  A two-deep software pipeline overlaps the device
    match of batch k+1 with the host parse of batch k (launches are
    asynchronous; the host blocks only when it fetches the lengths).
    ``start_block``/``entry`` resume mid-stream (``utils.manifest``).
    Failed device batches are retried ``retries`` times (blocks are
    independent up to the scalar entry carry — SURVEY.md §5).  The host
    walks the parse in C (``native.parse_block``) and packs byte-aligned
    widths in C (``native.pack_tokens``), other widths in numpy.

    ``match_fn(gb, gh, gr, ga, gv) -> (L, O)``, when given, replaces the
    device match (``parallel.sharded.sharded_match_fn``): it gets each
    batch's real rows as numpy arrays, and its full int32 tables are
    fetched in place of the nibble-packed lengths and the offset gather.
    A ``match_fn`` with a ``data_shards`` attribute needs ``batch_blocks``
    to be a multiple of it.
    """
    matcher = match_ops.route_matcher(matcher)
    if match_fn is not None:
        from ..parallel import sharded as sharded_lib

        sharded_lib.check_batch_blocks(
            batch_blocks, getattr(match_fn, "data_shards", 1))
    dev = device_lib.resolve(device)
    n = x.shape[0]
    B = _host_block_size(block_size, n)
    H = params.d_limit
    R = params.len_limit
    la = params.la
    nb = -(-n // B)
    G = batch_blocks
    first_batch = start_block // G
    if start_block % G:
        raise ValueError("start_block must be a multiple of batch_blocks")
    num_batches = -(-nb // G)
    if phases is None and stats is not None:
        phases = stats.phases
    ph = phases if phases is not None else metrics_lib.PhaseTimes()

    def submit(bi: int):
        g0 = bi * G
        gn = min(G, nb - g0)
        arrs = _batch_inputs(x, n, g0, gn, gn, B, H, R)
        if stats is not None:
            stats.h2d_bytes += sum(a.nbytes for a in arrs)
        if match_fn is not None:
            return ("full", bi, gn, *match_fn(*arrs))
        packed, O16 = encoder_model.match_blocks_compact(
            *(torch.from_numpy(a).to(dev) for a in arrs),
            la=params.la, sb=params.sb, matcher=matcher,
        )
        return ("compact", bi, gn, packed, O16)

    def count_retry():
        if stats is not None:
            stats.retries += 1

    state = {"entry": entry}

    def process(handle):
        kind, bi, gn, a1, a2 = handle
        g0 = bi * G
        with metrics_lib.StopwatchPhase(ph, "match"):
            if kind == "full":
                Lg, Og = a1.cpu().numpy(), a2.cpu().numpy()
                got = Lg.nbytes + Og.nbytes
            else:
                packed_np = a1.cpu().numpy()  # the only bulk fetch: ~B/2/block
                got = packed_np.nbytes
            if stats is not None:
                stats.d2h_bytes += got
        all_starts: list[np.ndarray] = []
        all_lens: list[np.ndarray] = []
        entries: list[tuple[int, int]] = []
        with metrics_lib.StopwatchPhase(ph, "parse"):
            for i in range(gn):
                gs = (g0 + i) * B
                vl = min(B, n - gs)
                L = (Lg[i] if kind == "full" else
                     encoder_model.unpack_lengths(packed_np[i], B, la))
                e_in = state["entry"]
                starts, exit_pos = native_lib.parse_block(L, vl, e_in)
                state["entry"] = max(0, exit_pos - B)
                entries.append((e_in, state["entry"]))
                all_starts.append(starts)
                all_lens.append(L[starts] if starts.shape[0] else
                                np.zeros(0, np.uint8))
        counts = [s.shape[0] for s in all_starts]
        if sum(counts) == 0:
            off_cat = np.zeros(0, np.int64)
        elif kind == "full":
            off_cat = np.concatenate(
                [Og[i][all_starts[i]] for i in range(gn)])
        else:
            with metrics_lib.StopwatchPhase(ph, "match"):
                flat = np.concatenate(
                    [i * B + s for i, s in enumerate(all_starts)]
                ).astype(np.int32)
                off_cat = encoder_model.gather_offsets(
                    a2, torch.from_numpy(flat).to(dev)
                ).cpu().numpy()
                if stats is not None:
                    stats.h2d_bytes += flat.nbytes
                    stats.d2h_bytes += off_cat.nbytes
        results = []
        c0 = 0
        with metrics_lib.StopwatchPhase(ph, "pack"):
            for i in range(gn):
                c = counts[i]
                gs = (g0 + i) * B
                starts = all_starts[i]
                ln = all_lens[i].astype(np.int64)
                off = off_cat[c0 : c0 + c].astype(np.int64)
                nx = x[gs + starts + ln] if c else np.zeros(0, np.uint8)
                if bitio.byte_aligned(params):
                    chunk, _bits = native_lib.pack_tokens(off, ln, nx, params)
                else:
                    chunk = bitio.tokens_to_chunk(off, ln, nx, params)
                e_in, e_out = entries[i]
                results.append((g0 + i, e_in, e_out, c, chunk))
                c0 += c
        return results

    def submit_checked(bi: int):
        if fault_injector is not None:
            fault_injector.check(bi)
        return submit(bi)

    pending = None
    for bi in range(first_batch, num_batches):
        with metrics_lib.StopwatchPhase(ph, "io"):
            nxt = faults_lib.with_retries(
                submit_checked, bi, retries=retries, on_retry=count_retry
            )
        if pending is not None:
            yield from process(pending)
        pending = nxt
    if pending is not None:
        yield from process(pending)


# The default of an argument that only one pipeline takes: passing it at
# all to the other pipeline is an error, not a value to drop.
_NOT_GIVEN = object()


def encode_bytes(
    data: bytes,
    params: spec.Params | None = None,
    *,
    pipeline: str = "fused",
    block_size: int | None = None,
    batch_blocks: int = DEFAULT_BATCH_BLOCKS,
    sub_block=_NOT_GIVEN,
    matcher: str = match_ops.DEFAULT_MATCHER,
    stats: EncodeStats | None = None,
    retries=_NOT_GIVEN,
    fault_injector=_NOT_GIVEN,
    match_fn=_NOT_GIVEN,
    device: str | torch.device | None = None,
) -> bytes:
    """Compress ``data`` into a complete reference-format stream.

    ``pipeline``: "fused" (device-resident, the walk step a batch, any
    width; takes ``sub_block``, int or None) or "host" (device match
    + host parse, any width; takes ``retries`` (default 2),
    ``fault_injector`` and ``match_fn``, a replacement for its match phase
    such as ``parallel.sharded.sharded_match_fn``).  Both take every
    ``matcher`` name of ``ops.match.get_matcher`` and emit the same
    stream.  An argument the chosen pipeline does not take raises
    ``TypeError``.  The sharded pipeline's bytes entry point is
    ``parallel.sharded.encode_bytes_sharded``.
    """
    if pipeline == "fused":
        _refuse(pipeline, retries=retries, fault_injector=fault_injector,
                match_fn=match_fn)
        return fused.encode_bytes_fused(
            data, params, block_size=block_size, batch_blocks=batch_blocks,
            sub_block=None if sub_block is _NOT_GIVEN else sub_block,
            stats=stats, matcher=matcher, device=device,
        )
    if pipeline != "host":
        raise ValueError(
            f"unknown pipeline {pipeline!r}; available: {', '.join(PIPELINES)}"
        )
    _refuse(pipeline, sub_block=sub_block)
    retries = 2 if retries is _NOT_GIVEN else retries
    if fault_injector is _NOT_GIVEN:
        fault_injector = None
    if match_fn is _NOT_GIVEN:
        match_fn = None
    params = params or spec.Params()
    x = np.frombuffer(data, dtype=np.uint8)
    n = x.shape[0]
    st = stats if stats is not None else EncodeStats()
    st.input_bytes = n
    block_size = _host_block_size(block_size, n)

    with metrics_lib.StopwatchPhase(st.phases, "total"):
        chunks: list[np.ndarray] = []
        total_tokens = 0
        if n > 0:
            for _, _, _, c, chunk in iter_block_bits(
                x, params, block_size=block_size, batch_blocks=batch_blocks,
                matcher=matcher, retries=retries,
                fault_injector=fault_injector, stats=st, device=device,
                match_fn=match_fn,
            ):
                total_tokens += c
                if chunk.shape[0]:
                    chunks.append(chunk)

        st.tokens = total_tokens
        st.blocks = -(-n // block_size)
        stream = bitio.assemble_stream(chunks, params)
        st.output_bytes = len(stream)
    return stream


def _refuse(pipeline: str, **given) -> None:
    """TypeError for any of ``given`` that the caller passed."""
    passed = sorted(k for k, v in given.items() if v is not _NOT_GIVEN)
    if passed:
        raise TypeError(
            f"pipeline {pipeline!r} takes no {', '.join(passed)} argument"
        )


class _PageReleaser:
    """Drop consumed memmap pages as the encode scan advances.

    Without this, sequentially-read file-backed pages stay resident and peak
    RSS grows with the INPUT size.  MADV_DONTNEED on a read-only private
    mapping just re-reads on any later touch, so it is safe even if
    something looks back.  ``active`` records whether the private
    ``x._mmap``/``madvise`` surface is actually present (a numpy change
    would otherwise silently disable flat-RSS behavior — the flag makes RSS
    regressions diagnosable from EncodeStats).
    """

    def __init__(self, x: np.ndarray, keep_margin: int):
        import mmap as mmap_lib

        self._mm = getattr(x, "_mmap", None)
        self._margin = keep_margin
        self._released = 0
        self._page = mmap_lib.PAGESIZE
        self._dontneed = getattr(mmap_lib, "MADV_DONTNEED", None)
        self.active = (
            self._mm is not None
            and self._dontneed is not None
            and hasattr(self._mm, "madvise")
        )

    def release_to(self, byte_pos: int) -> None:
        """Release pages wholly before ``byte_pos - keep_margin``."""
        if not self.active:
            return
        keep_from = max(0, byte_pos - self._margin)
        end = (keep_from // self._page) * self._page
        if end > self._released:
            start = self._released
            self._released = end
            try:
                self._mm.madvise(self._dontneed, start, end - start)
            except (OSError, ValueError):
                self.active = False  # optimization only, never correctness


class _BitSink:
    """Append payload chunks to a file, carrying sub-byte bits between
    chunks of a token width that is not a byte multiple."""

    def __init__(self, f, aligned: bool):
        self.f = f
        self.aligned = aligned
        self.rem = np.zeros(0, np.uint8)
        self.nbytes = 0

    def write(self, chunk: np.ndarray) -> None:
        if not chunk.shape[0]:
            return
        if self.aligned:
            self.f.write(chunk.tobytes())
            self.nbytes += chunk.shape[0]
            return
        bits = np.concatenate([self.rem, chunk])
        whole = (bits.shape[0] // 8) * 8
        if whole:
            self.f.write(np.packbits(bits[:whole], bitorder="little").tobytes())
            self.nbytes += whole // 8
        self.rem = bits[whole:]

    def close(self) -> None:
        if self.rem.shape[0]:
            # Final partial byte, zero-padded (bitIO_close, bitio.c:180-182).
            self.f.write(np.packbits(self.rem, bitorder="little").tobytes())
            self.nbytes += 1
            self.rem = np.zeros(0, np.uint8)


def encode_file(
    in_path: str,
    out_path: str,
    params: spec.Params | None = None,
    *,
    block_size: int | None = None,
    batch_blocks: int = DEFAULT_BATCH_BLOCKS,
    matcher: str = match_ops.DEFAULT_MATCHER,
    stats: EncodeStats | None = None,
    manifest_path: str | None = None,
    resume: bool = False,
    retries: int = 2,
    fault_injector: faults_lib.FaultInjector | None = None,
    pipeline: str = "host",
    mesh=None,
    device: str | torch.device | None = None,
) -> None:
    """File-to-file encode with optional checkpoint/resume.

    The input is memory-mapped and the output streamed: blocks are read on
    demand through OS paging and each completed block's payload is written
    at once, so both sides run in bounded memory for inputs far larger than
    RAM.

    With ``manifest_path``, each completed block's token bits are appended
    (byte-aligned) to ``out_path + '.partial'`` and the manifest records
    (tokens, bit offset, entry offsets) per block — SURVEY.md §5's
    checkpoint story.  On ``resume=True`` a compatible manifest skips every
    completed batch and continues from the recorded parse entry.  The final
    stream is assembled bit-contiguously, then scratch files are removed.

    ``pipeline``: 'host' = device match + host parse (any token width);
    'fused' = the device-resident match+parse+pack pipeline; 'sharded' =
    the same over the data shards of ``mesh`` (``parallel.mesh``; default:
    a one-member mesh on ``device`` when one is given, else every visible
    card), each shard's walk chained from the one before.  The fused and
    sharded pipelines checkpoint at BATCH granularity (one manifest record
    per device batch) and require a byte-aligned token width.  Every
    pipeline takes every ``matcher`` name (``ops.match.get_matcher``).
    """
    _t0 = time.perf_counter()
    params = params or spec.Params()
    if pipeline not in FILE_PIPELINES:
        raise ValueError(f"unknown pipeline {pipeline!r}")
    if pipeline != "sharded" and mesh is not None:
        raise TypeError(f"pipeline {pipeline!r} takes no mesh argument")
    if pipeline != "host":
        return _encode_file_batched(
            in_path, out_path, params, pipeline=pipeline,
            block_size=block_size, batch_blocks=batch_blocks,
            matcher=matcher, stats=stats, manifest_path=manifest_path,
            resume=resume, fault_injector=fault_injector, mesh=mesh,
            device=device,
        )
    dev = device_lib.resolve(device)
    n = os.path.getsize(in_path)
    x = (
        np.memmap(in_path, dtype=np.uint8, mode="r")
        if n
        else np.zeros(0, np.uint8)
    )
    block_size = _host_block_size(block_size, n)
    st = stats if stats is not None else EncodeStats()
    st.input_bytes = n
    aligned = bitio.byte_aligned(params)

    releaser = _PageReleaser(x, keep_margin=params.d_limit)
    st.page_release = releaser.active

    def blocks_from(start_block: int, entry: int):
        return iter_block_bits(
            x, params, block_size=block_size, batch_blocks=batch_blocks,
            matcher=matcher, retries=retries, fault_injector=fault_injector,
            start_block=start_block, entry=entry, stats=st, device=dev,
        )

    if manifest_path is None:
        total_tokens = 0
        with open(out_path, "wb") as f:
            f.write(bitio.header_bytes(params))
            sink = _BitSink(f, aligned)
            if n > 0:
                for bidx, _, _, c, chunk in blocks_from(0, 0):
                    total_tokens += c
                    if (bidx + 1) % batch_blocks == 0:
                        releaser.release_to((bidx + 1) * block_size)
                    sink.write(chunk)
            sink.close()
        st.tokens = total_tokens
        st.blocks = -(-n // block_size)
        st.output_bytes = spec.HEADER_BYTES + sink.nbytes
        st.phases.total = time.perf_counter() - _t0
        return

    scratch_path = out_path + ".partial"
    man = _load_manifest(manifest_path, scratch_path, resume, params,
                         block_size, n)
    # Resume can only restart at a batch boundary: drop trailing records
    # past the last full batch and truncate scratch accordingly.
    done = man.completed()
    done -= done % batch_blocks
    man.blocks = man.blocks[:done]
    _truncate_scratch(
        man, scratch_path,
        sum((b.tokens * man.width + 7) // 8 for b in man.blocks),
    )
    done = len(man.blocks)

    total_tokens = sum(b.tokens for b in man.blocks)
    if n > 0:
        with open(scratch_path, "ab") as scratch:
            for bidx, e_in, e_out, c, chunk in blocks_from(
                done, man.next_entry()
            ):
                if aligned:
                    scratch.write(chunk.tobytes())
                else:
                    scratch.write(
                        np.packbits(chunk, bitorder="little").tobytes()
                    )
                man.append(c, e_in, e_out)
                total_tokens += c
                if (bidx + 1) % batch_blocks == 0:
                    scratch.flush()
                    man.save(manifest_path)
                    releaser.release_to((bidx + 1) * block_size)

    # Final assembly, in bounded memory (the scratch file can exceed RAM):
    # byte-aligned widths stream-copy scratch after the header; non-aligned
    # widths merge each record's bits with a carried sub-byte remainder.
    with open(out_path, "wb") as f:
        f.write(bitio.header_bytes(params))
        with open(scratch_path, "rb") as sf:
            if aligned:
                out_bytes = spec.HEADER_BYTES + _copy_stream(sf, f)
            else:
                sink = _BitSink(f, aligned=False)
                for rec in man.blocks:
                    nbytes = (rec.tokens * man.width + 7) // 8
                    raw = np.frombuffer(sf.read(nbytes), np.uint8)
                    sink.write(
                        np.unpackbits(raw, bitorder="little")[
                            : rec.tokens * man.width
                        ]
                    )
                sink.close()
                out_bytes = spec.HEADER_BYTES + sink.nbytes
    os.unlink(scratch_path)
    if os.path.exists(manifest_path):
        os.unlink(manifest_path)

    st.tokens = total_tokens
    st.blocks = -(-n // block_size)
    st.output_bytes = out_bytes
    st.phases.total = time.perf_counter() - _t0


def _load_manifest(manifest_path, scratch_path, resume, params, block_size,
                   n, **compat):
    """A compatible manifest to resume from (``resume``), else a fresh one
    with an empty scratch file.  ``compat``: pipeline and batch_blocks of a
    batch-granular manifest."""
    if resume and os.path.exists(manifest_path):
        try:
            cand = manifest_lib.Manifest.load(manifest_path)
            if cand.compatible_with(params, block_size, n, **compat):
                return cand
        except Exception:  # noqa: BLE001 — an unreadable manifest restarts
            pass
    open(scratch_path, "wb").close()
    return manifest_lib.Manifest(
        la=params.la, sb=params.sb, block_size=block_size, input_bytes=n,
        **compat,
    )


def _truncate_scratch(man, scratch_path: str, scratch_bytes: int) -> None:
    """Cut the scratch file to the payload the manifest's records hold.

    A manifest without its scratch payload (deleted or truncated .partial)
    must restart: open('ab') would recreate it and truncate would
    zero-extend, silently replacing completed records with zeros.
    """
    if scratch_bytes and (
        not os.path.exists(scratch_path)
        or os.path.getsize(scratch_path) < scratch_bytes
    ):
        man.blocks = []
        scratch_bytes = 0
        open(scratch_path, "wb").close()
    with open(scratch_path, "ab") as f:
        f.truncate(scratch_bytes)


def _copy_stream(src, dst) -> int:
    """Append all of ``src`` to ``dst`` in bounded memory; bytes copied."""
    total = 0
    while True:
        buf = src.read(64 << 20)
        if not buf:
            return total
        dst.write(buf)
        total += len(buf)


def _encode_file_batched(
    in_path: str,
    out_path: str,
    params: spec.Params,
    *,
    pipeline: str,
    block_size: int | None,
    batch_blocks: int,
    matcher: str,
    stats: EncodeStats | None,
    manifest_path: str | None,
    resume: bool,
    fault_injector: faults_lib.FaultInjector | None,
    mesh,
    device: str | torch.device | None,
) -> None:
    """File-to-file encode through the fused or sharded device pipeline.

    The device-resident pipelines (match + parse + pack on the device) at
    file scale: memmap input with page release, payload bytes appended as
    each batch lands, one manifest record per BATCH (the device step's
    natural checkpoint unit).  Replaces lz77.c:89-136 + 246-251 for inputs
    larger than RAM.
    """
    _t0 = time.perf_counter()
    if params.width % 8 != 0:
        raise ValueError(
            f"pipeline={pipeline!r} requires a byte-aligned token width "
            f"(width={params.width}); use pipeline='host'"
        )
    if pipeline == "sharded":
        from ..parallel import mesh as mesh_lib
        from ..parallel import sharded as sharded_lib

        mesh = sharded_lib.resolve_mesh(mesh, device)
        sharded_lib.check_batch_blocks(batch_blocks,
                                       mesh.shape[mesh_lib.DATA_AXIS])

        def make_iter(start_batch: int, entry: int):
            return sharded_lib.iter_batches_sharded(
                x, params, mesh=mesh, block_size=block_size,
                batch_blocks=batch_blocks, matcher=matcher,
                start_batch=start_batch, entry=entry, stats=st,
            )
    else:
        dev = device_lib.resolve(device)

        def make_iter(start_batch: int, entry: int):
            return fused.iter_batches_fused(
                x, params, block_size=block_size, batch_blocks=batch_blocks,
                matcher=matcher, start_batch=start_batch, entry=entry,
                stats=st, device=dev,
            )
    n = os.path.getsize(in_path)
    x = (
        np.memmap(in_path, dtype=np.uint8, mode="r")
        if n
        else np.zeros(0, np.uint8)
    )
    if block_size is None:
        block_size = min(DEFAULT_BLOCK_SIZE, max(n, 1))
    st = stats if stats is not None else EncodeStats()
    st.input_bytes = n

    releaser = _PageReleaser(x, keep_margin=params.d_limit)
    st.page_release = releaser.active
    span = batch_blocks * block_size  # bytes per batch

    def run_batches(sink, start_batch: int, entry: int, on_batch=None):
        total_tokens = 0
        for bi, e_in, e_out, tok, payload in make_iter(start_batch, entry):
            if fault_injector is not None:
                fault_injector.check(bi)
            total_tokens += tok
            if payload:
                sink.write(payload)
            if on_batch is not None:
                on_batch(bi, e_in, e_out, tok)
            releaser.release_to((bi + 1) * span)
        return total_tokens

    if manifest_path is None:
        with open(out_path, "wb") as f:
            f.write(bitio.header_bytes(params))
            total_tokens = run_batches(f, 0, 0) if n > 0 else 0
            out_bytes = f.tell()
        st.tokens = total_tokens
        st.blocks = -(-n // block_size)
        st.output_bytes = out_bytes
        st.phases.total = time.perf_counter() - _t0
        return

    scratch_path = out_path + ".partial"
    man = _load_manifest(
        manifest_path, scratch_path, resume, params, block_size, n,
        pipeline=pipeline, batch_blocks=batch_blocks,
    )
    # Batch records are the checkpoint unit: drop nothing (each record is a
    # completed batch), truncate scratch to the recorded payload bytes.
    man.blocks = man.blocks[: man.completed()]
    _truncate_scratch(
        man, scratch_path,
        sum((b.tokens * man.width) // 8 for b in man.blocks),
    )

    total_tokens = sum(b.tokens for b in man.blocks)
    if n > 0:
        with open(scratch_path, "ab") as scratch:

            def checkpoint(bi, e_in, e_out, tok):
                scratch.flush()
                man.append(tok, e_in, e_out)
                man.save(manifest_path)

            total_tokens += run_batches(
                scratch, len(man.blocks), man.next_entry(), checkpoint
            )

    # Final assembly: byte-aligned payloads stream-copy after the header.
    with open(out_path, "wb") as f:
        f.write(bitio.header_bytes(params))
        with open(scratch_path, "rb") as sf:
            out_bytes = spec.HEADER_BYTES + _copy_stream(sf, f)
    os.unlink(scratch_path)
    if os.path.exists(manifest_path):
        os.unlink(manifest_path)

    st.tokens = total_tokens
    st.blocks = -(-n // block_size)
    st.output_bytes = out_bytes
    st.phases.total = time.perf_counter() - _t0


def decode_bytes(
    data: bytes,
    backend: str = "device",
    *,
    stats: DecodeStats | None = None,
    device: str | torch.device | None = None,
) -> bytes:
    """Decompress a complete reference-format stream.

    ``backend``: "device" (walk-decode kernel on ``device``),
    "device-chunked" (the chunked tensor decoder on ``device``, plain
    tensor code), "host" (numpy pointer doubling) or "native" (C++ host
    decoder).  The backend that ran is recorded in ``stats.backend``.
    """
    st = stats if stats is not None else DecodeStats()
    st.requested = backend
    st.input_bytes = len(data)
    if backend == "device":
        from ..ops import decode_walk

        with profiling.annotate("decode.unpack", st):
            params, off, ln, nxt = bitio.parse_stream(data)
        out = decode_walk.decode_tokens_walk(
            off, ln, nxt, off_bits=params.off_bits, device=device, stats=st
        )
        st.backend = "device-walk"
    elif backend == "device-chunked":
        from . import decoder

        out = decoder.decode_stream(data, device=device)
        st.backend = "device-chunked"
    elif backend == "host":
        from . import host_decode

        out = host_decode.decode(data)
        st.backend = "host"
    elif backend == "native":
        out = native_lib.decode(data)
        st.backend = "native"
    else:
        raise ValueError(
            f"unknown decode backend {backend!r}; "
            "available: device, device-chunked, host, native"
        )
    st.output_bytes = len(out)
    return out


def decode_file(
    in_path: str,
    out_path: str,
    backend: str = "device",
    *,
    stats: DecodeStats | None = None,
    read_chunk: int = 8 << 20,
    out_chunk: int = 4 << 20,
    device: str | torch.device | None = None,
) -> int:
    """File-to-file decode; returns the decoded size.

    ``backend``: "device" streams through the walk-decode kernel at bounded
    host memory (:func:`decode_file_device`); "native" is the C++ streamed
    decoder, O(window) memory at any stream size (the reference's decode
    capability, lz77.c:148-197 + bitio.c:103-121); "host" materializes the
    stream in RAM and goes through :func:`decode_bytes`.  The backend that
    ran is recorded in ``stats.backend``; one that cannot run raises.
    """
    st = stats if stats is not None else DecodeStats()
    st.requested = backend
    if backend == "native":
        st.input_bytes = os.path.getsize(in_path)
        n = native_lib.decode_file(
            in_path, out_path, read_chunk=read_chunk, out_chunk=out_chunk
        )
        st.backend = "native-streamed"
        st.output_bytes = n
        return n
    if backend == "device":
        return decode_file_device(in_path, out_path, stats=st, device=device)
    with open(in_path, "rb") as f:
        data = f.read()
    out = decode_bytes(data, backend=backend, stats=st, device=device)
    with open(out_path, "wb") as f:
        f.write(out)
    return len(out)


def decode_file_device(
    in_path: str,
    out_path: str,
    *,
    stats: DecodeStats | None = None,
    tokens_per_stage: int = 1 << 19,
    out_cap_words: int = 8 << 20,
    read_tokens: int = 1 << 21,
    device: str | torch.device | None = None,
) -> int:
    """File-to-file decode through the DEVICE walk kernel at bounded RSS.

    Completes the device story for lz77.c:148-197: the whole-stream device
    decoder materializes stream + output in RAM, while this one streams —
    each stage of at most ``tokens_per_stage`` tokens and ``out_cap_words``
    output bytes is one kernel call primed with the last ``d_limit`` decoded
    bytes as its history window (the window recycle, lz77.c:172-175), so
    stages chain exactly like one invocation.  The window rides from stage
    to stage as a device tensor.  Host memory is bounded by the read chunk
    and one stage's output regardless of stream size; every stage fetches
    exactly its decoded bytes.

    Every stage's tokens are checked by the kernel against the available
    history and the header's limits; a stage that breaks one raises
    ValueError like the native route, before any of its bytes is fetched
    or written.  ``stats.phases``: ``read`` (file read, token unpack, word
    packing), ``validate`` (launch to verdict: the replay with its checks
    and the count read back), ``device`` (stage set-up, token upload, byte
    fetch, window carry) and ``write``, host seconds each.
    """
    from ..ops import decode_walk

    dev = device_lib.resolve(device)
    st = stats if stats is not None else DecodeStats()
    st.requested = "device"
    st.input_bytes = os.path.getsize(in_path)
    ph = {"read": 0.0, "validate": 0.0, "device": 0.0, "write": 0.0}
    clock = time.perf_counter

    with open(in_path, "rb") as f:
        hdr = f.read(spec.HEADER_BYTES)
        if len(hdr) < spec.HEADER_BYTES:
            raise ValueError("corrupt or truncated stream: no header")
        sb = hdr[0] | (hdr[1] << 8)
        la = hdr[2] | (hdr[3] << 8)
        if not (spec.MIN_LA_SIZE <= la <= spec.MAX_LA_SIZE) or not (
            1 <= sb <= spec.MAX_SB_SIZE
        ):
            raise ValueError(f"corrupt stream header: la={la} sb={sb}")
        params = spec.Params(la=la, sb=sb)
        width = params.width
        dlim = params.d_limit
        aligned = bitio.byte_aligned(params)
        window = None  # device tensor: decoded history tail (<= dlim bytes)
        total_out = 0
        # tokens_per_stage % 8 == 0 keeps every file chunk byte-aligned
        # (8 tokens always span a whole number of bytes at any width).
        read_bytes = (read_tokens * width) // 8
        carry = b""
        with open(out_path, "wb") as fout:
            while True:
                t0 = clock()
                buf = f.read(read_bytes)
                if not buf and not carry:
                    break
                chunk = carry + buf
                eof = len(buf) < read_bytes
                T_chunk = (len(chunk) * 8) // width
                if not eof:
                    T_chunk -= T_chunk % 8  # keep the tail byte-aligned
                used_bytes = (
                    len(chunk) if eof else (T_chunk * width) // 8
                )
                carry = b"" if eof else chunk[used_bytes:]
                if T_chunk == 0:
                    if eof:
                        break
                    continue
                raw = np.frombuffer(chunk[:used_bytes], np.uint8)
                if aligned:
                    off, ln, nxt = bitio.bytes_to_tokens(raw, T_chunk, params)
                else:
                    off, ln, nxt = bitio.bits_to_tokens(
                        np.unpackbits(raw, bitorder="little")[
                            : T_chunk * width
                        ],
                        params,
                    )
                words = decode_walk.pack_token_words(off, ln, nxt)
                ph["read"] += clock() - t0
                done = 0
                while done < T_chunk:
                    t0 = clock()
                    k = min(tokens_per_stage, T_chunk - done)
                    # bound the stage by the output budget
                    cum = np.cumsum(ln[done : done + k] + 1)
                    if cum[-1] > out_cap_words:
                        k = max(1, int(np.searchsorted(
                            cum, out_cap_words, side="right"
                        )))
                    n_out = int(cum[k - 1])
                    wp = 0 if window is None else int(window.shape[0])
                    # the kernel checks every token: 1 <= off <= min(d_limit,
                    # history) and len <= len_limit where len > 0 (off is
                    # ignored when len == 0, like every decoder here and the
                    # reference's copy loop, lz77.c:178-188); the window is
                    # min(history, d_limit) bytes, so off > start + wp
                    # and off > d_limit together are the history check
                    out, cnt = decode_walk.walk_decode(
                        torch.from_numpy(words[done : done + k]).to(dev), k,
                        out_cap=n_out, win=window, wp=wp,
                        off_bits=params.off_bits, d_limit=dlim,
                        len_limit=params.len_limit,
                    )
                    t1 = clock()
                    n = int(cnt)  # the verdict, before any byte is fetched
                    if n < 0:
                        raise ValueError("corrupt stream: invalid token")
                    if n != n_out:
                        raise RuntimeError(
                            f"walk decode wrote {n} bytes, expected {n_out}"
                        )
                    t2 = clock()
                    ph["validate"] += t2 - t1
                    piece = out.cpu().numpy()
                    # the window carried to the next stage stays on the
                    # device: the last d_limit bytes of history + output
                    if n_out >= dlim or window is None:
                        window = out[max(0, n_out - dlim):]
                    else:
                        window = torch.cat([window, out])[-dlim:]
                    t3 = clock()
                    ph["device"] += (t1 - t0) + (t3 - t2)
                    fout.write(piece)
                    ph["write"] += clock() - t3
                    total_out += n_out
                    st.stages += 1
                    done += k
                if eof:
                    break
    st.backend = "device-walk-streamed"
    st.output_bytes = total_out
    st.phases = ph
    return total_out
