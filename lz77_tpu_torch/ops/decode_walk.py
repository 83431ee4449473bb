"""Token-replay decode: plain PyTorch version and CUDA kernel.

The reference decoder (lz77.c:164-195) is byte-serial pointer chasing:
``buffer[back] = buffer[back - off]`` one byte at a time, where the source
byte may itself have been produced by the same token (overlapping copies,
``off < len``, which is how runs are coded).

Contract (the JAX package's ``ops.decode_walk``): tokens arrive one int32
word each, ``off | len<<16 | next<<24`` whatever the stream's ``off_bits``;
the output is ``sum(len) + T`` bytes, known on the host up front because
token widths are fixed.  An optional window ``win`` of ``wp`` history bytes
primes the positions -wp..-1, so match sources behind position 0 resolve as
if earlier stages' output preceded this call's (streamed decode).

Kernel note — ``csrc/decode_walk.cu`` (K3) replaces the TPU kernel
``lz77_tpu/ops/decode_walk.py::_kernel``.  That kernel replays the tokens
one by one on the scalar unit and keeps the window in a ring of scalar
memory, one byte per word, because its vector units cannot gather; the ring
capped ``off_bits`` and forced tile-multiple priming windows.  Hopper
gathers, so here the replay is parallel (``csrc/decode_common.cuh``): a
scan of ``len+1`` places the tokens, every copy byte gets a parent pointer
``start - off + (q mod off)`` — wholly before its token, so overlapping
copies cost no hop — and one thread block per tile of ``TILE_WORDS`` output
words collapses its tile's pointers by pointer jumping in shared memory,
all tiles at once.  A pointer that leaves its tile is an *external* root:
a byte of an earlier tile's output, or of the window, which is the tile
before tile 0 and final before the launch.  Only the last
``2^off_bits + 256`` bytes before a tile can be its source, so a tile
stores that tail first and raises a flag, and the tile after it waits for
nothing else; a tile whose roots lie in its own tile or in the window does
not wait at all.  The kernel is bound by its chains and that hand-off, not
by its contract's bytes (4 B read per token, 1 B written per output byte)
and not by operations.  Device-memory scratch is the per-block token sums,
one flag per tile and two counters: nothing that grows with the output
bytes.  The tile that holds a token's first byte also checks it against
the stream's limits (``off == 0``, ``off > start + wp``, ``off > d_limit``,
``len > len_limit``, for ``len > 0``), and a stream that breaks one gives
the count -1, so the callers check nothing per token on the host.  Two
earlier designs are in PERF.md: one warp replaying the tokens in order (a
round trip to L2 per copy token), and parent pointers in device memory
with a launch per pointer-jumping round.

Packed variant — ``csrc/decode_walk_packed.cu`` (K6) replaces the TPU
kernel ``lz77_tpu/ops/decode_walk.py::_kernel_packed``: the same replay with
packed int32 output (four bytes a word, little endian) and no priming.
That kernel replays the tokens one after another through a ring of packed
words; the port's contract is the same and its mechanism is not.  K3 and
K6 launch one tile body, ``decode_common.cuh``'s; K3 keeps its byte output
by handing the kernel whole words and returning their bytes, and is the
decode backend; K6 is reached through :func:`decode_tokens_walk_packed`, as
in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .. import device as device_lib
from ..utils import profiling

_TOKENS_PER_BLOCK = 2048  # SCAN_CHUNK of csrc/decode_common.cuh
_SYNC_WORDS = 2           # SYNC_FLAGS of csrc/decode_common.cuh

# Output words per thread block of the replay (K3 and K6): 48 KiB of output,
# 192 KB of shared memory.  The kernels take it as an argument, so a caller
# may time other sizes by setting this.
TILE_WORDS = 12288


def pack_token_words(
    off: np.ndarray, ln: np.ndarray, nxt: np.ndarray
) -> np.ndarray:
    """Token fields -> (T,) int32 decode words ``off | len<<16 | next<<24``.

    Built in int64 and truncated: a ``next`` byte >= 128 sets the sign bit.
    """
    w = (
        off.astype(np.int64)
        | (ln.astype(np.int64) << 16)
        | (nxt.astype(np.int64) << 24)
    )
    return w.astype(np.uint32).view(np.int32)


def _replay_pointers(toks, total: int, out_cap: int, win, wp: int,
                     d_limit: int, len_limit: int):
    """Values and parent pointers of the replay over ``wp`` history bytes
    and ``out_cap`` output bytes -> (val uint8, ptr int64, cnt int32 (1,)).

    ``val`` holds the history and every literal, 0 elsewhere.  ``ptr[j]`` is
    ``j`` for a root (history, literal, a byte no token covers, a copy with
    ``off == 0`` or a source before the history: those read 0) and for copy
    byte ``q`` of a token the parent ``start - off + (q mod off)``, which
    lies before the token, so an overlapping copy costs no hop.  ``cnt``
    is ``sum(len + 1)``, or -1 if a token that starts below ``out_cap``
    has ``len > 0`` and ``off == 0``, ``off > start + wp``,
    ``off > d_limit`` or ``len > len_limit``.
    """
    dev = toks.device
    W = wp + out_cap
    val = torch.zeros(W, dtype=torch.uint8, device=dev)
    if wp:
        val[:wp] = win
    pos = torch.arange(W, dtype=torch.int64, device=dev)
    if total == 0:
        return val, pos, torch.zeros(1, dtype=torch.int32, device=dev)
    w = toks[:total].to(torch.int64)
    off = w & 0xFFFF
    ln = (w >> 16) & 0xFF
    nxt = ((w >> 24) & 0xFF).to(torch.uint8)
    ends = torch.cumsum(ln + 1, dim=0)
    starts = ends - (ln + 1)
    bad = (starts < out_cap) & (ln > 0) & (
        (off == 0) | (off > starts + wp) | (off > d_limit) | (ln > len_limit))
    cnt = torch.where(bad.any(), -1, ends[-1]).to(torch.int32).reshape(1)
    fits = ends <= out_cap  # tokens past out_cap are dropped
    val[(wp + starts + ln)[fits]] = nxt[fits]

    # covering token of each position: +1 at every token start, cumsum
    ind = torch.zeros(W + 1, dtype=torch.int64, device=dev)
    ind[(wp + starts)[fits]] = 1
    tok_of = (torch.cumsum(ind[:W], dim=0) - 1).clamp(0, total - 1)
    start = wp + starts[tok_of]
    delta = pos - start
    o = off[tok_of]
    done = wp + torch.where(fits, ends, 0).max()
    fixed = (pos < wp) | (pos >= done) | (delta == ln[tok_of]) | (o == 0)
    ptr = start - o + delta % o.clamp(min=1)
    ptr = torch.where(fixed | (ptr < 0), pos, ptr)
    return val, ptr, cnt


def _limits(off_bits: int, d_limit: int | None, len_limit: int) -> int:
    """Check the replay's limits -> d_limit (default 2^off_bits - 1)."""
    if not 0 <= off_bits <= 16:
        raise ValueError(f"off_bits {off_bits} outside [0, 16]")
    if d_limit is None:
        d_limit = (1 << off_bits) - 1
    if not 0 <= d_limit < (1 << off_bits):
        raise ValueError(
            f"d_limit {d_limit} outside [0, 2^off_bits) at off_bits {off_bits}")
    if not 0 <= len_limit <= 255:
        raise ValueError(f"len_limit {len_limit} outside [0, 255]")
    return d_limit


def walk_decode_plain(
    toks: torch.Tensor,
    total: int,
    *,
    out_cap: int,
    win: torch.Tensor | None = None,
    wp: int = 0,
    off_bits: int = 16,
    d_limit: int | None = None,
    len_limit: int = 255,
    tile_bytes: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: positions by cumsum, copies by pointer doubling.

    Every output byte is a literal (value known) or a copy of an earlier
    byte, a parent pointer (:func:`_replay_pointers`, which also checks the
    tokens against the limits: a broken one makes the count -1).

    ``tile_bytes=None``: doubling collapses each chain to its literal (or
    history) root over the whole buffer.  With ``tile_bytes`` it follows the
    kernel's decomposition: pointer doubling confined to tiles of that many
    output bytes (a parent before its tile makes the byte an external root
    of the tile), all tiles at once, then tile by tile in order every byte
    takes its root's value, or for an external root the byte of the window
    or of an earlier tile that is already final.  A pointer that leaves the
    buffer, or a copy with ``off == 0``, reads 0.
    """
    d_limit = _limits(off_bits, d_limit, len_limit)
    if tile_bytes is not None and tile_bytes < 1:
        raise ValueError(f"tile_bytes {tile_bytes} must be positive")
    val, ptr, cnt = _replay_pointers(toks, total, out_cap, win, wp,
                                     d_limit, len_limit)
    if tile_bytes is None:
        while True:
            nxt_ptr = ptr[ptr]
            if torch.equal(nxt_ptr, ptr):
                break
            ptr = nxt_ptr
        return val[ptr][wp:], cnt
    W = wp + out_cap
    pos = torch.arange(W, dtype=torch.int64, device=toks.device)
    # the window is the tile before tile 0: its bytes are roots
    tile_start = torch.where(
        pos < wp, 0, wp + (pos - wp) // tile_bytes * tile_bytes)
    inside = ptr >= tile_start  # a root points at itself: inside
    loc = torch.where(inside, ptr, pos)
    while True:  # every chain ends at a root of its own tile
        nxt_loc = loc[loc]
        if torch.equal(nxt_loc, loc):
            break
        loc = nxt_loc
    external = ~inside[loc]
    src = torch.where(external, ptr[loc], loc)
    out = val.clone()
    for t0 in range(wp, W, tile_bytes):  # the hand-off: earlier bytes final
        sl = slice(t0, min(t0 + tile_bytes, W))
        out[sl] = torch.where(external[sl], out[src[sl]], val[src[sl]])
    return out[wp:], cnt


def walk_decode(
    toks: torch.Tensor,   # (>= total,) int32 decode words
    total: int,           # real token count T
    *,
    out_cap: int,         # output bytes: sum(len) + T
    win: torch.Tensor | None = None,  # (wp,) uint8 history bytes
    wp: int = 0,
    off_bits: int = 16,   # the stream's offset width (bounds the hand-off)
    d_limit: int | None = None,  # largest offset allowed; 2^off_bits - 1
    len_limit: int = 255,        # largest length allowed
) -> tuple[torch.Tensor, torch.Tensor]:
    """K3 wrapper: replay tokens -> (bytes, out_len).

    ``bytes`` is (out_cap,) uint8; ``out_len`` a (1,) int32 tensor holding
    the cursor after the last token, or -1 if a token that starts below
    ``out_cap`` has ``len > 0`` and ``off == 0``, ``off > start + wp``,
    ``off > d_limit`` or ``len > len_limit`` (the bytes are then
    unspecified): read it before the bytes.  CUDA tensors launch the kernel
    (or raise); CPU tensors run the plain version.
    ``walk_decode.launches`` counts launches; ``walk_decode.scratch_bytes``
    is the device-memory scratch of the last one.
    """
    if toks.dtype != torch.int32 or toks.dim() != 1 \
            or not toks.is_contiguous():
        raise ValueError("toks must be a contiguous 1-D int32 tensor")
    if not 0 <= total <= toks.shape[0]:
        raise ValueError(f"total {total} outside [0, {toks.shape[0]}]")
    if out_cap < 0 or wp < 0 or wp + out_cap >= (1 << 31):
        raise ValueError(f"wp + out_cap = {wp + out_cap} outside [0, 2^31)")
    if wp:
        if win is None or win.shape != (wp,) or win.dtype != torch.uint8 \
                or win.device != toks.device or not win.is_contiguous():
            raise ValueError("win must be a (wp,) uint8 tensor beside toks")
    elif win is not None and win.shape[0]:
        raise ValueError("win given but wp == 0")
    d_limit = _limits(off_bits, d_limit, len_limit)
    if not toks.is_cuda:
        return walk_decode_plain(toks, total, out_cap=out_cap, win=win, wp=wp,
                                 off_bits=off_bits, d_limit=d_limit,
                                 len_limit=len_limit)
    lib = _build.kernels()
    dev = toks.device
    # whole words, every one written by the kernel; the window stays apart
    words = -(-out_cap // 4)
    out = torch.empty(words, dtype=torch.int32, device=dev)
    cnt = torch.empty(1, dtype=torch.int32, device=dev)
    # scratch: per-block token sums, the ticket, the scan's counter and one
    # flag a tile
    sums = torch.empty(max(1, -(-total // _TOKENS_PER_BLOCK)),
                       dtype=torch.int32, device=dev)
    sync = torch.zeros(_SYNC_WORDS + -(-words // TILE_WORDS),
                       dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.lz77_walk_decode(
            toks.data_ptr(), total, out.data_ptr(), out_cap, words,
            win.data_ptr() if wp else None, wp, cnt.data_ptr(),
            sums.data_ptr(), sync.data_ptr(), off_bits, d_limit, len_limit,
            TILE_WORDS, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "walk_decode_kernel")
    walk_decode.launches += 1
    walk_decode.scratch_bytes = 4 * (sums.numel() + sync.numel())
    return out.view(torch.uint8)[:out_cap], cnt


walk_decode.launches = 0
walk_decode.scratch_bytes = 0


def _checked_token_words(off, ln, nxt, off_bits: int, dev, stats=None):
    """A full token list -> (decode words on ``dev``, output length).  The
    tokens themselves are checked by the replay (its count comes back -1).
    Under a profiler the packing and the upload are the ``decode.pack``
    and ``decode.upload`` spans (into ``stats.spans`` with ``stats``)."""
    if off_bits > 16:
        raise ValueError(
            f"decode token words hold 16 offset bits, got off_bits={off_bits}"
        )
    with profiling.annotate("decode.pack", stats):
        out_len = int(ln.sum(dtype=np.int64)) + int(ln.shape[0])
        words = pack_token_words(off, ln, nxt)
    with profiling.annotate("decode.upload", stats):
        return torch.from_numpy(words).to(dev), out_len


def _count(cnt: torch.Tensor, out_len: int, what: str) -> int:
    n = int(cnt)
    if n < 0:
        raise ValueError("corrupt stream: match reaches before output start")
    if n != out_len:
        raise RuntimeError(f"{what} wrote {n} bytes, expected {out_len}")
    return n


def decode_tokens_walk(
    off: np.ndarray,
    ln: np.ndarray,
    nxt: np.ndarray,
    *,
    off_bits: int,
    device: str | torch.device | None = None,
    stats=None,
) -> bytes:
    """Decode a full token list on the device via the walk kernel; a token
    that reaches before the output start, or has ``off == 0`` with a
    length, raises ``ValueError`` (from the kernel's count).  Under a
    profiler its steps are the spans ``decode.pack``, ``decode.upload``,
    ``decode.launch``, ``decode.verdict`` (the wait for the kernel's
    count) and ``decode.fetch``, kept in ``stats.spans`` with ``stats``
    (a ``DecodeStats``)."""
    dev = device_lib.resolve(device)
    T = int(off.shape[0])
    if T == 0:
        return b""
    toks, out_len = _checked_token_words(off, ln, nxt, off_bits, dev, stats)
    with profiling.annotate("decode.launch", stats):
        out, cnt = walk_decode(toks, T, out_cap=out_len, off_bits=off_bits)
    with profiling.annotate("decode.verdict", stats):
        _count(cnt, out_len, "walk decode")
    with profiling.annotate("decode.fetch", stats):
        return out.cpu().numpy().tobytes()


def walk_decode_packed_plain(
    toks: torch.Tensor, total: int, *, out_cap_words: int,
    tile_words: int | None = None, off_bits: int = 16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the packed replay: :func:`walk_decode_plain`
    over ``4 * out_cap_words`` bytes, no window, zero-padded to whole words
    and viewed as little-endian int32.  ``tile_words`` follows the kernel's
    tiles (``tile_bytes = 4 * tile_words``)."""
    if tile_words is not None and tile_words < 1:
        raise ValueError(f"tile_words {tile_words} must be positive")
    out, cnt = walk_decode_plain(
        toks, total, out_cap=4 * out_cap_words, off_bits=off_bits,
        tile_bytes=None if tile_words is None else 4 * tile_words)
    return out.contiguous().view(torch.int32), cnt


def walk_decode_packed(
    toks: torch.Tensor,   # (>= total,) int32 decode words
    total: int,           # real token count T
    *,
    off_bits: int,
    out_cap_words: int,   # >= ceil((sum(len) + T) / 4)
) -> tuple[torch.Tensor, torch.Tensor]:
    """K6 wrapper: replay tokens -> (packed_words, out_len_bytes).

    ``packed_words`` is (out_cap_words,) int32 holding the decoded bytes
    four to a word, little endian, zero past the count; ``out_len_bytes``
    a (1,) int32 tensor, -1 if a token breaks a limit as in
    :func:`walk_decode` (no window, ``d_limit = 2^off_bits - 1``).  No
    priming window.  ``off_bits`` bounds how far before a tile a copy's
    source may lie.  CUDA tensors launch the kernel (or raise); CPU tensors
    run the plain version.  ``walk_decode_packed.launches`` counts launches
    and ``walk_decode_packed.scratch_bytes`` is the device-memory scratch
    of the last one.
    """
    if toks.dtype != torch.int32 or toks.dim() != 1 \
            or not toks.is_contiguous():
        raise ValueError("toks must be a contiguous 1-D int32 tensor")
    if not 0 <= total <= toks.shape[0]:
        raise ValueError(f"total {total} outside [0, {toks.shape[0]}]")
    if not 0 <= off_bits <= 16:
        raise ValueError(f"off_bits {off_bits} outside [0, 16]")
    if not 0 <= out_cap_words < (1 << 29):
        raise ValueError(f"out_cap_words {out_cap_words} outside [0, 2^29)")
    if not toks.is_cuda:
        return walk_decode_packed_plain(toks, total,
                                        out_cap_words=out_cap_words,
                                        off_bits=off_bits)
    lib = _build.kernels()
    dev = toks.device
    # the kernel writes every word, zero past the count
    out = torch.empty(out_cap_words, dtype=torch.int32, device=dev)
    cnt = torch.empty(1, dtype=torch.int32, device=dev)
    # scratch: per-block token sums, the ticket, the scan's counter and one
    # flag a tile
    sums = torch.empty(max(1, -(-total // _TOKENS_PER_BLOCK)),
                       dtype=torch.int32, device=dev)
    sync = torch.zeros(_SYNC_WORDS + -(-out_cap_words // TILE_WORDS),
                       dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.lz77_walk_decode_packed(
            toks.data_ptr(), total, out.data_ptr(), out_cap_words,
            cnt.data_ptr(), sums.data_ptr(), sync.data_ptr(), off_bits,
            TILE_WORDS, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "decode_packed_kernel")
    walk_decode_packed.launches += 1
    walk_decode_packed.scratch_bytes = 4 * (sums.numel() + sync.numel())
    return out, cnt


walk_decode_packed.launches = 0
walk_decode_packed.scratch_bytes = 0


def decode_tokens_walk_packed(
    off: np.ndarray,
    ln: np.ndarray,
    nxt: np.ndarray,
    *,
    off_bits: int,
    device: str | torch.device | None = None,
) -> bytes:
    """Decode a full token list on the device via the packed-word kernel;
    corrupt tokens raise as in :func:`decode_tokens_walk`."""
    dev = device_lib.resolve(device)
    T = int(off.shape[0])
    if T == 0:
        return b""
    toks, out_len = _checked_token_words(off, ln, nxt, off_bits, dev)
    out, cnt = walk_decode_packed(
        toks, T, off_bits=off_bits, out_cap_words=-(-out_len // 4)
    )
    n = _count(cnt, out_len, "packed walk decode")
    return out.cpu().numpy().view(np.uint8)[:n].tobytes()
