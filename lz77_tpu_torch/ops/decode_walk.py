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

Kernel note — ``csrc/decode_walk.cu`` replaces the TPU kernel
``lz77_tpu/ops/decode_walk.py::_kernel``.  That kernel replays the tokens
one by one on the scalar unit and keeps the window in a ring of scalar
memory, one byte per word, because its vector units cannot gather; the ring
capped ``off_bits`` and forced tile-multiple priming windows.  Hopper
gathers, so here the replay is parallel: the output buffer in device memory
is the window (every ``off_bits`` a header allows takes the same path,
``wp`` is any length, the output is uint8), a scan of ``len+1`` places the
tokens, every copy byte gets a parent pointer ``start - off + (q mod off)``
— wholly before its token, so overlapping copies cost no hop — and
pointer-jumping rounds collapse the chains to their literal (or history)
roots before one gather writes the bytes.  The kernel is bound by bytes it
moves many times over (4 B of pointer per output byte, read and written
each round), not by its contract's bytes (4 B read per token, 1 B written
per output byte) and not by operations; the design keeps the rounds to
what this stream's deepest chain needs (a flag lets the rest return at
once) and the pointers to 32 bits.  A first design — one warp replaying
the tokens in order, lanes sharing one copy — was right but took a round
trip to L2 per copy token; its time stands in PERF.md.

Packed variant — ``csrc/decode_walk_packed.cu`` replaces the TPU kernel
``lz77_tpu/ops/decode_walk.py::_kernel_packed``: the same replay with packed
int32 output (four bytes a word, little endian) and no priming.  That kernel
replays the tokens one after another through a ring of packed words; the
port's contract is the same and its mechanism is not.  A serial replay is
bound by the latency of one chain of dependent operations on one warp of
one SM (the port's first form of this kernel was that, and its time stands
in PERF.md); the parallel kernel above is bound by the 4-byte parent pointer
per output byte that it reads and writes in device memory every round.  The
packed kernel keeps the parallel replay and moves the pointers into shared
memory: one thread block per tile of ``TILE_WORDS`` output words builds the
tile's parent pointers there (relative to the tile; a source before the tile
is an *external* root), collapses them by pointer jumping without leaving
the SM, all tiles at once, and only then takes its external bytes from the
output words the earlier tiles have stored, in tile order.  Only the last
``2^off_bits + 256`` bytes before a tile can be its source, so a tile
stores that tail first and raises a flag, and the tile after it waits for
nothing else; a tail that needs nothing from outside does not wait at all.
Device-memory scratch is the per-block token sums, one flag per tile and a
ticket: nothing that grows with the output bytes.  The parallel kernel stays
the decode backend; this one is reached through
:func:`decode_tokens_walk_packed`, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .. import device as device_lib

_TOKENS_PER_BLOCK = 2048  # SCAN_CHUNK of csrc/decode_common.cuh


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


def _replay_pointers(toks, total: int, out_cap: int, win, wp: int):
    """Values and parent pointers of the replay over ``wp`` history bytes
    and ``out_cap`` output bytes -> (val uint8, ptr int64, cnt int32 (1,)).

    ``val`` holds the history and every literal, 0 elsewhere.  ``ptr[j]`` is
    ``j`` for a root (history, literal, a byte no token covers, a copy with
    ``off == 0`` or a source before the history: those read 0) and for copy
    byte ``q`` of a token the parent ``start - off + (q mod off)``, which
    lies before the token, so an overlapping copy costs no hop.
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
    return val, ptr, ends[-1].to(torch.int32).reshape(1)


def walk_decode_plain(
    toks: torch.Tensor,
    total: int,
    *,
    out_cap: int,
    win: torch.Tensor | None = None,
    wp: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: positions by cumsum, copies by pointer doubling.

    Every output byte is a literal (value known) or a copy of an earlier
    byte, a parent pointer (:func:`_replay_pointers`); doubling collapses
    each chain to its literal (or history) root, overlapping copies
    included.  A pointer that leaves the buffer, or a copy with
    ``off == 0``, reads 0.
    """
    val, ptr, cnt = _replay_pointers(toks, total, out_cap, win, wp)
    while True:
        nxt_ptr = ptr[ptr]
        if torch.equal(nxt_ptr, ptr):
            break
        ptr = nxt_ptr
    return val[ptr][wp:], cnt


def walk_decode(
    toks: torch.Tensor,   # (>= total,) int32 decode words
    total: int,           # real token count T
    *,
    out_cap: int,         # output bytes: sum(len) + T
    win: torch.Tensor | None = None,  # (wp,) uint8 history bytes
    wp: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K3 wrapper: replay tokens -> (bytes, out_len).

    ``bytes`` is (out_cap,) uint8; ``out_len`` a (1,) int32 tensor holding
    the cursor after the last token.  CUDA tensors launch the kernel (or
    raise); CPU tensors run the plain version.  ``walk_decode.launches``
    counts launches; ``walk_decode.scratch_bytes`` is the device-memory
    scratch of the last one.
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
                or win.device != toks.device:
            raise ValueError("win must be a (wp,) uint8 tensor beside toks")
    elif win is not None and win.shape[0]:
        raise ValueError("win given but wp == 0")
    if not toks.is_cuda:
        return walk_decode_plain(toks, total, out_cap=out_cap, win=win, wp=wp)
    lib = _build.kernels()
    dev = toks.device
    # history and output share one buffer, so a source index below 0 is
    # just an earlier byte of it; zeroed, as malformed tokens copy nothing
    buf = torch.zeros(wp + out_cap, dtype=torch.uint8, device=dev)
    if wp:
        buf[:wp] = win
    cnt = torch.empty(1, dtype=torch.int32, device=dev)
    # scratch: per-block token sums, one parent pointer per byte, and one
    # "changed" flag per pointer-jumping round (chains hop from token to
    # earlier token, so 1 + bits(T) rounds always suffice)
    rounds = 1 + total.bit_length()
    sums = torch.empty(-(-total // _TOKENS_PER_BLOCK), dtype=torch.int32,
                       device=dev)
    ptr = torch.empty(wp + out_cap, dtype=torch.int32, device=dev)
    flags = torch.zeros(rounds, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.lz77_walk_decode(
            toks.data_ptr(), total, buf.data_ptr(), wp, out_cap,
            cnt.data_ptr(), sums.data_ptr(), ptr.data_ptr(),
            flags.data_ptr(), rounds,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "walk_decode_kernel")
    walk_decode.launches += 1
    walk_decode.scratch_bytes = 4 * (sums.numel() + ptr.numel()
                                     + flags.numel())
    return buf[wp:], cnt


walk_decode.launches = 0
walk_decode.scratch_bytes = 0


def _checked_token_words(off, ln, nxt, off_bits: int, dev):
    """Validate a full token list on the host -> (decode words on ``dev``,
    output length).  A match that reaches before the output start, or has
    ``off == 0``, raises before anything is launched."""
    if off_bits > 16:
        raise ValueError(
            f"decode token words hold 16 offset bits, got off_bits={off_bits}"
        )
    sz = ln.astype(np.int64) + 1
    starts = np.cumsum(sz) - sz
    out_len = int(starts[-1] + sz[-1])
    o64 = off.astype(np.int64)
    if ((ln > 0) & ((o64 == 0) | (o64 > starts))).any():
        raise ValueError("corrupt stream: match reaches before output start")
    return torch.from_numpy(pack_token_words(off, ln, nxt)).to(dev), out_len


def decode_tokens_walk(
    off: np.ndarray,
    ln: np.ndarray,
    nxt: np.ndarray,
    *,
    off_bits: int,
    device: str | torch.device | None = None,
) -> bytes:
    """Decode a full token list on the device via the walk kernel."""
    dev = device_lib.resolve(device)
    T = int(off.shape[0])
    if T == 0:
        return b""
    toks, out_len = _checked_token_words(off, ln, nxt, off_bits, dev)
    out, cnt = walk_decode(toks, T, out_cap=out_len)
    n = int(cnt)
    if n != out_len:
        raise RuntimeError(f"walk decode wrote {n} bytes, expected {out_len}")
    return out.cpu().numpy().tobytes()


TILE_WORDS = 12288  # output words per thread block of the packed kernel


def walk_decode_packed_plain(
    toks: torch.Tensor, total: int, *, out_cap_words: int,
    tile_words: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the packed replay, zero-padded to whole
    words and viewed as little-endian int32.

    ``tile_words=None``: the pointer-doubling replay of
    :func:`walk_decode_plain` over the whole output.  With ``tile_words``
    it follows the kernel's decomposition: pointer doubling confined to
    tiles of that many words (a parent before its tile makes the byte an
    external root of the tile), all tiles at once, then tile by tile in
    order every byte takes its root's value, or for an external root the
    byte that an earlier tile has already written.
    """
    if tile_words is None:
        out, cnt = walk_decode_plain(toks, total, out_cap=4 * out_cap_words)
        return out.contiguous().view(torch.int32), cnt
    if tile_words < 1:
        raise ValueError(f"tile_words {tile_words} must be positive")
    n = 4 * out_cap_words
    tb = 4 * tile_words
    val, ptr, cnt = _replay_pointers(toks, total, n, None, 0)
    pos = torch.arange(n, dtype=torch.int64, device=toks.device)
    inside = ptr >= pos // tb * tb  # a root points at itself: inside
    loc = torch.where(inside, ptr, pos)
    while True:  # every chain ends at a root of its own tile
        nxt_loc = loc[loc]
        if torch.equal(nxt_loc, loc):
            break
        loc = nxt_loc
    external = ~inside[loc]
    src = torch.where(external, ptr[loc], loc)
    out = val.clone()
    for t0 in range(0, n, tb):  # the hand-off: earlier tiles are final
        sl = slice(t0, min(t0 + tb, n))
        out[sl] = torch.where(external[sl], out[src[sl]], val[src[sl]])
    return out.view(torch.int32), cnt


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
    a (1,) int32 tensor.  No priming window.  ``off_bits`` bounds how far
    before a tile a copy's source may lie.  CUDA tensors launch the kernel
    (or raise); CPU tensors run the plain version.
    ``walk_decode_packed.launches`` counts launches and
    ``walk_decode_packed.scratch_bytes`` is the device-memory scratch of
    the last one.
    """
    if toks.dtype != torch.int32 or toks.dim() != 1 \
            or not toks.is_contiguous():
        raise ValueError("toks must be a contiguous 1-D int32 tensor")
    if not 0 <= total <= toks.shape[0]:
        raise ValueError(f"total {total} outside [0, {toks.shape[0]}]")
    if not 1 <= off_bits <= 16:
        raise ValueError(f"off_bits {off_bits} outside [1, 16]")
    if not 0 <= out_cap_words < (1 << 29):
        raise ValueError(f"out_cap_words {out_cap_words} outside [0, 2^29)")
    if not toks.is_cuda:
        return walk_decode_packed_plain(toks, total,
                                        out_cap_words=out_cap_words)
    lib = _build.kernels()
    dev = toks.device
    # the kernel writes every word, zero past the count
    out = torch.empty(out_cap_words, dtype=torch.int32, device=dev)
    cnt = torch.empty(1, dtype=torch.int32, device=dev)
    # scratch: per-block token sums, the tiles' ticket and one flag a tile
    sums = torch.empty(-(-total // _TOKENS_PER_BLOCK), dtype=torch.int32,
                       device=dev)
    sync = torch.zeros(1 + -(-out_cap_words // TILE_WORDS),
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
    """Decode a full token list on the device via the packed-word kernel."""
    dev = device_lib.resolve(device)
    T = int(off.shape[0])
    if T == 0:
        return b""
    toks, out_len = _checked_token_words(off, ln, nxt, off_bits, dev)
    out, cnt = walk_decode_packed(
        toks, T, off_bits=off_bits, out_cap_words=-(-out_len // 4)
    )
    n = int(cnt)
    if n != out_len:
        raise RuntimeError(
            f"packed walk decode wrote {n} bytes, expected {out_len}"
        )
    return out.cpu().numpy().view(np.uint8)[:n].tobytes()
