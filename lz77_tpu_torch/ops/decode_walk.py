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
``lz77_tpu/ops/decode_walk.py::_kernel_packed``: the same replay with four
decoded bytes per int32 ring word, word-wide copies through a funnel shift,
packed int32 output and no priming.  That kernel is the serial replay at
word granularity and the port keeps it serial, because that is what it
computes: one thread block, the ring in shared memory (``2^(off_bits+1)``
bytes, at least 8 KiB, 128 KiB at sb=65535), one warp replaying the tokens
in order with up to ``off/4`` lanes copying words at once, the whole block
writing finished ring words out.  It is bound by the latency of its serial
chain, far from its contract's bytes; what it has that the parallel kernel
lacks is memory (no 4-byte pointer per output byte).  The parallel kernel
stays the decode backend; this one is reached through
:func:`decode_tokens_walk_packed`, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .. import device as device_lib

_TOKENS_PER_BLOCK = 2048  # CHUNK of csrc/decode_walk.cu


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


def walk_decode_plain(
    toks: torch.Tensor,
    total: int,
    *,
    out_cap: int,
    win: torch.Tensor | None = None,
    wp: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: positions by cumsum, copies by pointer doubling.

    Every output byte is a literal (value known) or a copy of the byte
    ``off`` positions earlier, a parent pointer; doubling collapses each
    chain to its literal (or history) root, overlapping copies included.
    A pointer that leaves the buffer, or a copy with ``off == 0``, reads 0.
    """
    dev = toks.device
    W = wp + out_cap
    val = torch.zeros(W, dtype=torch.uint8, device=dev)
    if wp:
        val[:wp] = win
    if total == 0:
        return val[wp:], torch.zeros(1, dtype=torch.int32, device=dev)
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
    pos = torch.arange(W, dtype=torch.int64, device=dev)
    delta = pos - (wp + starts[tok_of])
    done = wp + torch.where(fits, ends, 0).max()
    fixed = (pos < wp) | (pos >= done) | (delta == ln[tok_of])
    ptr = torch.where(fixed, pos, pos - off[tok_of])
    # a source before the history reads 0: point it at itself (copy
    # positions hold 0 in val)
    ptr = torch.where(ptr < 0, pos, ptr)
    while True:
        nxt_ptr = ptr[ptr]
        if torch.equal(nxt_ptr, ptr):
            break
        ptr = nxt_ptr
    cnt = ends[-1].to(torch.int32).reshape(1)
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
    counts launches.
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
    return buf[wp:], cnt


walk_decode.launches = 0


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


def walk_decode_packed_plain(
    toks: torch.Tensor, total: int, *, out_cap_words: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the packed replay: the pointer-doubling
    replay of :func:`walk_decode_plain`, zero-padded to whole words and
    viewed as little-endian int32."""
    out, cnt = walk_decode_plain(toks, total, out_cap=4 * out_cap_words)
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
    a (1,) int32 tensor.  No priming window.  CUDA tensors launch the
    kernel (or raise); CPU tensors run the plain version.
    ``walk_decode_packed.launches`` counts launches.
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
    out = torch.zeros(out_cap_words, dtype=torch.int32, device=dev)
    cnt = torch.empty(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.lz77_walk_decode_packed(
            toks.data_ptr(), total, out.data_ptr(), out_cap_words,
            cnt.data_ptr(), off_bits,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "decode_packed_kernel")
    walk_decode_packed.launches += 1
    return out, cnt


walk_decode_packed.launches = 0


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
