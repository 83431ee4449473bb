"""Port walk decode (lz77_tpu_torch.ops.decode_walk) against the JAX
package's host decoders.

Streams are made by ``lz77_tpu.native.encode`` from seeded inputs; the same
token arrays go through ``lz77_tpu.models.host_decode`` /
``lz77_tpu.native.decode`` and the port's ``decode_tokens_walk`` (on the
CPU, so the kernel's plain PyTorch version).  Tolerance 0: bytes.
"""

import numpy as np
import pytest
import torch

from lz77_tpu import bitio, native, spec
from lz77_tpu import bitio as jax_bitio
from lz77_tpu.models import codec as jax_codec
from lz77_tpu.models import host_decode
from lz77_tpu.models import spec_np as jax_spec_np
from lz77_tpu_torch import convert
from lz77_tpu_torch.models import codec as torch_codec
from lz77_tpu_torch.ops import decode_walk

from conftest import make_text

torch.set_num_threads(1)


def _port_decode(stream: bytes) -> bytes:
    p, off, ln, nxt = bitio.parse_stream(stream)
    return decode_walk.decode_tokens_walk(
        off, ln, nxt, off_bits=p.off_bits, device="cpu"
    )


CASES = {
    "text": (lambda rng: make_text(rng, 100_000), spec.Params()),
    "zeros_off1": (lambda rng: b"\x00" * 50_000, spec.Params()),
    "ab_off2": (lambda rng: b"ab" * 25_000, spec.Params()),
    "abc_off3": (lambda rng: b"abc" * 12_000, spec.Params()),
    "off7": (lambda rng: b"abcdefg" * 7_000, spec.Params()),
    "random": (
        lambda rng: rng.integers(0, 256, 30_000, dtype=np.uint8).tobytes(),
        spec.Params(),
    ),
    "one": (lambda rng: b"A", spec.Params()),
    "empty": (lambda rng: b"", spec.Params()),
    "la32_sb255": (lambda rng: make_text(rng, 40_000), spec.Params(32, 255)),
    "tiny_tokens": (
        lambda rng: bytes(rng.integers(0, 4, 12_000, dtype=np.uint8)),
        spec.Params(la=3, sb=255),
    ),
    "deep_la": (
        lambda rng: make_text(rng, 20_000) + b"\xff" * 9_000,
        spec.Params(la=255, sb=255),
    ),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_walk_decode_matches_host(name, rng):
    make, params = CASES[name]
    data = make(rng)
    stream = native.encode(data, params)
    got = _port_decode(stream)
    assert got == host_decode.decode(stream)
    assert got == native.decode(stream)
    assert got == data


def test_walk_decode_max_window(rng):
    """sb=65535 (off_bits=16, the CLI maximum): a shuffled page repeated at
    distance ~48k, so offsets far beyond 13 bits are really present."""
    page = rng.integers(0, 256, 48_000, dtype=np.uint8).tobytes()
    data = page + make_text(rng, 8_000) + page
    stream = native.encode(data, spec.Params(sb=65535))
    _, off, _, _ = bitio.parse_stream(stream)
    assert int(off.max()) > (1 << 13)
    assert _port_decode(stream) == native.decode(stream) == data


@pytest.mark.parametrize("frac", [0.0, 0.07, 0.5, 0.93])
def test_walk_decode_priming_window(frac, rng):
    """Split the token list at an arbitrary token; the head's output primes
    the tail's decode as ``win`` (no tile-multiple restriction on ``wp``)."""
    data = make_text(rng, 30_000) + b"\x00" * 4_000 + b"ab" * 3_000
    stream = native.encode(data, spec.Params())
    _, off, ln, nxt = bitio.parse_stream(stream)
    T = off.shape[0]
    k = max(1, int(T * frac))
    head = int((ln[:k] + 1).sum())
    toks = convert.tokens_from_numpy(off[k:], ln[k:], nxt[k:], device="cpu")
    win = torch.frombuffer(bytearray(data[:head]), dtype=torch.uint8)
    out, cnt = decode_walk.walk_decode(
        toks, T - k, out_cap=len(data) - head, win=win, wp=head
    )
    assert out.dtype == torch.uint8 and int(cnt) == len(data) - head
    assert out.numpy().tobytes() == native.decode(stream)[head:]


def test_walk_decode_short_window_suffices(rng):
    """Only the last d_limit bytes of history are ever read."""
    p = spec.Params(la=15, sb=255)
    data = make_text(rng, 20_000)
    stream = native.encode(data, p)
    _, off, ln, nxt = bitio.parse_stream(stream)
    k = off.shape[0] // 2
    head = int((ln[:k] + 1).sum())
    toks = convert.tokens_from_numpy(off[k:], ln[k:], nxt[k:], device="cpu")
    win = torch.frombuffer(
        bytearray(data[head - p.d_limit : head]), dtype=torch.uint8
    )
    out, _ = decode_walk.walk_decode(
        toks, off.shape[0] - k, out_cap=len(data) - head, win=win,
        wp=p.d_limit,
    )
    assert out.numpy().tobytes() == data[head:]


def test_walk_decode_rejects_corrupt():
    """A match reaching before the output start, or off=0 with len>0."""
    for off, ln in (([0, 300], [0, 3]), ([0, 0], [0, 2])):
        with pytest.raises(ValueError, match="corrupt"):
            decode_walk.decode_tokens_walk(
                np.array(off), np.array(ln), np.array([65, 66]),
                off_bits=12, device="cpu",
            )
    with pytest.raises(ValueError, match="off_bits"):
        decode_walk.decode_tokens_walk(
            np.array([0]), np.array([0]), np.array([65]), off_bits=17,
            device="cpu",
        )


def test_codec_decode_backends_agree(rng):
    """decode_bytes: every backend returns the input and records itself."""
    data = make_text(rng, 30_000)
    stream = native.encode(data, spec.Params())
    for backend, ran in (("device", "device-walk"), ("host", "host"),
                         ("native", "native")):
        st = torch_codec.DecodeStats()
        out = torch_codec.decode_bytes(
            stream, backend=backend, stats=st, device="cpu"
        )
        assert out == data
        assert (st.requested, st.backend) == (backend, ran)
        assert st.output_bytes == len(data)
    with pytest.raises(ValueError, match="backend"):
        torch_codec.decode_bytes(stream, backend="auto", device="cpu")


# ---- the kernel's decomposition: tiles, a priming window, the checks ----

def _windowed_case(off_bits: int, window: str):
    """(stream, data, split token, head bytes, wp) for a window of none,
    a short one (history shorter than d_limit) or d_limit bytes; the tail
    decoded after the window is a few KiB either way."""
    sb = {12: 4095, 16: 65535}[off_bits]
    p = spec.Params(la=15, sb=sb)
    rng = np.random.default_rng(off_bits)
    page = bytes(rng.integers(0, 256, 1500, dtype=np.uint8))
    tail = page + make_text(rng, 2500) + b"\x00" * 600 + b"abc" * 300 + page
    head = {"none": b"",
            "short": make_text(rng, 900) + page,
            "d_limit": make_text(rng, p.d_limit + 3000) + page}[window]
    data = head + tail
    stream = native.encode(data, p)
    _, off, ln, nxt = bitio.parse_stream(stream)
    ends = np.cumsum(ln.astype(np.int64) + 1)
    k = int(np.searchsorted(ends, len(head), side="right")) if head else 0
    h = int(ends[k - 1]) if k else 0
    wp = min(h, p.d_limit)
    return p, stream, data, (off, ln, nxt), k, h, wp


@pytest.mark.parametrize("off_bits", [12, 16])
@pytest.mark.parametrize("window", ["none", "short", "d_limit"])
@pytest.mark.parametrize("tile_bytes", [1, 16, 4096])
def test_walk_decode_plain_follows_tiles(tile_bytes, window, off_bits):
    """The plain version under the kernel's decomposition (tile-local
    pointer doubling, the window as the tile before tile 0, external roots
    in tile order) at tiles of one byte up, with no window, a short one and
    one of d_limit bytes, against the untiled replay and the JAX package's
    spec model and host decoder on the same stream."""
    p, stream, data, (off, ln, nxt), k, h, wp = _windowed_case(off_bits,
                                                               window)
    assert p.off_bits == off_bits and (wp == p.d_limit) == (window == "d_limit")
    assert (wp > 0) == (window != "none")
    want = jax_spec_np.decode(stream)
    assert want == host_decode.decode(stream) == data
    toks = convert.tokens_from_numpy(off[k:], ln[k:], nxt[k:], device="cpu")
    win = (torch.frombuffer(bytearray(data[h - wp : h]), dtype=torch.uint8)
           if wp else None)
    kw = dict(out_cap=len(data) - h, win=win, wp=wp,
              off_bits=off_bits, d_limit=p.d_limit, len_limit=p.len_limit)
    ref, cref = decode_walk.walk_decode_plain(toks, toks.shape[0], **kw)
    out, cnt = decode_walk.walk_decode_plain(toks, toks.shape[0], **kw,
                                             tile_bytes=tile_bytes)
    assert int(cnt) == int(cref) == len(data) - h
    assert torch.equal(out, ref)
    assert out.numpy().tobytes() == want[h:]


# a token list whose last token sits one past a limit, and the same token at
# the limit; 3,500 literals of history come before it
EDGES = {
    "zero_offset": (spec.Params(la=15, sb=4095), (0, 3), (1, 3)),
    "before_start": (spec.Params(la=15, sb=4095), (3501, 3), (3500, 3)),
    "beyond_d_limit": (spec.Params(la=15, sb=3000), (3001, 3), (3000, 3)),
    "beyond_len_limit": (spec.Params(la=9, sb=4095), (2, 9), (2, 8)),
}


def _edge_tokens(limit: str, broken: bool):
    p, bad, good = EDGES[limit]
    n = 3500
    off = np.zeros(n + 1, np.int64)
    ln = np.zeros(n + 1, np.int64)
    nxt = np.arange(n + 1) % 251
    off[-1], ln[-1] = bad if broken else good
    return p, off, ln, nxt


@pytest.mark.parametrize("limit", sorted(EDGES))
def test_walk_decode_checks_the_limits(limit, tmp_path):
    """Each of the four checks, from the plain version, at its edge: one
    past it the count comes back -1, with or without the history as a
    window, the whole-stream decode raises the walk decode's text (where
    its limits can express the fault) and the streamed decode the JAX
    package's text; at it the token decodes."""
    for broken in (True, False):
        p, off, ln, nxt = _edge_tokens(limit, broken)
        lim = dict(off_bits=p.off_bits, d_limit=p.d_limit,
                   len_limit=p.len_limit)
        toks = convert.tokens_from_numpy(off, ln, nxt, device="cpu")
        total = int((ln + 1).sum())
        _, cnt = decode_walk.walk_decode(toks, toks.shape[0], out_cap=total,
                                         **lim)
        assert int(cnt) == (-1 if broken else total)
        # the last token alone, its history as the window
        n = toks.shape[0] - 1
        hist = decode_walk.walk_decode(toks[:n].contiguous(), n,
                                       out_cap=n, **lim)[0]
        _, cnt = decode_walk.walk_decode(
            toks[n:].contiguous(), 1, out_cap=int(ln[-1]) + 1, win=hist,
            wp=n, **lim)
        assert int(cnt) == (-1 if broken else int(ln[-1]) + 1)
    p, off, ln, nxt = _edge_tokens(limit, True)
    if limit in ("zero_offset", "before_start"):
        with pytest.raises(ValueError, match="^corrupt stream: match "
                                             "reaches before output start$"):
            decode_walk.decode_tokens_walk(off, ln, nxt, off_bits=p.off_bits,
                                           device="cpu")
    stream = jax_bitio.build_stream(off, ln, nxt, p)
    sp = tmp_path / "c.lz"
    sp.write_bytes(stream)
    with pytest.raises(ValueError) as ref:
        jax_codec.decode_file_device(str(sp), str(tmp_path / "o"),
                                     interpret=True)
    with pytest.raises(ValueError, match="^corrupt stream: invalid token$") \
            as port:
        torch_codec.decode_file_device(str(sp), str(tmp_path / "o"),
                                       device="cpu")
    assert str(port.value) == str(ref.value)


def test_replay_constants_match_the_kernel_source():
    """The wrappers size the scan's sums and the sync words as the shared
    replay of K3 and K6 reads them, and both sources launch that replay."""
    import os

    from lz77_tpu_torch import _build

    with open(os.path.join(_build.CSRC, "decode_common.cuh")) as f:
        src = f.read()
    assert "SYNC_FLAGS = 2;" in src and decode_walk._SYNC_WORDS == 2
    assert "SCAN_THREADS = 256;" in src and "SCAN_ITEMS = 8;" in src
    assert decode_walk._TOKENS_PER_BLOCK == 256 * 8
    for name in ("decode_walk.cu", "decode_walk_packed.cu"):
        with open(os.path.join(_build.CSRC, name)) as f:
            body = f.read()
        assert '#include "decode_common.cuh"' in body
        assert "lz77::launch_replay(" in body
