"""Port packed-word decode (ops.decode_walk.walk_decode_packed, K6) against
the JAX package's packed-ring walk and the numpy spec model.

The same token lists go through both packages on the CPU: the JAX side runs
its Pallas kernel in interpret mode (once, on a small stream: it replays
token by token in the interpreter), the port its plain PyTorch version.
Tolerance 0: bytes and packed words.
"""

import numpy as np
import pytest
import torch

from lz77_tpu import spec
from lz77_tpu.models import host_decode as jax_host_decode
from lz77_tpu.ops import decode_walk as jax_decode_walk
from lz77_tpu_torch import bitio, convert, native
from lz77_tpu_torch.models import spec_np
from lz77_tpu_torch.ops import decode_walk

from conftest import make_text

torch.set_num_threads(1)


def _tokens(data: bytes, params):
    p, off, ln, nxt = bitio.parse_stream(native.encode(data, params))
    return p, off, ln, nxt


def test_packed_matches_the_pallas_kernel_it_replaces(rng):
    """One small stream with every overlap class through the TPU kernel in
    interpret mode and through the port: same bytes."""
    data = (make_text(rng, 1500) + b"\x00" * 300 + b"ab" * 150 + b"abc" * 90
            + b"abcd" * 60 + b"abcdefg" * 40 + b"tail")
    p, off, ln, nxt = _tokens(data, spec.Params())
    ref = jax_decode_walk.decode_tokens_walk_packed(
        off.astype(np.int32), ln.astype(np.int32), nxt.astype(np.int32),
        off_bits=p.off_bits, tchunk=256, interpret=True,
    )
    got = decode_walk.decode_tokens_walk_packed(
        off, ln, nxt, off_bits=p.off_bits, device="cpu"
    )
    assert got == ref == data


PACKED_CASES = [
        ("text", None, spec.Params()),                  # filled by rng below
        ("zeros", b"\x00" * 60_000, spec.Params()),     # off=1 splat
        ("off2", b"ab" * 20_000, spec.Params()),        # off=2 serial path
        ("off3", b"abc" * 12_000, spec.Params()),       # off=3 serial path
        ("off4", b"abcd" * 12_000, spec.Params()),      # off=4 word boundary
        ("off7", b"abcdefg" * 7_000, spec.Params()),    # misaligned funnel
        ("wide", None, spec.Params(la=15, sb=65535)),   # 128 KiB ring
        ("deep", b"abcdefghijk" * 3_000, spec.Params(la=255, sb=4095)),
        ("tiny", b"x", spec.Params()),
]


@pytest.mark.parametrize("name,data,params", PACKED_CASES,
                         ids=[c[0] for c in PACKED_CASES])
def test_packed_decode_bit_exact(name, data, params, rng):
    """The cases of the JAX package's packed-ring test, against the numpy
    spec model's decode of the same stream."""
    if data is None:
        data = make_text(rng, 120_000 if name == "wide" else 30_000)
    stream = native.encode(data, params)
    p, off, ln, nxt = bitio.parse_stream(stream)
    got = decode_walk.decode_tokens_walk_packed(
        off, ln, nxt, off_bits=p.off_bits, device="cpu"
    )
    if len(data) <= 30_000:
        assert got == spec_np.decode(stream)
    assert got == data


def test_packed_words_layout_and_count(rng):
    """Four bytes a word, little endian, zero past the count; the count is
    a (1,) int32 tensor; the parallel kernel's wrapper gives the same bytes."""
    data = make_text(rng, 4099) + b"\xff\x80\x01"
    p, off, ln, nxt = _tokens(data, spec.Params())
    toks = convert.tokens_from_numpy(off, ln, nxt, device="cpu")
    T = toks.shape[0]
    words, cnt = decode_walk.walk_decode_packed(
        toks, T, off_bits=p.off_bits, out_cap_words=1100
    )
    assert words.dtype == torch.int32 and words.shape == (1100,)
    assert cnt.dtype == torch.int32 and cnt.shape == (1,)
    assert int(cnt) == len(data)
    raw = words.numpy().view(np.uint8)
    assert raw[: len(data)].tobytes() == data
    assert not raw[len(data):].any()
    u = words.numpy().view(np.uint32)
    assert int(u[0]) == int.from_bytes(data[:4], "little")
    ref, _ = decode_walk.walk_decode(toks, T, out_cap=len(data))
    assert ref.numpy().tobytes() == data
    assert decode_walk.walk_decode_packed.launches == 0  # CPU: plain version


def test_packed_empty_and_validation():
    assert decode_walk.decode_tokens_walk_packed(
        np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.int64),
        off_bits=12, device="cpu") == b""
    toks = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        decode_walk.walk_decode_packed(toks.long(), 4, off_bits=12,
                                       out_cap_words=8)
    with pytest.raises(ValueError, match="total"):
        decode_walk.walk_decode_packed(toks, 5, off_bits=12, out_cap_words=8)
    with pytest.raises(ValueError, match="off_bits"):
        decode_walk.walk_decode_packed(toks, 4, off_bits=17, out_cap_words=8)


@pytest.mark.parametrize(
    "off,ln",
    [([0, 300], [0, 3]),   # reaches before the output start
     ([0, 0], [0, 2])],    # off == 0 with a length
    ids=["before_start", "zero_offset"],
)
def test_packed_rejects_corrupt_tokens_before_launch(off, ln):
    with pytest.raises(ValueError, match="corrupt stream"):
        decode_walk.decode_tokens_walk_packed(
            np.array(off), np.array(ln), np.array([65, 66]), off_bits=12,
            device="cpu",
        )


# ---- the kernel's decomposition: tiles, external roots, tile order ----

def _random_tokens(seed: int, n_tokens: int, la: int, max_off: int,
                   short_offs: bool = False):
    """A valid token list made with numpy from a seed: lengths in
    [0, la - 1], offsets in [1, min(position, max_off)]."""
    rng = np.random.default_rng(seed)
    off = np.zeros(n_tokens, np.int64)
    ln = rng.integers(0, la, n_tokens)
    nxt = rng.integers(0, 256, n_tokens)
    pos = 0
    for i in range(n_tokens):
        if pos == 0:
            ln[i] = 0
        if ln[i]:
            hi = min(pos, 3 if short_offs else max_off)
            off[i] = rng.integers(1, hi + 1)
            if not short_offs and rng.integers(0, 4) == 0:
                off[i] = hi  # as far back as the stream allows
        pos += ln[i] + 1
    return off, ln, nxt


def _far_tokens():
    """300 literals, copies that push the output past 65535 bytes, then
    copies whose source lies 65535 back: two and more tiles away."""
    rng = np.random.default_rng(65535)
    off = [0] * 300
    ln = [0] * 300
    pos = 300
    while pos <= 66_000:
        off.append(int(rng.integers(1, 301)))
        ln.append(254)
        pos += 255
    for k in range(40):
        off.append(65535 - (k % 2))
        ln.append(int(rng.integers(1, 255)))
    T = len(off)
    return (np.array(off, np.int64), np.array(ln, np.int64),
            rng.integers(0, 256, T))


def _off1_tokens():
    """One literal, then off == 1 copies of 254 bytes (the longest the
    format has): each crosses many small tiles."""
    T = 9
    return (np.array([0] + [1] * (T - 1), np.int64),
            np.array([0] + [254] * (T - 1), np.int64),
            np.arange(65, 65 + T, dtype=np.int64))


TILED_TOKEN_CASES = {
    "random_la15": lambda: _random_tokens(1, 700, 15, 4095),
    "random_la255": lambda: _random_tokens(2, 60, 255, 65535),
    "off_1_2_3": lambda: _random_tokens(3, 500, 15, 3, short_offs=True),
    "off1_len254": _off1_tokens,
    "off65535": _far_tokens,
    "literals": lambda: _random_tokens(4, 300, 1, 1),
}


@pytest.mark.parametrize("tile_words", [1, 16, 1024, None])
@pytest.mark.parametrize("case", sorted(TILED_TOKEN_CASES))
def test_packed_plain_follows_tiles(case, tile_words):
    """The plain version under the kernel's decomposition (tile-local
    pointer doubling, then external roots in tile order), at tiles from one
    word up and untiled, against the JAX package's host replay of the same
    tokens.  Tokens straddle tiles at every small tile size."""
    off, ln, nxt = TILED_TOKEN_CASES[case]()
    want = jax_host_decode.decode_tokens_np(off, ln, nxt)
    toks = convert.tokens_from_numpy(off, ln, nxt, device="cpu")
    words = -(-len(want) // 4) + 3
    out, cnt = decode_walk.walk_decode_packed_plain(
        toks, toks.shape[0], out_cap_words=words, tile_words=tile_words)
    assert out.dtype == torch.int32 and out.shape == (words,)
    assert int(cnt) == len(want)
    raw = out.numpy().view(np.uint8)
    assert raw[: len(want)].tobytes() == want
    assert not raw[len(want):].any()


@pytest.mark.parametrize("tile_words", [1, 16, 1024, None])
@pytest.mark.parametrize("residue", [0, 1, 2, 3])
def test_packed_plain_every_length_residue(residue, tile_words, rng):
    """Output lengths of every residue mod 4: the last word's bytes past
    the count are zero, under every tiling."""
    data = make_text(rng, 1996 + residue) + b"\xff\x80\x01\x7f"
    assert len(data) % 4 == residue
    p, off, ln, nxt = _tokens(data, spec.Params())
    assert jax_host_decode.decode_tokens_np(off, ln, nxt) == data
    toks = convert.tokens_from_numpy(off, ln, nxt, device="cpu")
    words = -(-len(data) // 4)
    out, cnt = decode_walk.walk_decode_packed_plain(
        toks, toks.shape[0], out_cap_words=words, tile_words=tile_words)
    raw = out.numpy().view(np.uint8)
    assert int(cnt) == len(data) and raw[: len(data)].tobytes() == data
    assert not raw[len(data):].any()


@pytest.mark.parametrize("tile_words", [1, 16, 1024])
def test_packed_plain_short_output_drops_tokens_alike(tile_words, rng):
    """``out_cap_words`` smaller than the stream needs: the tokens that do
    not fit whole are dropped, the same under every tiling, and the count
    still covers every token."""
    data = make_text(rng, 3000)
    p, off, ln, nxt = _tokens(data, spec.Params())
    toks = convert.tokens_from_numpy(off, ln, nxt, device="cpu")
    for words in (0, 1, 100, 333):
        ref, cref = decode_walk.walk_decode_packed_plain(
            toks, toks.shape[0], out_cap_words=words)
        out, cnt = decode_walk.walk_decode_packed_plain(
            toks, toks.shape[0], out_cap_words=words, tile_words=tile_words)
        assert torch.equal(out, ref) and int(cnt) == int(cref) == len(data)
        raw = out.numpy().view(np.uint8)
        kept = int(np.flatnonzero(raw)[-1]) + 1 if raw.any() else 0
        assert raw[:kept].tobytes() == data[:kept] and kept <= 4 * words


def test_packed_plain_rejects_bad_tile():
    with pytest.raises(ValueError, match="tile_words"):
        decode_walk.walk_decode_packed_plain(
            torch.zeros(1, dtype=torch.int32), 1, out_cap_words=1,
            tile_words=0)
