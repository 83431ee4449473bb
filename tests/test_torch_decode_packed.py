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
