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
from lz77_tpu.models import host_decode
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
