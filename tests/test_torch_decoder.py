"""Port chunked tensor decoder (lz77_tpu_torch.ops.decode, models.decoder)
against the JAX package's.

The same token fields and tails, made from a seed with numpy, go through
``lz77_tpu.ops.decode.decode_tokens`` / ``lz77_tpu.models.decoder`` and the
port's on the CPU.  Plain tensor functions, no kernel.  Tolerance 0: bytes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lz77_tpu_torch
from lz77_tpu import bitio, native, spec
from lz77_tpu.models import decoder as jax_decoder
from lz77_tpu.ops import decode as jax_decode
from lz77_tpu_torch import convert
from lz77_tpu_torch.models import codec as torch_codec
from lz77_tpu_torch.models import decoder as torch_decoder
from lz77_tpu_torch.ops import decode as torch_decode

from conftest import CORPUS_SMALL, make_text

torch.set_num_threads(1)


def _chunk(rng, la, sb, T, count):
    """``count`` consecutive tokens from the middle of a real stream in ``T``
    slots (the rest padding), and a random tail for their offsets to reach
    into."""
    p = spec.Params(la=la, sb=sb)
    data = make_text(rng, 40 * T) + b"\x00" * 500 + b"abc" * 200
    _, off, ln, nxt = bitio.parse_stream(native.encode(data, p))
    f = np.zeros((3, T), np.int32)
    for row, a in zip(f, (off, ln, nxt)):
        row[:count] = a[40 : 40 + count]
    H = (1 << p.off_bits) - 1
    return f, rng.integers(0, 256, H, dtype=np.uint8)


@pytest.mark.parametrize("la,sb,T,count", [(15, 4095, 64, 64),
                                           (15, 4095, 128, 77),
                                           (255, 255, 32, 32),
                                           (5, 31, 16, 0)])
def test_decode_tokens_and_chunk_match_jax(la, sb, T, count, rng):
    (off, ln, nxt), tail = _chunk(rng, la, sb, T, count)
    want, want_len = jax_decode.decode_tokens(
        jnp.asarray(off), jnp.asarray(ln), jnp.asarray(nxt),
        jnp.int32(count), jnp.asarray(tail), la=la,
    )
    to, tl, tn, tc, tt = convert.token_fields_from_numpy(
        off, ln, nxt, count, tail, device="cpu"
    )
    assert to.dtype == tc.dtype == torch.int32 and tt.dtype == torch.uint8
    assert tc.shape == ()
    got, got_len = torch_decode.decode_tokens(to, tl, tn, tc, tt, la=la)
    assert got.dtype == torch.uint8 and got.shape == (T * la,)
    assert int(got_len) == int(want_len) == int((ln[:count] + 1).sum())
    np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(want))

    jo, jl, jt = jax_decoder._decode_chunk(
        jnp.asarray(off), jnp.asarray(ln), jnp.asarray(nxt),
        jnp.int32(count), jnp.asarray(tail), la=la,
    )
    po, pl, pt = torch_decoder._decode_chunk(to, tl, tn, count, tt, la=la)
    assert int(pl) == int(jl)
    np.testing.assert_array_equal(convert.to_numpy(po), np.asarray(jo))
    np.testing.assert_array_equal(convert.to_numpy(pt), np.asarray(jt))


@pytest.mark.parametrize("name", sorted(CORPUS_SMALL))
def test_decode_stream_matches_jax_and_the_input(name, rng):
    """Chunks of 64 tokens: the tail rides from chunk to chunk."""
    data = CORPUS_SMALL[name](rng)
    s = native.encode(data, spec.Params())
    out = torch_decoder.decode_stream(s, 64, device="cpu")
    assert out == data
    assert out == jax_decoder.decode_stream(s, 64)
    assert torch_decoder.DEFAULT_CHUNK_TOKENS == \
        jax_decoder.DEFAULT_CHUNK_TOKENS


@pytest.mark.parametrize("la,sb", [(255, 65535), (5, 31), (8, 500), (3, 1)])
def test_decode_stream_other_parameters(la, sb, rng):
    """The widest window (tail of 65535 bytes), a width that is no byte
    multiple, and sb=1 (no offset bits: an empty tail)."""
    data = make_text(rng, 2500) + b"\x00" * 700
    s = native.encode(data, spec.Params(la=la, sb=sb))
    assert torch_decoder.decode_stream(s, 32, device="cpu") == data


def test_device_chunked_backend_agrees_with_host_and_native(rng):
    data = make_text(rng, 6000) + bytes(
        rng.integers(0, 256, 900, dtype=np.uint8)) + b"\x00" * 1500
    s = lz77_tpu_torch.compress(data, backend="native")
    st = torch_codec.DecodeStats()
    out = torch_codec.decode_bytes(
        s, backend="device-chunked", stats=st, device="cpu"
    )
    assert out == data
    assert (st.requested, st.backend) == ("device-chunked", "device-chunked")
    assert st.output_bytes == len(data) and st.input_bytes == len(s)
    for backend in ("host", "native", "device"):
        assert torch_codec.decode_bytes(s, backend=backend, device="cpu") == out
    assert lz77_tpu_torch.decompress(
        s, backend="device-chunked", device="cpu") == data
    with pytest.raises(ValueError, match="device-chunked"):
        torch_codec.decode_bytes(s, backend="auto", device="cpu")


def test_device_chunked_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    s = lz77_tpu_torch.compress(b"abcabcabc", backend="native")
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_codec.decode_bytes(s, backend="device-chunked")
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_decoder.decode_stream(s)
