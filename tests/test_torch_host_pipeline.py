"""Port host-parse pipeline (models.encoder, codec.iter_block_bits,
encode_bytes(pipeline="host")) against the JAX package's.

The same numpy inputs, made from a seed, go through both packages on the
CPU (the port's kernels run as their plain PyTorch versions).  Tolerance 0:
tables, token counts and streams are integers and bytes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lz77_tpu import spec
from lz77_tpu.models import codec as jax_codec
from lz77_tpu.models import encoder as jax_encoder
from lz77_tpu_torch import convert, native
from lz77_tpu_torch.models import codec, encoder, spec_np
from lz77_tpu_torch.utils import faults

from conftest import make_text

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def payload(rng):
    return (
        make_text(rng, 20_000) + b"\x00" * 3_000
        + np.asarray(rng.integers(0, 256, 2_000, dtype=np.uint8)).tobytes()
        + b"ab" * 1_500
    )


def _batch(x, p, B, G):
    return codec._batch_inputs(x, x.shape[0], 0, G, G, B, p.d_limit,
                               p.len_limit)


@pytest.mark.parametrize("la,sb", [(15, 255), (17, 300), (16, 63)])
def test_match_blocks_compact_matches_jax(la, sb, payload):
    """Nibble packing at la <= 16, bytes above; uint16 offsets."""
    p = spec.Params(la=la, sb=sb)
    x = np.frombuffer(payload, np.uint8)[:8192]
    arrs = _batch(x, p, 2048, 4)
    ref_packed, ref_o16 = jax_encoder.match_blocks_compact(
        *(jnp.asarray(a) for a in arrs), la=la, sb=sb, matcher="chunked"
    )
    ref_packed, ref_o16 = np.asarray(ref_packed), np.asarray(ref_o16)
    for matcher in ("sweep", "chunk"):
        packed, o16 = encoder.match_blocks_compact(
            *(torch.from_numpy(a) for a in arrs), la=la, sb=sb,
            matcher=matcher,
        )
        assert packed.dtype == torch.uint8 and o16.dtype == torch.int16
        np.testing.assert_array_equal(packed.numpy(), ref_packed)
        np.testing.assert_array_equal(
            o16.numpy().view(np.uint16), ref_o16
        )
    # the JAX package's compact outputs convert to the port's tensors
    cp, co = convert.compact_from_numpy(ref_packed, ref_o16, device="cpu")
    assert torch.equal(cp, packed) and torch.equal(co, o16)
    # full tables agree with the compact ones
    L, O = encoder.match_blocks(
        *(torch.from_numpy(a) for a in arrs), la=la, sb=sb
    )
    for i in range(4):
        np.testing.assert_array_equal(
            encoder.unpack_lengths(ref_packed[i], 2048, la),
            L[i].numpy().astype(np.uint8),
        )
        np.testing.assert_array_equal(
            jax_encoder.unpack_lengths(ref_packed[i], 2048, la),
            encoder.unpack_lengths(packed[i].numpy(), 2048, la),
        )
    np.testing.assert_array_equal(O.numpy(), ref_o16.astype(np.int32))


def test_gather_offsets_matches_jax(rng):
    """Offsets above 32767 survive the 16-bit table (sb = 65535)."""
    O = rng.integers(0, 65536, (3, 64)).astype(np.uint16)
    O[0, 0], O[2, 63] = 65535, 32768
    idx = rng.integers(0, 3 * 64, 50).astype(np.int32)
    idx[:2] = (0, 3 * 64 - 1)
    ref = np.asarray(jax_encoder.gather_offsets(jnp.asarray(O),
                                                jnp.asarray(idx)))
    _, o16 = convert.compact_from_numpy(np.zeros((3, 64), np.uint8), O, "cpu")
    got = encoder.gather_offsets(o16, torch.from_numpy(idx))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int32))


def test_native_pack_helpers_match_bitio(rng):
    """The bound C helpers against the numpy bit codec: whole-byte packing,
    packing from a bit phase, and unpacking."""
    from lz77_tpu_torch import bitio

    for p in (spec.Params(), spec.Params(8, 500), spec.Params(9, 511)):
        T = 37
        off = rng.integers(0, p.d_limit + 1, T)
        ln = rng.integers(0, p.len_limit + 1, T)
        nxt = rng.integers(0, 256, T)
        bits = bitio.tokens_to_bits(off, ln, nxt, p)
        want = np.packbits(bits, bitorder="little")
        got, nbits = native.pack_tokens(off, ln, nxt, p)
        assert nbits == T * p.width
        np.testing.assert_array_equal(got, want)
        for phase in (0, 3, 7):
            out, nb = native.pack_tokens_phase(off, ln, nxt, p, phase)
            assert nb == T * p.width
            np.testing.assert_array_equal(
                out, np.packbits(np.concatenate(
                    [np.zeros(phase, np.uint8), bits]), bitorder="little"))
        o2, l2, n2 = native.unpack_tokens(want, p)
        np.testing.assert_array_equal(o2[:T], off)
        np.testing.assert_array_equal(l2[:T], ln)
        np.testing.assert_array_equal(n2[:T], nxt)


@pytest.mark.parametrize("entry", [0, 3, 14])
def test_parse_block_np_matches_native(entry, rng):
    L = rng.integers(0, 15, 500).astype(np.uint8)
    for valid in (500, 377, 10):
        s1, e1 = codec.parse_block_np(L, valid, entry, 15)
        s2, e2 = native.parse_block(L, valid, entry)
        s3, e3 = jax_codec.parse_block_np(L, valid, entry, 15)
        np.testing.assert_array_equal(s1, s2)
        np.testing.assert_array_equal(s1, s3)
        assert e1 == e2 == e3


@pytest.mark.parametrize(
    "la,sb,matcher",
    [
        (255, 255, "sweep"),   # 24-bit tokens, byte-aligned
        (255, 255, "chunk"),
        (15, 15, "chunk"),     # 16-bit tokens, byte-aligned
        (8, 500, "chunk"),     # 20-bit tokens
        (8, 500, "sweep"),
        (9, 511, "pallas"),    # 21-bit tokens, the JAX alias
        (17, 300, "chunk"),    # lengths not nibble-packed
    ],
)
def test_encode_bytes_host_matches_jax(la, sb, matcher, payload):
    p = spec.Params(la=la, sb=sb)
    ref = jax_codec.encode_bytes(
        payload, p, block_size=4096, batch_blocks=4, matcher="chunked"
    )
    st = codec.EncodeStats()
    got = codec.encode_bytes(
        payload, p, pipeline="host", block_size=4096, batch_blocks=4,
        matcher=matcher, stats=st, device="cpu",
    )
    assert got == ref
    assert native.decode(got) == payload
    assert st.blocks == -(-len(payload) // 4096)
    assert st.tokens == spec.token_count(len(got) - 4, p.width)
    assert st.h2d_bytes > len(payload) and st.d2h_bytes > 0
    assert st.phases.parse > 0 and st.phases.pack > 0


@pytest.mark.parametrize("block_size,batch_blocks",
                         [(1024, 1), (2048, 3), (8192, 8), (None, 8)])
def test_host_pipeline_is_block_invariant(block_size, batch_blocks, payload):
    """Any block and batch geometry gives the serial parse's stream."""
    p = spec.Params(la=8, sb=129)
    data = payload[:9001]  # odd length: the default block rounds up to even
    got = codec.encode_bytes(
        data, p, pipeline="host", block_size=block_size,
        batch_blocks=batch_blocks, device="cpu",
    )
    assert got == spec_np.encode(data, p)


@pytest.mark.parametrize("data", [b"", b"A", b"abcdabcdabcdab"],
                         ids=["empty", "one", "fourteen"])
def test_host_pipeline_edge_inputs(data):
    for p in (spec.Params(), spec.Params(8, 500)):
        got = codec.encode_bytes(data, p, pipeline="host", device="cpu")
        assert got == jax_codec.encode_bytes(data, p)


def test_host_pipeline_retries_injected_faults(payload):
    p = spec.Params(la=15, sb=63)
    data = payload[:12_000]
    ref = spec_np.encode(data, p)
    inj = faults.FaultInjector({1: 2})
    st = codec.EncodeStats()
    got = codec.encode_bytes(
        data, p, pipeline="host", block_size=2048, batch_blocks=2,
        fault_injector=inj, retries=2, stats=st, device="cpu",
    )
    assert got == ref
    assert st.retries == 2 and inj.calls.count(1) == 3
    with pytest.raises(RuntimeError, match="injected fault"):
        codec.encode_bytes(
            data, p, pipeline="host", block_size=2048, batch_blocks=2,
            fault_injector=faults.FaultInjector({1: 3}), retries=2,
            device="cpu",
        )


def test_iter_block_bits_resumes_from_a_batch_boundary(payload):
    """start_block/entry continue a stream exactly where the records of
    the first run stop."""
    p = spec.Params(la=15, sb=63)
    x = np.frombuffer(payload[:16_000], np.uint8)
    kw = dict(block_size=2048, batch_blocks=2, device="cpu")
    full = list(codec.iter_block_bits(x, p, **kw))
    assert [r[0] for r in full] == list(range(8))
    tail = list(codec.iter_block_bits(
        x, p, start_block=4, entry=full[3][2], **kw))
    assert len(tail) == 4
    for a, b in zip(full[4:], tail):
        assert a[:4] == b[:4]
        np.testing.assert_array_equal(a[4], b[4])


def test_host_pipeline_rejects_bad_geometry_and_names(payload):
    x = np.frombuffer(payload[:4096], np.uint8)
    p = spec.Params()
    with pytest.raises(ValueError, match="even"):
        list(codec.iter_block_bits(x, p, block_size=1023, device="cpu"))
    with pytest.raises(ValueError, match="multiple of batch_blocks"):
        list(codec.iter_block_bits(x, p, block_size=1024, batch_blocks=4,
                                   start_block=2, device="cpu"))
    with pytest.raises(ValueError, match="unknown matcher"):
        list(codec.iter_block_bits(x, p, matcher="nope", device="cpu"))
    # the JAX package's default matcher name runs here too
    got = list(codec.iter_block_bits(x, p, block_size=1024, matcher="chunked",
                                     device="cpu"))
    want = list(codec.iter_block_bits(x, p, block_size=1024, device="cpu"))
    assert len(got) == len(want) and all(
        g[:4] == w[:4] and np.array_equal(g[4], w[4])
        for g, w in zip(got, want))
    with pytest.raises(ValueError, match="unknown pipeline"):
        codec.encode_bytes(b"abc", p, pipeline="sharded", device="cpu")
