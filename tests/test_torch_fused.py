"""The port's main path as a whole: fused encode and round trip against the JAX
package, the numpy spec and the native host codec.

The same bytes, made from a seed, go through
``lz77_tpu.models.fused.encode_bytes_fused(parser="scan")`` and the port's
``encode_bytes_fused`` on the CPU (the kernels' plain PyTorch versions).
Tolerance 0: streams are compared byte for byte.
"""

import numpy as np
import pytest
import torch

import lz77_tpu
import lz77_tpu_torch
from lz77_tpu import native, spec
from lz77_tpu.models import fused as jax_fused
from lz77_tpu.models import spec_np
from lz77_tpu_torch.models import codec as torch_codec
from lz77_tpu_torch.models import fused as torch_fused
from lz77_tpu_torch.ops import fused_walk

from conftest import CORPUS_SMALL, make_text

torch.set_num_threads(1)


def _jax_scan(data, params, **kw):
    return jax_fused.encode_bytes_fused(
        data, params, parser="scan", matcher="chunked", **kw
    )


@pytest.mark.parametrize("name", sorted(CORPUS_SMALL))
def test_fused_matches_jax_and_spec(rng, name):
    data = CORPUS_SMALL[name](rng)
    params = spec.Params()
    out = torch_fused.encode_bytes_fused(
        data, lz77_tpu_torch.Params(), block_size=2048, batch_blocks=2,
        sub_block=256, device="cpu",
    )
    assert out == _jax_scan(
        data, params, block_size=2048, batch_blocks=2, sub_block=256
    )
    assert out == spec_np.encode(data, params)
    assert lz77_tpu_torch.decompress(out, device="cpu") == data


def test_fused_entry_carry_across_batches(rng):
    """A long run straddling several batch boundaries forces nonzero entry
    offsets carried between batches as a tensor."""
    data = b"x" * 9000 + make_text(rng, 3000) + b"y" * 9000
    entries = [
        e_in for _, e_in, _, _, _ in torch_fused.iter_batches_fused(
            np.frombuffer(data, np.uint8), lz77_tpu_torch.Params(),
            block_size=2048, batch_blocks=2, sub_block=256, device="cpu",
        )
    ]
    assert any(entries)
    out = torch_fused.encode_bytes_fused(
        data, block_size=2048, batch_blocks=2, sub_block=256, device="cpu"
    )
    assert out == _jax_scan(
        data, spec.Params(), block_size=2048, batch_blocks=2, sub_block=256
    )


def test_fused_odd_geometry(rng):
    """Block size no multiple of anything: ragged last block and batch."""
    data = make_text(rng, 50000)
    out = torch_fused.encode_bytes_fused(
        data, block_size=10002, batch_blocks=3, sub_block=512, device="cpu"
    )
    assert out == _jax_scan(
        data, spec.Params(), block_size=10002, batch_blocks=3, sub_block=512
    )


def test_fused_default_geometry_is_block_invariant(rng):
    """Default block and batch sizes give the stream small ones give."""
    data = make_text(rng, 7000) + b"\x00" * 2000
    assert torch_fused.encode_bytes_fused(data, device="cpu") == \
        torch_fused.encode_bytes_fused(
            data, block_size=1000, batch_blocks=3, sub_block=64, device="cpu"
        )


@pytest.mark.parametrize("la,sb", [(16, 4095), (255, 255), (129, 65535)])
def test_fused_nondefault_aligned_params(la, sb, rng):
    """la=16 (24-bit, non-default) and the two deep-la sets: la=255 is past
    the TPU walk's range, la=129/sb=65535 is the widest, 32-bit token."""
    data = make_text(rng, 6000) + b"\x00" * 2500
    out = torch_fused.encode_bytes_fused(
        data, lz77_tpu_torch.Params(la=la, sb=sb), block_size=4096,
        batch_blocks=2, device="cpu",
    )
    assert out == _jax_scan(
        data, spec.Params(la=la, sb=sb), block_size=4096, batch_blocks=2
    )
    assert out == native.encode(data, spec.Params(la=la, sb=sb))
    assert lz77_tpu_torch.decompress(out, device="cpu") == data


def test_fused_rejects_unaligned_width():
    """At 25-bit tokens the walk encodes (the JAX package's fused pipeline
    refuses); the merged (K5) and scan steps refuse, as the JAX package's
    do."""
    params = lz77_tpu_torch.Params(la=17, sb=4095)  # 12+5+8 = 25 bits
    data = b"abcabcabd" * 3
    assert torch_fused.encode_bytes_fused(data, params, device="cpu") \
        == native.encode(data, spec.Params(la=17, sb=4095))
    batch = (np.array([list(b"abcabcab")], np.uint8),
             np.zeros((1, 4095), np.uint8), np.zeros((1, 16), np.uint8),
             np.zeros(1, np.int32), np.full(1, 8, np.int32), 8, 0)
    for step in (fused_walk.encode_batch_sweepwalk,
                 torch_fused.encode_batch_device):
        with pytest.raises(ValueError, match="byte-aligned"):
            step(*batch, la=17, sb=4095, device="cpu")
    with pytest.raises(ValueError, match="byte-aligned"):
        jax_fused.encode_bytes_fused(data, spec.Params(la=17, sb=4095))
    payload, _, total, exit_e, phase = torch_fused.encode_batch_walk(
        *batch, 5, la=17, sb=4095, device="cpu")
    # three literals, then (3, 4) and "b": four 25-bit tokens from bit 5,
    # so the next batch starts at bit (5 + 100) % 8 = 1
    assert (int(total), int(exit_e), int(phase)) == (4, 0, 1)
    stream = native.encode(b"abcabcab", spec.Params(la=17, sb=4095))
    bits = int.from_bytes(stream[4:], "little") << 5
    assert bytes(payload[:14].numpy()) == bits.to_bytes(14, "little")


def test_fused_roundtrip_and_backends(rng):
    """compress / decompress through the package's entry points: every
    encode backend gives one stream, every decode backend the input, and
    the two packages decode each other's streams."""
    data = make_text(rng, 12000) + bytes(
        rng.integers(0, 256, 2000, dtype=np.uint8)
    )
    s = lz77_tpu_torch.compress(data, device="cpu")
    assert s == lz77_tpu_torch.compress(data, backend="native")
    assert s == lz77_tpu.compress(data, backend="native")
    for backend in ("device", "host", "native"):
        assert lz77_tpu_torch.decompress(
            s, backend=backend, device="cpu"
        ) == data
    assert lz77_tpu.decompress(s) == data
    with pytest.raises(ValueError, match="backend"):
        lz77_tpu_torch.compress(data, backend="jax", device="cpu")


def test_fused_single_byte_equals_numpy_backend():
    assert lz77_tpu_torch.compress(b"x", device="cpu") == \
        lz77_tpu.compress(b"x", backend="numpy")
    assert lz77_tpu_torch.compress(b"x", backend="numpy") == \
        lz77_tpu.compress(b"x", backend="numpy")


def test_fused_cross_decode_oracle(oracle, rng):
    """The C reference decodes the port's stream, and is no smaller."""
    data = make_text(rng, 30000)
    out = torch_fused.encode_bytes_fused(
        data, block_size=4096, batch_blocks=2, sub_block=512, device="cpu"
    )
    assert oracle.decode(out) == data
    assert len(out) <= len(oracle.encode(data))


def test_fused_stats(rng):
    data = make_text(rng, 20000)
    st = torch_codec.EncodeStats()
    out = torch_codec.encode_bytes(
        data, block_size=4096, batch_blocks=2, sub_block=512, stats=st,
        device="cpu",
    )
    assert st.input_bytes == len(data)
    assert st.output_bytes == len(out)
    assert st.tokens == (len(out) - 4) // 3  # 24-bit tokens
    assert st.blocks == -(-len(data) // 4096)
    assert st.phases.total > 0
    assert st.h2d_bytes > len(data) and st.d2h_bytes >= len(out) - 4
    assert 0 < st.ratio < 1


# (block size, input length, first block, blocks): a batch staged as one span
SPAN_CASES = {
    "first_batch": (2048, 5 * 2048 + 700, 0, 2),    # halo before byte 0
    "resumed_batch": (2048, 5 * 2048 + 700, 2, 2),  # start_batch 1
    "short_last_block": (2048, 5 * 2048 + 700, 4, 2),
    "shorter_than_a_block": (2048, 700, 0, 1),
    "rights_past_the_end": (1000, 3 * 1000 + 5, 1, 3),
}


@pytest.mark.parametrize("la,sb", [(15, 4095), (255, 65535)])
@pytest.mark.parametrize("case", sorted(SPAN_CASES))
def test_rows_from_one_span_equal_the_batch_inputs(rng, case, la, sb):
    """The rows, halos, rights, avails and valid_exts cut from one staged
    span are ``codec._batch_inputs``'s, element for element."""
    B, n, g0, gn = SPAN_CASES[case]
    p = lz77_tpu_torch.Params(la=la, sb=sb)
    H, R = p.d_limit, p.len_limit
    x = rng.integers(0, 256, n, dtype=np.uint8)
    size = torch_fused.span_bytes(gn, B, H, R)
    buf = np.full(size + 7, 0xA5, np.uint8)  # stale bytes must not leak
    torch_fused.stage_span(x, n, g0, gn, B, H, R, buf[:size])
    got = torch_fused.rows_from_span(torch.from_numpy(buf[:size]), gn, B, H,
                                     R)
    want = torch_codec._batch_inputs(x, n, g0, gn, gn, B, H, R)
    for g, w in zip(got, want):
        assert g.is_contiguous()
        assert g.dtype == torch.from_numpy(w).dtype
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("batch_blocks", [1, 2, 3])
def test_multi_batch_encode_equals_the_native_codec(rng, batch_blocks):
    """Batches of one span each, entries chained from batch to batch, give
    the native codec's stream, and upload one span a batch."""
    data = make_text(rng, 4000) + b"\x00" * 1500 + make_text(rng, 900)
    st = torch_codec.EncodeStats()
    out = torch_fused.encode_bytes_fused(
        data, block_size=512, batch_blocks=batch_blocks, stats=st,
        device="cpu")
    assert out == native.encode(data, spec.Params())
    p = lz77_tpu_torch.Params()
    nblocks = -(-len(data) // 512)
    sizes = [min(batch_blocks, nblocks - g0)
             for g0 in range(0, nblocks, batch_blocks)]
    assert st.batches == len(sizes)
    assert st.h2d_bytes == sum(torch_fused.span_bytes(
        gn, 512, p.d_limit, p.len_limit) for gn in sizes)
    assert st.batches_overlapped == 0  # the CPU runs each batch to its end


def test_bytes_builder_fills_one_bytes_object_in_place():
    """The stream is a ``bytes`` object written in place and cut to what
    was written; the caller holds its only reference."""
    import sys

    from lz77_tpu_torch.utils import transfer

    big = np.frombuffer(bytes(range(256)) * (5 << 12), np.uint8)  # 5 MiB
    parts = [b"head", memoryview(b"abc" * 1000), big, big[::-1].copy(),
             np.arange(7, dtype=np.uint8)]
    b = transfer.BytesBuilder(16 << 20)
    for part in parts:
        b.write(part)
    out = b.finish()
    assert type(out) is bytes
    assert out == b"".join(bytes(p) for p in parts)
    assert sys.getrefcount(out) == 2  # ``out`` and the call's argument
    assert hash(out) == hash(bytes(out))
    b.close()  # finished: nothing left to free
    with transfer.BytesBuilder(64) as unfinished:
        unfinished.write(b"x" * 10)
    assert unfinished.size == 10
    with transfer.BytesBuilder(8) as small, pytest.raises(ValueError):
        small.write(b"x" * 9)  # past its capacity

