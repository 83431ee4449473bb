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
    params = lz77_tpu_torch.Params(la=17, sb=4095)  # 12+5+8 = 25 bits
    with pytest.raises(ValueError, match="byte-aligned"):
        torch_fused.encode_bytes_fused(b"abc", params, device="cpu")
    with pytest.raises(ValueError, match="byte-aligned"):
        torch_fused.encode_batch_walk(
            np.zeros((1, 8), np.uint8), np.zeros((1, 4095), np.uint8),
            np.zeros((1, 16), np.uint8), np.zeros(1, np.int32),
            np.zeros(1, np.int32), 8, 0, la=17, sb=4095, device="cpu",
        )


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
