"""The walk route's pack at any token width and bit phase.

``parse_walk.pack_bits_plain`` (the pack kernel's plain version) against a
bit-by-bit numpy pack; ``compress`` with its defaults against the
executable spec and the native codec at every token width of
``edges.GRID`` that is not a byte multiple, at DEFLATE's window (la 255,
sb 32767: 31-bit tokens) and at 25 bits; batches that join inside a byte,
at each of the seven non-zero bit phases; every stream decoded back by
``decompress`` and by the benchmark's plain reference.  Tolerance 0.
"""

import numpy as np
import pytest
import torch

import lz77_tpu_torch as lt
from codec_bench import reference
from lz77_tpu_torch import edges, native, spec
from lz77_tpu_torch.models import codec, fused, spec_np
from lz77_tpu_torch.ops import fused_walk, parse_walk
from lz77_tpu_torch.utils import transfer

torch.set_num_threads(1)
SEED = 2**31 + 22
DATA = edges.make_input(SEED, **edges.SMALL_SIZES)
UNALIGNED = [(la, sb) for la, sb in edges.GRID
             if spec.token_width(la, sb) % 8] + [(255, 32767), (18, 4095)]


def _bit_pack(tokens: np.ndarray, width: int, phase: int) -> bytes:
    """``phase`` zero bits, then each token's ``width`` bits LSB-first,
    zero bits to the end of the last 32-bit word."""
    bits = [0] * phase
    for t in tokens.tolist():
        bits += [(t >> j) & 1 for j in range(width)]
    bits += [0] * (-len(bits) % 32)
    return np.packbits(np.array(bits, np.uint8),
                       bitorder="little").tobytes()


@pytest.mark.parametrize("width", range(9, 33))
def test_pack_bits_plain_equals_a_bit_by_bit_pack(width):
    rng = np.random.default_rng([SEED, width])
    for phase in range(8):
        for total in (0, 1, 2, 5, 33):
            words = rng.integers(0, 1 << width, total + 3, dtype=np.int64)
            # the words past ``total`` are K2's unspecified slots: not read
            tok = torch.from_numpy(words.astype(np.uint32).view(np.int32))
            payload, exit_phase = parse_walk.pack_bits(
                tok, torch.tensor([total], dtype=torch.int32), width, phase,
                total + 3)
            assert payload.numpy().tobytes() \
                == _bit_pack(words[:total], width, phase), (phase, total)
            assert int(exit_phase) == (phase + total * width) % 8
            dev_phase = torch.tensor([phase], dtype=torch.int32)
            again, _ = parse_walk.pack_bits(
                tok, torch.tensor([total], dtype=torch.int32), width,
                dev_phase, total + 3)
            assert torch.equal(again, payload)


def _check_stream(stream: bytes, data: bytes, p: spec.Params) -> None:
    """``stream`` is the spec's and the native codec's, and decodes to
    ``data`` by ``decompress`` and by the benchmark's plain reference."""
    want = native.encode(data, p)
    assert stream == want == spec_np.encode(data, p)
    assert lt.decompress(stream, device="cpu") == data
    tok = reference.parse(stream, "cpu")
    assert not tok.bad_tail and not bool(reference.invalid(tok).any())
    assert reference.decode(tok).numpy().tobytes() == data


@pytest.mark.parametrize("la,sb", UNALIGNED,
                         ids=[f"la{la}_sb{sb}" for la, sb in UNALIGNED])
def test_compress_with_its_defaults_packs_every_width(la, sb):
    st = codec.EncodeStats()
    stream = lt.compress(DATA, la, sb, device="cpu", stats=st)
    _check_stream(stream, DATA, spec.Params(la, sb))
    assert st.batches == 1 and st.seams == 0


@pytest.mark.parametrize("la,sb", [(255, 32767), (18, 4095), (2, 1)])
def test_batches_join_at_every_bit_phase(la, sb):
    """Batches of one 61-byte block: the phase each batch starts at, from
    the token counts, takes all seven non-zero values; ``EncodeStats.seams``
    counts those batches, and the stream is the spec's."""
    p = spec.Params(la, sb)
    x = np.frombuffer(DATA, np.uint8)
    geo = dict(block_size=61, batch_blocks=1)
    phases, bits = [], 0
    for _, _, _, tok, payload in fused.iter_batches_fused(
            x, p, device="cpu", **geo):
        phases.append(bits % 8)
        assert len(payload) == -(-(bits % 8 + tok * p.width) // 8)
        bits += tok * p.width
    assert set(phases) == set(range(8)), phases
    st = codec.EncodeStats()
    stream = lt.compress(DATA, la, sb, device="cpu", stats=st, **geo)
    _check_stream(stream, DATA, p)
    assert st.seams == sum(ph != 0 for ph in phases) > 0
    assert st.batches == len(phases)


@pytest.mark.parametrize("step", ["merged", "scan"])
@pytest.mark.parametrize("la,sb", [(255, 32767), (18, 4095)])
def test_merged_and_scan_still_refuse_unaligned_widths(la, sb, step):
    """K5 and the scan step cut token words to bytes: at 31 and 25 bits
    they refuse a batch, with the JAX package's text."""
    p = spec.Params(la, sb)
    x = np.frombuffer(DATA, np.uint8)
    n = x.shape[0]
    batch = codec._batch_inputs(x, n, 0, 1, 1, n, p.d_limit, p.len_limit)
    fn = {"merged": fused_walk.encode_batch_sweepwalk,
          "scan": fused.encode_batch_device}[step]
    with pytest.raises(ValueError,
                       match="fused pipeline requires byte-aligned token"):
        fn(*batch, n, 0, la=la, sb=sb, device="cpu")


def test_bytes_builder_ors_a_seam_into_the_last_byte():
    with transfer.BytesBuilder(4) as out:
        out.write(b"\x05")
        out.write(b"\xa0\x01", seam=True)
        out.write(b"\x02\x03", seam=True)
        with pytest.raises(ValueError, match="capacity"):
            out.write(b"\x00\x00\x00\x00")
        assert out.finish() == b"\xa5\x03\x03"
    with transfer.BytesBuilder(2) as out:
        with pytest.raises(ValueError, match="seam"):
            out.write(b"\x01", seam=True)
