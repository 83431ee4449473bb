"""The reference's parameter edges and corrupt streams, port against the JAX
package, on the CPU.

Every point of ``lz77_tpu_torch.edges.GRID`` (la 2..255 against sb 1, 2, 3,
power-of-two sizes and 65535) on one small input from a seed: every encode
route the port runs gives the JAX package's stream, every decode route the
input back.  The corrupt-stream corpus of ``edges.corrupt_streams`` (the one
``chip_smoke.py`` decodes on the card) goes through every decode backend,
each held against the JAX package's own or, for the two device decodes, the
rule they keep.  Tolerance 0: streams and bytes.
"""

import numpy as np
import pytest
import torch

import lz77_tpu_torch as lt
from lz77_tpu import native as jax_native
from lz77_tpu import spec as jax_spec
from lz77_tpu.models import codec as jax_codec
from lz77_tpu.models import decoder as jax_decoder
from lz77_tpu.models import spec_np as jax_spec_np
from lz77_tpu_torch import bitio, cli, edges, native, spec
from lz77_tpu_torch.models import codec, decoder, fused, spec_np
from lz77_tpu_torch.ops import decode_walk, fused_walk
from lz77_tpu_torch.parallel import mesh as mesh_lib
from lz77_tpu_torch.parallel import sharded

from test_torch_fused_walk import _step_stream

torch.set_num_threads(1)

SEED = 0
DATA = edges.make_input(SEED, **edges.SMALL_SIZES)
B = edges.SMALL_SIZES["block_size"]
GRID = pytest.mark.parametrize(
    "la,sb", edges.GRID, ids=[f"la{la}_sb{sb}" for la, sb in edges.GRID])
CORRUPT_TEXT = "corrupt stream: match reaches before output start"


def jax_stream(la: int, sb: int, data: bytes = DATA) -> bytes:
    return jax_native.encode(data, jax_spec.Params(la, sb))


def test_input_runs_one_byte_across_a_block_boundary():
    for sizes in (edges.SMALL_SIZES, edges.CARD_SIZES):
        x = edges.make_input(SEED, **sizes)
        b, half = sizes["block_size"], sizes["run"] // 2
        end = sizes["text"] + sizes["zeros"] + sizes["random"]
        assert end % b == 0 and len(x) == end + half + 100
        assert len(set(x[end - half : end + half])) == 1
        assert x[sizes["text"] : sizes["text"] + sizes["zeros"]] \
            == bytes(sizes["zeros"])
    assert edges.make_input(SEED, **edges.SMALL_SIZES) == DATA
    assert 1024 <= len(DATA) <= 3072


@GRID
def test_encode_routes_give_the_jax_stream(la, sb):
    """fused walk at every width, the merged (K5) and scan steps chained
    where the width is byte-aligned (else the JAX package's ValueError),
    the host pipeline with both matchers, a 2x2 CPU mesh and the native
    binding: the JAX native stream, itself equal to the JAX executable
    spec's."""
    want = jax_stream(la, sb)
    assert want == jax_spec_np.encode(DATA, jax_spec.Params(la, sb))
    p = spec.Params(la, sb)
    assert spec_np.encode(DATA, p) == want
    assert native.encode(DATA, p) == want
    assert fused.encode_bytes_fused(DATA, p, block_size=B,
                                    device="cpu") == want
    for step in (fused_walk.encode_batch_sweepwalk,
                 fused.encode_batch_device):
        if bitio.byte_aligned(p):
            assert _step_stream(step, DATA, p, B) == want
        else:
            with pytest.raises(ValueError, match="byte-aligned"):
                _step_stream(step, DATA, p, B)
    for matcher in ("sweep", "chunk"):
        assert codec.encode_bytes(DATA, p, pipeline="host", matcher=matcher,
                                  block_size=B, device="cpu") == want
    mesh = mesh_lib.make_mesh(2, 2, devices=["cpu"] * 4)
    assert sharded.encode_bytes_sharded(DATA, p, mesh=mesh,
                                        block_size=B) == want


@GRID
def test_decode_routes_give_the_input_back(la, sb, tmp_path):
    """``decompress``, every ``decode_bytes`` backend, the packed-word
    decode and the streamed device decode at stages of 64 and 4,096 tokens
    (the window carried at wp = min(history, d_limit): 0 at sb 1, 1 at sb
    2) all give the input, as the JAX native decoder does."""
    stream = jax_stream(la, sb)
    assert jax_native.decode(stream) == DATA
    assert lt.decompress(stream, device="cpu") == DATA
    for backend in ("device", "device-chunked", "host", "native"):
        assert codec.decode_bytes(stream, backend=backend,
                                  device="cpu") == DATA, backend
    p, off, ln, nxt = bitio.parse_stream(stream)
    assert decode_walk.decode_tokens_walk_packed(
        off, ln, nxt, off_bits=p.off_bits, device="cpu") == DATA
    src = tmp_path / "s.lz"
    src.write_bytes(stream)
    for stage in (64, 4096):
        st = codec.DecodeStats()
        n = codec.decode_file_device(str(src), str(tmp_path / "o"), stats=st,
                                     tokens_per_stage=stage, device="cpu")
        assert n == len(DATA) and (tmp_path / "o").read_bytes() == DATA
        assert st.stages == -(-off.shape[0] // stage)


def test_decompress_of_compress_at_la255_sb1():
    """off_bits 0: the fused encode's stream decodes on the default
    backend (it raised ``off_bits 0 outside [1, 16]``)."""
    s = lt.compress(DATA, 255, 1, device="cpu")
    assert s == jax_stream(255, 1)
    assert lt.decompress(s, device="cpu") == DATA


def test_decode_file_device_at_la2_sb1(tmp_path):
    src = tmp_path / "s.lz"
    src.write_bytes(jax_stream(2, 1))
    n = codec.decode_file_device(str(src), str(tmp_path / "o"),
                                 tokens_per_stage=64, device="cpu")
    assert n == len(DATA) and (tmp_path / "o").read_bytes() == DATA


def test_cli_default_decode_of_a_force_sb_1_stream(tmp_path, capsys):
    src, lz, back = (str(tmp_path / n) for n in ("in", "in.lz", "back"))
    with open(src, "wb") as f:
        f.write(DATA)
    assert cli.main(["-c", "--force-sb", "-s", "1", "-l", "4", "--device",
                     "cpu", "-i", src, "-o", lz]) == 0
    with open(lz, "rb") as f:
        assert f.read() == jax_stream(4, 1)
    assert cli.main(["-d", "--device", "cpu", "-i", lz, "-o", back]) == 0
    with open(back, "rb") as f:
        assert f.read() == DATA


def test_walk_decode_takes_off_bits_0():
    """At off_bits 0, d_limit is 0: literals replay, a copy is refused
    (count -1) by both replays; the range's ends keep their text."""
    words = decode_walk.pack_token_words(
        np.array([0, 0, 0]), np.array([0, 0, 2]), np.array([65, 66, 67]))
    toks = torch.from_numpy(words)
    out, cnt = decode_walk.walk_decode(toks, 2, out_cap=2, off_bits=0)
    assert bytes(out.numpy()) == b"AB" and int(cnt) == 2
    out, cnt = decode_walk.walk_decode_packed(toks, 2, off_bits=0,
                                              out_cap_words=1)
    assert int(cnt) == 2 and bytes(out.numpy().view(np.uint8)[:2]) == b"AB"
    assert int(decode_walk.walk_decode(toks, 3, out_cap=5, off_bits=0)[1]) \
        == -1
    assert int(decode_walk.walk_decode_packed(
        toks, 3, off_bits=0, out_cap_words=2)[1]) == -1
    for bad in (-1, 17):
        with pytest.raises(ValueError, match=r"outside \[0, 16\]"):
            decode_walk.walk_decode(toks, 2, out_cap=2, off_bits=bad)
        with pytest.raises(ValueError, match=r"outside \[0, 16\]"):
            decode_walk.walk_decode_packed(toks, 2, off_bits=bad,
                                           out_cap_words=1)


@pytest.mark.parametrize("stream", [
    edges.SAMPLE,                                   # out_len past the chunk
    bytes.fromhex("07000300") + b"\xff" * 13,       # token starts past it
], ids=["tail_start", "token_starts"])
def test_chunked_decoder_clamps_like_the_jax_decoder(stream):
    """A length field above la - 1 puts the chunk's output length, and
    later token starts, past its buffer: the tail's start is clamped and
    such tokens dropped, as ``dynamic_slice`` and ``mode="drop"`` do."""
    want = jax_decoder.decode_stream(stream)
    assert decoder.decode_stream(stream, device="cpu") == want
    assert codec.decode_bytes(stream, backend="device-chunked",
                              device="cpu") == want
    if stream == edges.SAMPLE:
        assert want == b"\x00\x00\x00"


@pytest.fixture(scope="module")
def corpus():
    streams = {f"la{la}_sb{sb}": jax_stream(la, sb)
               for la, sb in edges.CORRUPT_GRID}
    return edges.corrupt_streams(SEED, streams)


def _bad_tokens(stream: bytes, *, file_limits: bool) -> bool | None:
    """Whether a token with a length breaks the device decodes' rule: off
    == 0 or off past the output so far (and, for the streamed decode, off
    above d_limit or len above len_limit); None if the header is bad."""
    try:
        p, off, ln, _ = bitio.parse_stream(stream)
    except ValueError:
        return None
    off, ln = off.astype(np.int64), ln.astype(np.int64)
    start = np.cumsum(ln + 1) - (ln + 1)
    bad = (off == 0) | (off > start)
    if file_limits:
        bad |= (off > p.d_limit) | (ln > p.len_limit)
    return bool((bad & (ln > 0)).any())


@pytest.mark.parametrize("backend", ["device-chunked", "host", "native"])
def test_corrupt_streams_decode_as_in_the_jax_package(corpus, backend):
    """The same bytes, or the same exception and text, as the JAX package's
    chunked decoder, host decoder and native binding."""
    jax_fn = {
        "device-chunked": jax_decoder.decode_stream,
        "host": lambda s: jax_codec.decode_bytes(s, backend="host"),
        "native": lambda s: jax_codec.decode_bytes(s, backend="native"),
    }[backend]
    kinds = set()
    for name, s in corpus.items():
        got = edges.outcome(codec.decode_bytes, s, backend=backend,
                            device="cpu")
        assert got == edges.outcome(jax_fn, s), name
        kinds.add(type(got))
    assert kinds == {bytes, tuple}  # some decode, some raise


def test_corrupt_streams_on_the_device_decode(corpus):
    """``backend="device"`` (K3's plain version): the host decoder's bytes,
    or ``ValueError`` with the JAX host text where a token with a length
    has off == 0 or reaches before the output start (the decided
    difference: the JAX walk replays those)."""
    refused = 0
    for name, s in corpus.items():
        got = edges.outcome(codec.decode_bytes, s, backend="device",
                            device="cpu")
        host = edges.outcome(codec.decode_bytes, s, backend="host",
                             device="cpu")
        if _bad_tokens(s, file_limits=False):
            assert got == ("ValueError", CORRUPT_TEXT), name
            refused += 1
        else:
            assert got == host, name
    assert refused >= 3


def test_corrupt_streams_on_the_streamed_device_decode(corpus, tmp_path):
    """``decode_file_device``: a bad header raises the JAX package's text
    (before any kernel), a token that breaks the header's limits raises
    ``corrupt stream: invalid token``, anything else writes the host
    decoder's bytes."""
    src, dst = tmp_path / "s.lz", tmp_path / "o"
    for name, s in corpus.items():
        src.write_bytes(s)
        got = edges.outcome(codec.decode_file_device, str(src), str(dst),
                            tokens_per_stage=64, device="cpu")
        bad = _bad_tokens(s, file_limits=True)
        if bad is None:
            want = edges.outcome(jax_codec.decode_file_device, str(src),
                                 str(tmp_path / "j"), interpret=True)
            assert isinstance(got, tuple) and got == want, name
        elif bad:
            assert got == ("ValueError", "corrupt stream: invalid token"), \
                name
        else:
            host = codec.decode_bytes(s, backend="host", device="cpu")
            assert got == len(host) and dst.read_bytes() == host, name


def test_jax_walk_decode_interpreted_at_la255_sb1():
    """The JAX walk kernel (interpreted) decodes off_bits 0 as the port's
    device backend does."""
    s = jax_stream(255, 1)
    st = jax_codec.DecodeStats()
    want = jax_codec.decode_bytes(s, backend="device", device_interpret=True,
                                  stats=st)
    assert st.backend == "device-walk" and want == DATA
    assert codec.decode_bytes(s, backend="device", device="cpu") == want
