"""The yardstick's arithmetic against hand-worked cases: each layer's byte
count, the device's busy and idle time, the breakdown, and the reference's
parse, decode and longest match."""

import numpy as np
import pytest
import torch

from codec_bench import reference as ref
from codec_bench import registry, trace

MIB = 1 << 20


def test_match_bytes_are_the_input_and_two_int32_tables():
    f = registry.reader("match.roofline_share").layer_bytes
    assert f(MIB) == MIB + 2 * 4 * MIB
    assert f(51_220_480) == 460_984_320


def test_parse_pack_bytes_add_the_payload_without_the_header():
    f = registry.reader("parse_pack.roofline_share").layer_bytes
    # 1 MiB in, 100,000 tokens of 3 bytes out
    assert f(MIB, 4 + 300_000) == 9 * MIB + 300_000


def test_replay_bytes_are_the_payload_and_the_output():
    f = registry.reader("replay.roofline_share").layer_bytes
    assert f(4 + 3 * 1000, 5000) == 3000 + 5000


def _view():
    ops = [trace.DeviceOp("void (anonymous namespace)::match_kernel<true>"
                          "(unsigned char const*)", 100, 300),
           trace.DeviceOp("Memcpy HtoD (Pageable -> Device)", 250, 400),
           trace.DeviceOp("lz77::replay_kernel(lz77::ReplayArgs)", 600, 650),
           trace.DeviceOp("Memset (Device)", 900, 950)]
    spans = [trace.Span("compress", 0, 50, 500),
             trace.Span("decompress", 1, 550, 1000)]
    return trace.View(0, 1000, spans, ops)


def test_busy_time_is_the_union_of_device_intervals():
    v = _view()
    assert trace.union_ns([(0, 10), (5, 20), (30, 40)]) == 30
    assert trace.busy_ns(v) == 300 + 50 + 50
    assert trace.idle_share(v) == pytest.approx(60.0)
    # inside the decompress span only: 600-650 and 900-950 of 550-1000
    assert trace.busy_ns(v, clip=[(550, 1000)]) == 100


def test_ops_belong_to_the_span_they_start_in():
    v = _view()
    assert len(v.ops_in(v.spans_of("compress"))) == 2
    assert len(v.ops_in(v.spans_of("decompress"))) == 2
    assert trace.kernel_ns(v.ops, r"\bmatch_kernel\b") == 200


def test_span_metrics_read_the_view():
    class Call:
        def __init__(self, nin, nout):
            self.nin, self.nout = nin, nout

    class Run:
        view = _view()
        peaks = {"hbm_bytes_per_s": 3.35e12}
        calls = [Call(1000, 400), Call(304, 1000)]

    share = registry.reader("match.roofline_share").read(Run)
    assert share == pytest.approx(100 * 9000 / 3.35e12 / 200e-9)
    idle = registry.reader("device_idle_share.blocks_decode").read(Run)
    assert idle == pytest.approx(100 * (1 - 100 / 450))
    ops = registry.reader("device_ops_per_call.blocks_encode").read(Run)
    assert ops == 2
    Run.peaks = None  # an unknown card: no share rather than a guess
    assert registry.reader("replay.roofline_share").read(Run) is None


def test_breakdown_names_ops_and_gaps():
    b = trace.breakdown(_view(), lambda s: s.op)
    assert b["device_ops"][0] == ["match_kernel", 200 / 1e9]
    gaps = dict((round(s * 1e9), n) for n, s in b["idle_gaps"])
    # 400-600: half in the compress span, a quarter in the decompress one
    assert gaps == {100: "between calls", 200: "between calls",
                    250: "decompress", 50: "decompress"}
    assert trace.short("void at::native::vectorized_elementwise_kernel<4, "
                       "at::native::FillFunctor<int> >(int)") \
        == "at::native::vectorized_elementwise_kernel"


def _stream(la, sb, toks):
    """A stream built by hand from (off, len, next) triples."""
    ob, lb = ref.bitof(sb), ref.bitof(la)
    bits, nbits = 0, 0
    for off, ln, nxt in toks:
        bits |= (off | ln << ob | nxt << (ob + lb)) << nbits
        nbits += ob + lb + 8
    body = bits.to_bytes((nbits + 7) // 8, "little")
    return ref.header(la, sb) + body


def test_reference_parses_and_decodes_a_hand_made_stream():
    # "abcabcabcX": a, b, c, then a copy of 6 from 3 back, then X
    s = _stream(15, 4095, [(0, 0, 97), (0, 0, 98), (0, 0, 99),
                           (3, 6, 88)])
    tok = ref.parse(s, "cpu")
    assert (tok.la, tok.sb, len(tok), tok.bad_tail) == (15, 4095, 4, False)
    assert bytes(ref.decode(tok).numpy()) == b"abcabcabcX"
    assert not ref.invalid(tok).any()
    x = torch.tensor(list(b"abcabcabcX"), dtype=torch.uint8)
    ln, off = ref.longest_match(x, ref.starts(tok), 15, 4095)
    assert ln.tolist() == [0, 0, 0, 6] and off.tolist() == [0, 0, 0, 3]


def test_reference_flags_what_no_encoder_emits():
    bad = _stream(15, 4095, [(0, 0, 97), (2, 1, 98)])  # copy before start
    assert ref.invalid(ref.parse(bad, "cpu")).tolist() == [False, True]
    lit_off = _stream(15, 4095, [(5, 0, 97)])
    assert ref.invalid(ref.parse(lit_off, "cpu")).tolist() == [True]
    assert ref.parse(bad, "cpu").bad_tail is False
    # a byte past the last token's is padding no encoder writes
    assert ref.parse(bad + b"\x00", "cpu").bad_tail is True
    # 21-bit tokens: the last byte's spare bits must be zero
    odd = _stream(8, 500, [(0, 0, 97)])
    assert ref.parse(odd, "cpu").bad_tail is False
    assert ref.parse(odd[:-1] + bytes([odd[-1] | 0x80]), "cpu").bad_tail


def test_longest_match_prefers_the_nearest_offset_and_caps_the_length():
    x = torch.tensor(list(b"xyxyxyxyxyxyxyxyxyxy"), dtype=torch.uint8)
    ln, off = ref.longest_match(x, torch.tensor([2, 19]), 4, 4095)
    assert ln.tolist() == [3, 0] and off.tolist() == [2, 0]
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 3, 3000).astype(np.uint8))
    pos = torch.arange(0, 3000, 7)
    a = ref.longest_match(x, pos, 15, 300, budget=1 << 12)
    b = ref.longest_match(x, pos, 15, 300)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
