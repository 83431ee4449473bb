"""The program's own spans (``utils/profiling.py::annotate``) on the fused
encode and the device decode, on the CPU (the kernels' plain versions).

Off (no profiler running) a span is one flag read: nothing is kept and
``record_function`` is not called.  Under a profiler each span is a
``record_function`` range and a tuple ``(name, t0_ns, t1_ns)`` in
``stats.spans`` on the clock of the profiler's events; streams do not
change.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import lz77_tpu_torch
from lz77_tpu_torch import native
from lz77_tpu_torch.models import codec
from lz77_tpu_torch.models import fused
from lz77_tpu_torch.utils import profiling

from conftest import make_text

torch.set_num_threads(1)

# three batches of two 2 KiB blocks
BLOCK, BATCH, NBYTES = 2048, 2, 5 * 2048 + 700
SLACK_NS = 200_000  # a span against its record_function range: 0.2 ms
SUBMIT = ["encode.stage", "encode.upload", "encode.launch"]
FETCH = ["encode.wait", "encode.fetch"]
WRITE = ["encode.write"]
# the two-deep loop: batch k+1 is submitted before batch k is fetched, and
# each payload is written into the stream once it is fetched
ENCODE_ORDER = (SUBMIT * 2 + FETCH + WRITE + SUBMIT + FETCH + WRITE + FETCH
                + WRITE + ["encode.assemble"])
DECODE_ORDER = ["decode.unpack", "decode.pack", "decode.upload",
                "decode.launch", "decode.verdict", "decode.fetch"]


def _encode(data, stats=None):
    return fused.encode_bytes_fused(
        data, block_size=BLOCK, batch_blocks=BATCH, stats=stats,
        device="cpu")


def _profiled(fn):
    """``fn()`` under a CPU profiler, after one warm call (the first
    ``record_function`` of a process pays its set-up inside its range);
    returns fn's result and the profiler's events by name."""
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append(
            (e.start_ns(), e.start_ns() + e.duration_ns()))
    return out, events


def _check_spans(spans, order, events):
    assert [s[0] for s in spans] == order
    for name, t0, t1 in spans:
        assert t0 <= t1
    for (_, _, a1), (_, b0, _) in zip(spans, spans[1:]):
        assert a1 <= b0, "spans overlap"
    seen = {}
    for name, t0, t1 in spans:
        k = seen[name] = seen.get(name, -1) + 1
        r0, r1 = sorted(events[name])[k]
        assert abs(t0 - r0) <= SLACK_NS and abs(t1 - r1) <= SLACK_NS, \
            (name, k, t0 - r0, t1 - r1)


def test_off_keeps_nothing_and_calls_no_record_function(rng, monkeypatch):
    """No profiler: neither form of ``record_function`` runs, and the stats
    keep no span."""
    data = make_text(rng, NBYTES)
    want = native.encode(data)

    def boom(*a, **k):
        raise AssertionError("called with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", boom,
                        raising=False)
    # one shared do-nothing context: nothing is made a span
    assert profiling.annotate("a", codec.EncodeStats()) \
        is profiling.annotate("b")
    st, ds = codec.EncodeStats(), codec.DecodeStats()
    out = _encode(data, st)
    assert out == want
    assert lz77_tpu_torch.decompress(out, device="cpu", stats=ds) == data
    assert st.spans == [] and ds.spans == []
    assert st.phases.io > 0 and st.phases.match > 0


def test_encode_spans_follow_the_two_deep_loop(rng):
    data = make_text(rng, NBYTES)
    want = _encode(data)
    stats = []

    def run():
        stats.append(codec.EncodeStats())
        return _encode(data, stats[-1])

    out, events = _profiled(run)
    assert out == want  # byte-identical with tracing on and off
    st = stats[-1]
    _check_spans(st.spans, ENCODE_ORDER, events)
    # the spans split the phases that time the same code
    wall = {}
    for name, t0, t1 in st.spans:
        wall[name] = wall.get(name, 0) + (t1 - t0) / 1e9
    assert sum(wall[n] for n in SUBMIT) <= st.phases.io
    assert sum(wall[n] for n in FETCH) <= st.phases.match


def test_decode_spans_come_in_their_order(rng):
    data = make_text(rng, NBYTES)
    stream = _encode(data)
    stats = []

    def run():
        stats.append(codec.DecodeStats())
        return lz77_tpu_torch.decompress(stream, device="cpu",
                                         stats=stats[-1])

    out, events = _profiled(run)
    assert out == data
    assert stats[-1].backend == "device-walk"
    _check_spans(stats[-1].spans, DECODE_ORDER, events)


def test_a_span_that_raises_lets_the_error_through_and_is_not_kept():
    st = codec.EncodeStats()
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(KeyError):
            with profiling.annotate("encode.stage", st):
                raise KeyError("x")
        with profiling.annotate("encode.stage", st):
            pass
    assert [s[0] for s in st.spans] == ["encode.stage"]


def test_a_span_is_a_named_range_in_the_trace():
    st = codec.EncodeStats()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.annotate("encode.launch", st):
            torch.ones(4).sum()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "encode.launch"]
    assert len(events) == 1
    assert [s[0] for s in st.spans] == ["encode.launch"]


def test_a_span_without_stats_is_a_range_in_the_trace():
    """Under a profiler a span given no stats record is a range in the
    trace alone."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.annotate("decode.launch"):
            torch.ones(4).sum()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("decode.launch") == 1
