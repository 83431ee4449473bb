"""The readers of the program's own spans (``spans.py`` and the ``encode.*``
metrics) against hand-worked runs, and, on the card, the clock the program
and the profiler share.

    python -m pytest codec_bench/tests/test_bench_spans.py -m card
"""

import random
import time
from types import SimpleNamespace

import pytest

from codec_bench import registry, runner, spans, trace

MIB = 1 << 20
PARTS = ["stage", "copy", "launch", "assemble", "other"]
IDLE = [f"encode.idle_ms_per_MiB.{p}" for p in PARTS]
BLOCKS = [f"encode.{p}_ms_per_call.blocks"
          for p in ("stage", "upload", "launch", "wait")]
NEW = IDLE + BLOCKS


def _call(op, nin, program_spans=None):
    stats = None if program_spans is None \
        else SimpleNamespace(spans=program_spans)
    return runner.Call(op, 0, 0.0, 0.0, nin, 0, stats)


def _run(stage0=7100):
    """Two compress calls and a decompress call between them (times in ns).

    Call 0, 2 MiB, span 1000-5000: stage 1100-1500, upload 1500-1700,
    launch 1700-1900, wait 2500-3500, fetch 3500-3700, assemble 4000-4800;
    the card busy 1200-1300, 1600-2600 and 3550-3600.
    Call 2, 1 MiB, span 7000-9000: stage ``stage0``-7300, upload
    7300-7400, launch 7400-7500, wait 7500-8500, fetch 8500-8600, assemble
    8600-8900; the card busy 7400-8400.  The decompress call's 6100-6500
    is no compress call's."""
    c0 = [("encode.stage", 1100, 1500), ("encode.upload", 1500, 1700),
          ("encode.launch", 1700, 1900), ("encode.wait", 2500, 3500),
          ("encode.fetch", 3500, 3700),
          ("encode.assemble", 4000, 4800)]
    c2 = [("encode.stage", stage0, 7300), ("encode.upload", 7300, 7400),
          ("encode.launch", 7400, 7500), ("encode.wait", 7500, 8500),
          ("encode.fetch", 8500, 8600),
          ("encode.assemble", 8600, 8900)]
    ops = [trace.DeviceOp("match_kernel", 1200, 1300),
           trace.DeviceOp("Memcpy HtoD (Pageable -> Device)", 1600, 2600),
           trace.DeviceOp("Memcpy DtoH (Device -> Pageable)", 3550, 3600),
           trace.DeviceOp("replay_kernel", 6100, 6500),
           trace.DeviceOp("match_kernel", 7400, 8400)]
    view = trace.View(0, 10_000, [trace.Span("compress", 0, 1000, 5000),
                                  trace.Span("decompress", 1, 6000, 7000),
                                  trace.Span("compress", 2, 7000, 9000)],
                      ops)
    return SimpleNamespace(
        view=view, calls=[_call("compress", 2 * MIB, c0),
                          _call("decompress", 100),
                          _call("compress", MIB, c2)])


def _read(name, run):
    return registry.reader(name).read(run)


def test_idle_parts_read_the_hand_worked_values():
    run = _run()
    # ns of idle a part, over both calls, per 3 MiB
    want = {"stage": 300 + 200, "copy": 100 + 150 + 100 + 100,
            "launch": 0, "assemble": 800 + 300,
            # 1000-1100, wait 2600-3500, 3700-4000, 4800-5000; 7000-7100,
            # wait 8400-8500, 8900-9000
            "other": 100 + 900 + 300 + 200 + 100 + 100 + 100}
    for p in PARTS:
        assert _read(f"encode.idle_ms_per_MiB.{p}", run) \
            == pytest.approx(want[p] / 1e6 / 3), p


def test_the_five_parts_add_up_to_the_idle_inside_compress_calls():
    run = _run()
    calls = [(s.t0, s.t1) for s in run.view.spans_of("compress")]
    idle = sum(b - a for a, b in calls) - trace.busy_ns(run.view, clip=calls)
    assert idle == 4000 - 1150 + 2000 - 1000
    assert sum(_read(n, run) for n in IDLE) \
        == pytest.approx(idle / 1e6 / 3)


def test_span_walls_read_the_hand_worked_values():
    run = _run()
    want = {"stage": (400 + 200) / 2, "upload": (200 + 100) / 2,
            "launch": (200 + 100) / 2, "wait": (1000 + 1000) / 2}
    for p, ns in want.items():
        assert _read(f"encode.{p}_ms_per_call.blocks", run) \
            == pytest.approx(ns / 1e6), p


def test_a_program_span_outside_its_call_gives_none():
    inside = _run(stage0=7000 - spans.SLACK_NS + 1)
    assert all(_read(n, inside) is not None for n in NEW)
    # clipped to its call: the part outside adds no idle time
    assert _read("encode.idle_ms_per_MiB.stage", inside) \
        == pytest.approx((300 + 300) / 1e6 / 3)
    outside = _run(stage0=7000 - spans.SLACK_NS - 1)
    assert all(_read(n, outside) is None for n in NEW)


def test_a_program_without_spans_or_a_run_untraced_gives_none():
    run = _run()
    for c in run.calls:
        if c.stats is not None:
            c.stats = SimpleNamespace()  # a stats record with no spans
    assert all(_read(n, run) is None for n in NEW)
    run = _run()
    run.view = None
    assert all(_read(n, run) is None for n in NEW)


def test_idle_inside_intervals_equals_the_trace_arithmetic():
    rnd = random.Random(5)
    for _ in range(50):
        ops = [trace.DeviceOp("k", a, a + rnd.randint(1, 300))
               for a in (rnd.randint(0, 5000) for _ in range(40))]
        view = trace.View(100, 5000, [], ops)
        iv = [(a, a + rnd.randint(0, 400))
              for a in (rnd.randint(0, 5200) for _ in range(15))]
        wall = trace.union_ns([(a, b) for a, b in iv if b > a])
        assert spans.idle_ns(spans.busy_pieces(view), iv) \
            == wall - trace.busy_ns(view, clip=iv)


@pytest.mark.card
def test_program_spans_lie_inside_their_calls_on_the_card(cuda_card):
    """A traced run of ``default-window.files-encode`` at a 64th of the
    pool: every program span lies inside its call's benchmark span within
    0.2 ms (the program's ``time.time_ns`` is the profiler's clock), and
    every new reader reads a number."""
    import torch

    bench = registry.benchmark()
    cell = registry.cell(bench, "default-window.files-encode")
    system = runner.System(cuda_card)
    run = runner.prepare(cell, registry.config(cell["config"]),
                         registry.traffic(cell["traffic"]), 2**31 + 21,
                         system, scale=64)
    torch.cuda.synchronize()
    runner.window(run, system, 2.0, traced=True, start=time.perf_counter())
    worst, n = 0, 0
    for s in run.view.spans_of("compress"):
        for name, t0, t1 in run.calls[s.call].stats.spans:
            worst = max(worst, s.t0 - t0, t1 - s.t1)
            n += 1
    assert n and worst <= spans.SLACK_NS, worst
    got = {m["name"]: _read(m["name"], run)
           for m in registry.per_layer(bench, cell["name"])}
    assert all(got[name] is not None for name in IDLE), got
    calls = [(s.t0, s.t1) for s in run.view.spans_of("compress")]
    idle = sum(b - a for a, b in calls) - trace.busy_ns(run.view, clip=calls)
    mib = sum(c.nin for c in run.calls_of("compress")) / MIB
    assert sum(got[name] for name in IDLE) \
        == pytest.approx(idle / 1e6 / mib, rel=0.01)
