"""The readers of the bit-granular pack against hand-worked runs:
``pack.roofline_share`` (the pack kernel's bytes over its device time) and
``encode.idle_ms_per_MiB.write`` (the card's idle inside the program's
``encode.write`` spans), and both reading nothing from a program that has
no such kernel or span."""

from types import SimpleNamespace

import pytest

from codec_bench import registry, runner, trace

MIB = 1 << 20
PEAK = 3.35e12
PACK = "void (anonymous namespace)::pack_bits_kernel(unsigned int const*)"


def _read(name, run):
    return registry.reader(name).read(run)


def _run(pack_ops=True, write=True, tokens=(1000, 3000)):
    """Two compress calls (times in ns) and a decompress call between them.

    Call 0, 2 MiB in, 3,004 B out, span 1000-5000: fetch 2500-3000, write
    3000-3600, assemble 4000-4800; the card busy 1200-1300 (K1),
    3100-3200 (the pack) and 3500-3700 (a copy).  Call 2, 1 MiB in,
    10,004 B out, span 7000-9000: write 8000-8500; the card busy 7400-8400
    (K1) and 8400-8450 (the pack)."""
    w0 = [("encode.write", 3000, 3600)] if write else []
    w2 = [("encode.write", 8000, 8500)] if write else []
    c0 = [("encode.fetch", 2500, 3000), *w0, ("encode.assemble", 4000, 4800)]
    c2 = [*w2]
    ops = [trace.DeviceOp("match_kernel", 1200, 1300),
           trace.DeviceOp("Memcpy DtoH (Device -> Pinned)", 3500, 3700),
           trace.DeviceOp("replay_kernel", 6100, 6500),
           trace.DeviceOp("match_kernel", 7400, 8400)]
    if pack_ops:
        ops += [trace.DeviceOp(PACK, 3100, 3200),
                trace.DeviceOp(PACK, 8400, 8450)]
    view = trace.View(0, 10_000, [trace.Span("compress", 0, 1000, 5000),
                                  trace.Span("decompress", 1, 6000, 7000),
                                  trace.Span("compress", 2, 7000, 9000)],
                      ops)

    def call(op, nin, nout, spans, tok):
        stats = SimpleNamespace(spans=spans) if tok is None \
            else SimpleNamespace(spans=spans, tokens=tok)
        return runner.Call(op, 0, 0.0, 0.0, nin, nout, stats)

    calls = [call("compress", 2 * MIB, 3004, c0, tokens[0]),
             runner.Call("decompress", 1, 0.0, 0.0, 100, 200, None),
             call("compress", MIB, 10_004, c2, tokens[1])]
    return SimpleNamespace(view=view, calls=calls, peaks={
        "hbm_bytes_per_s": PEAK})


def test_pack_roofline_reads_the_hand_worked_value():
    # 4 B a token read, the payload (stream less its header) written
    moved = 4 * 1000 + 3000 + 4 * 3000 + 10_000
    assert _read("pack.roofline_share", _run()) \
        == pytest.approx(100 * moved / PEAK / 150e-9)


def test_pack_layer_bytes_count_tokens_and_payload():
    layer = registry.reader("pack.roofline_share").layer_bytes
    assert layer(0, 4) == 0
    assert layer(8, 35) == 32 + 31  # eight 31-bit tokens: 31 B
    assert layer(0, 0) == 0


def test_write_idle_reads_the_hand_worked_value():
    # call 0: write 3000-3600 less the pack 3100-3200 and the copy's
    # 3500-3600; call 2: write 8000-8500 less K1 to 8400 and the pack
    want = (600 - 100 - 100) + (500 - 400 - 50)
    assert _read("encode.idle_ms_per_MiB.write", _run()) \
        == pytest.approx(want / 1e6 / 3)
    assert _read("encode.idle_ms_per_MiB.write", _run()) \
        <= _read("encode.idle_ms_per_MiB.other", _run())


def test_a_program_without_the_pack_or_its_span_reads_nothing():
    assert _read("pack.roofline_share", _run(pack_ops=False)) is None
    assert _read("pack.roofline_share", _run(tokens=(None, None))) is None
    assert _read("encode.idle_ms_per_MiB.write", _run(write=False)) is None
    run = _run()
    run.view = None
    assert _read("pack.roofline_share", run) is None
    assert _read("encode.idle_ms_per_MiB.write", run) is None


def test_the_files_cells_report_both_new_metrics():
    bench = registry.benchmark()
    files = [c["name"] for c in bench["workloads"]
             if c["traffic"] == "files-encode"]
    assert "deflate-window.files-encode" in files
    for cell in files:
        names = {m["name"] for m in registry.per_layer(bench, cell)}
        assert {"pack.roofline_share",
                "encode.idle_ms_per_MiB.write"} <= names, cell
