"""``match.fallback_share`` against hand-worked runs, and, on the card, the
counters it reads: K1's wide-window route counts on the device and the
fused encode brings the counts back with each batch.

    python -m pytest codec_bench/tests/test_bench_match.py -m card
"""

from types import SimpleNamespace

import pytest

from codec_bench import pool, registry, runner

NAME = "match.fallback_share"


def _run(*stats):
    calls = [runner.Call("compress", i, 0.0, 0.0, 1, 1, s)
             for i, s in enumerate(stats)]
    calls.insert(1, runner.Call("decompress", 9, 0.0, 0.0, 1, 1, None))
    return SimpleNamespace(
        calls_of=lambda op: [c for c in calls if c.op == op])


def _read(run):
    return registry.reader(NAME).read(run)


def test_reads_the_program_counter():
    # 1,000 positions walked and 30 fell back, 0 walked, 3,000 and 10
    run = _run(SimpleNamespace(match_positions=1000, match_fallbacks=30),
               SimpleNamespace(match_positions=0, match_fallbacks=0),
               SimpleNamespace(match_positions=3000, match_fallbacks=10))
    assert _read(run) == pytest.approx(100 * 40 / 4000)


def test_none_without_the_counter_or_a_walked_position():
    assert _read(_run(SimpleNamespace(match_positions=5, match_fallbacks=1),
                      SimpleNamespace(batches=3))) is None
    assert _read(_run(SimpleNamespace(match_positions=0, match_fallbacks=0),
                      SimpleNamespace(match_positions=0,
                                      match_fallbacks=0))) is None
    assert _read(_run()) is None


def test_listed_where_the_route_runs():
    """The metric is listed in the cells whose window takes the route
    (d_limit >= 16,384), and in no other."""
    from lz77_tpu_torch import spec
    from lz77_tpu_torch.ops import match

    bench = registry.benchmark()
    metric = next(m for m in bench["per_layer"] if m["name"] == NAME)
    walked = [c["name"] for c in bench["workloads"]
              if c["traffic"] == "files-encode" and match.takes_chain(
                  spec.d_limit(registry.config(c["config"])["sb"]))]
    assert metric["workloads"] == walked and len(walked) == 2


@pytest.mark.card
def test_wide_window_compress_counts_on_the_card(cuda_card):
    """Two 8 MiB batches of the records class at DEFLATE's window: the
    counts come back with the batches, the stream is the native
    encoder's."""
    import lz77_tpu_torch
    from lz77_tpu_torch import native
    from lz77_tpu_torch.models import codec

    data = pool.make_file("records", 12 << 20, 2**31 + 43, 3)
    st = codec.EncodeStats()
    out = lz77_tpu_torch.compress(data, 255, 32767, stats=st,
                                  device=cuda_card)
    assert out == native.encode(data, lz77_tpu_torch.Params(255, 32767))
    assert st.batches == 2
    assert 0 < st.match_positions <= len(data)
    assert st.match_hops >= st.match_positions > st.match_fallbacks
