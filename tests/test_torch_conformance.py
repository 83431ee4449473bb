"""Port conformance runner, corpus and stream inspector
(lz77_tpu_torch.conformance, .corpus, .dump) against the JAX package's.

The corpus is compared byte for byte; the inspector's text, JSON, messages
and exit codes character for character; the runner's rows key for key
(timing keys left out) with both runners' corpora cut short.  The port runs
on the CPU (``device="cpu"``), so through the kernels' plain versions.
"""

import inspect
import io
import json

import numpy as np
import pytest
import torch

from lz77_tpu import conformance as jax_conformance
from lz77_tpu import corpus as jax_corpus
from lz77_tpu import dump as jax_dump
from lz77_tpu import native as jax_native
from lz77_tpu import spec as jax_spec
from lz77_tpu_torch import conformance, corpus, dump
from lz77_tpu_torch.models import codec

from conftest import make_text

torch.set_num_threads(1)

TIMING = ("encode_mb_s", "decode_mb_s")


@pytest.fixture(scope="module")
def corpora():
    return jax_corpus.get_corpus(1), corpus.get_corpus(1)


def test_get_corpus_is_byte_identical(corpora):
    want, got = corpora
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name
    assert len(got) == 9 and "system:python-src" in got


def test_corpus_dir_is_read_as_the_jax_package_reads_it(tmp_path,
                                                        monkeypatch):
    (tmp_path / "b.txt").write_bytes(b"second " * 100)
    (tmp_path / "a.bin").write_bytes(bytes(range(256)) * 3)
    (tmp_path / "sub").mkdir()
    monkeypatch.setenv("LZ77_CORPUS_DIR", str(tmp_path))
    got = corpus.get_corpus(1)
    assert got == jax_corpus.get_corpus(1)
    assert list(got) == ["real:a.bin", "real:b.txt"]


@pytest.mark.parametrize("cls", list(corpus.SYNTH_CLASSES))
def test_synthetic_classes_at_another_size_and_seed(cls):
    n = 50_001
    assert corpus.SYNTH_CLASSES[cls](n, seed=7) == \
        jax_corpus.SYNTH_CLASSES[cls](n, seed=7)


def _streams(rng):
    data = make_text(rng, 6000) + bytes(900) + bytes(
        rng.integers(0, 256, 500, dtype=np.uint8))
    return {
        "default": jax_native.encode(data, jax_spec.Params()),
        "la8_sb500": jax_native.encode(data, jax_spec.Params(8, 500)),
        "la255_sb65535": jax_native.encode(data, jax_spec.Params(255, 65535)),
        "empty": jax_native.encode(b"", jax_spec.Params()),
    }


@pytest.mark.parametrize("name", ["default", "la8_sb500", "la255_sb65535",
                                  "empty"])
@pytest.mark.parametrize("limit", [None, 0, 7])
@pytest.mark.parametrize("as_json", [False, True])
def test_dump_output_is_identical(rng, name, limit, as_json):
    stream = _streams(rng)[name]
    want, got = io.StringIO(), io.StringIO()
    jax_dump.dump(stream, limit=limit, as_json=as_json, out=want)
    dump.dump(stream, limit=limit, as_json=as_json, out=got)
    assert got.getvalue() == want.getvalue()
    if as_json:
        _, off, _, _ = codec.bitio.parse_stream(stream)
        assert json.loads(got.getvalue())["tokens"] == off.shape[0]


@pytest.mark.parametrize("args", [["--json"], ["--limit", "3"], []])
def test_dump_main_is_identical(rng, tmp_path, capsys, args):
    path = tmp_path / "s.lz"
    path.write_bytes(_streams(rng)["la8_sb500"])
    assert jax_dump.main([str(path), *args]) == 0
    want = capsys.readouterr()
    assert dump.main([str(path), *args]) == 0
    got = capsys.readouterr()
    assert (got.out, got.err) == (want.out, want.err)


@pytest.mark.parametrize("content", [
    b"", b"\x0f", b"\x00\x00\x00",        # header cut short
    b"\xff\xff\xff\xff\x00",              # widths outside the format
    None,                                 # no such file
])
def test_dump_errors_are_identical(tmp_path, capsys, content):
    path = tmp_path / "bad.lz"
    if content is not None:
        path.write_bytes(content)
    rc_want = jax_dump.main([str(path)])
    want = capsys.readouterr()
    rc_got = dump.main([str(path)])
    got = capsys.readouterr()
    assert rc_got == rc_want == 1
    assert (got.out, got.err) == (want.out, want.err)
    assert got.err.startswith(("Error reading bits:", "Opening input file:"))


def _capped(full, cap, names=None):
    return lambda scale=1: {k: v[:cap] for k, v in full.items()
                            if names is None or k in names}


def _strip(rows):
    return [{k: v for k, v in r.items() if k not in TIMING} for r in rows]


# 4 KiB is about one default search buffer (sb 4095), 64 KiB sixteen of
# them; the device encoders take every class at 4 KiB and two classes at
# 64 KiB, to stay inside the tests' time budget
MULTI_BLOCK = ("synthetic:english", "stress:zeros")


@pytest.mark.parametrize("backend,cap,names", [
    ("native", 64 << 10, None),
    ("device", 4 << 10, None),
    ("fused", 4 << 10, None),
    ("device", 64 << 10, MULTI_BLOCK),
    ("fused", 64 << 10, MULTI_BLOCK),
])
def test_rows_equal_the_jax_runners(corpora, monkeypatch, backend, cap,
                                    names):
    """Both runners over the same corpus cut to ``cap`` bytes a file (the
    files ``names``, or all); the JAX runner's native backend gives the
    rows any exact encoder must give.  Where the C reference's sources are
    present, both build the oracle."""
    monkeypatch.setattr(jax_corpus, "get_corpus",
                        _capped(corpora[0], cap, names))
    monkeypatch.setattr(corpus, "get_corpus",
                        _capped(corpora[1], cap, names))
    monkeypatch.setenv(conformance.REFERENCE_ENV,
                       jax_conformance.REFERENCE_DIR)
    want = jax_conformance.run_conformance(1, "native")
    streams = {}
    got = conformance.run_conformance(1, backend, device="cpu",
                                      streams=streams)
    assert [list(r) for r in got] == [list(r) for r in want]
    assert _strip(got) == _strip(want)
    assert all(r["roundtrip"] for r in got)
    data = corpus.get_corpus(1)
    for name, s in streams.items():
        assert s == jax_native.encode(data[name], jax_spec.Params()), name
    assert "| file | bytes |" in conformance.to_markdown(got)


def test_big_streamed_on_the_cpu_is_verified(tmp_path):
    r = conformance.run_big_streamed(0.0005, str(tmp_path), device="cpu")
    assert r["verified"] and r["self_verified"], r
    assert r["input_bytes"] == int(0.0005 * (1 << 30))
    assert r["pipeline"] == "host"
    assert r["self_decode_peak_rss_mb"] is not None
    jax_keys = inspect.getsource(jax_conformance.run_big_streamed)
    assert all(f'"{k}"' in jax_keys for k in r)


# ---- the decided differences ------------------------------------------

def test_device_backend_takes_the_place_of_jax(capsys):
    with pytest.raises(ValueError, match="native, device, fused"):
        conformance.run_conformance(1, "jax", device="cpu")
    with pytest.raises(SystemExit) as e:
        conformance.main(["--backend", "jax", "--device", "cpu"])
    assert e.value.code == 2
    assert "invalid choice: 'jax'" in capsys.readouterr().err


def test_streams_are_decoded_on_the_device_backend(corpora, monkeypatch):
    seen = []
    real = codec.decode_bytes

    def spy(stream, backend="device", **kw):
        seen.append((backend, str(kw.get("device"))))
        return real(stream, backend, **kw)

    monkeypatch.setattr(codec, "decode_bytes", spy)
    monkeypatch.setattr(corpus, "get_corpus", _capped(corpora[1], 256))
    rows = conformance.run_conformance(1, "native", device="cpu")
    assert all(r["roundtrip"] for r in rows)
    assert seen == [("device", "cpu")] * len(rows)


def test_big_streamed_default_matcher_is_sweep(tmp_path, monkeypatch):
    sig = inspect.signature(conformance.run_big_streamed)
    assert sig.parameters["matcher"].default == "sweep"
    assert sig.parameters["device"].default is None
    monkeypatch.setattr(corpus, "get_corpus",
                        lambda scale=1: {"a": b"abcab" * 200})
    with pytest.raises(ValueError, match="chunked"):
        conformance.run_big_streamed(1e-6, str(tmp_path), matcher="chunked",
                                     device="cpu")
    with pytest.raises(ValueError, match="not ported yet"):
        conformance.run_big_streamed(1e-6, str(tmp_path), pipeline="sharded",
                                     device="cpu")


def test_big_pipeline_sharded_exits_1(capsys):
    assert conformance.main(["--big-pipeline", "sharded", "--big", "1",
                             "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert "not ported yet" in err and "--big-pipeline sharded" in err


def test_oracle_comes_from_the_environment(tmp_path, monkeypatch):
    monkeypatch.delenv(conformance.REFERENCE_ENV, raising=False)
    assert conformance.build_oracle(str(tmp_path)) is None
    monkeypatch.setenv(conformance.REFERENCE_ENV, str(tmp_path / "none"))
    assert conformance.build_oracle(str(tmp_path)) is None


def test_main_writes_the_jax_runners_reports(corpora, tmp_path, monkeypatch,
                                             capsys):
    monkeypatch.setattr(corpus, "get_corpus", _capped(corpora[1], 512))
    md, js = tmp_path / "c.md", tmp_path / "c.json"
    assert conformance.main(["--device", "cpu", "--markdown", str(md),
                             "--json", str(js)]) == 0
    assert json.loads(capsys.readouterr().out) == {"conformance_ok": True,
                                                   "files": 9}
    assert md.read_text().startswith(
        "# Corpus conformance (backend=native, scale=1)\n\n| file |")
    assert len(json.loads(js.read_text())["files"]) == 9


def test_no_card_is_an_error_not_a_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        conformance.run_conformance(1, "native")
