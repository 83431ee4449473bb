"""Port file surface (codec.encode_file / decode_file / decode_file_device,
compress_file / decompress_file, the manifest) against the JAX package's.

The same files go through both packages on the CPU.  Tolerance 0: streams,
decoded files, manifests and error texts.
"""

import json
import os

import numpy as np
import pytest
import torch

import lz77_tpu_torch
from lz77_tpu import bitio as jax_bitio
from lz77_tpu import spec
from lz77_tpu.models import codec as jax_codec
from lz77_tpu.utils import faults as jax_faults
from lz77_tpu.utils import manifest as jax_manifest
from lz77_tpu_torch import bitio, convert, native
from lz77_tpu_torch.models import codec
from lz77_tpu_torch.ops import decode_walk
from lz77_tpu_torch.utils import faults, manifest

from conftest import make_text

torch.set_num_threads(1)

P = spec.Params(la=255, sb=255)      # 24-bit tokens, byte-aligned
P20 = spec.Params(la=8, sb=500)      # 20-bit tokens
GEO = dict(block_size=4096, batch_blocks=2)


@pytest.fixture(scope="module")
def payload(rng):
    return (
        np.asarray(rng.integers(97, 101, 30_000, dtype=np.uint8)).tobytes()
        + make_text(rng, 8_000) + b"\x00" * 3_000
    )


@pytest.fixture(scope="module")
def ref_streams(payload):
    """The JAX package's own file encode, per parameter set."""
    return {
        p: jax_codec.encode_bytes(payload, p, matcher="chunked", **GEO)
        for p in (P, P20)
    }


def _files(tmp_path, payload):
    ip = tmp_path / "in"
    ip.write_bytes(payload)
    return str(ip), str(tmp_path / "out"), str(tmp_path / "m.json")


@pytest.mark.parametrize("pipeline,params", [("host", P), ("host", P20),
                                              ("fused", P)],
                         ids=["host24", "host20", "fused24"])
def test_encode_file_matches_jax(tmp_path, payload, ref_streams, pipeline,
                                 params):
    ip, op, _ = _files(tmp_path, payload)
    jax_out = str(tmp_path / "jax_out")
    jax_codec.encode_file(ip, jax_out, params, matcher="chunked",
                          pipeline=pipeline, **GEO)
    st = codec.EncodeStats()
    codec.encode_file(ip, op, params, pipeline=pipeline, stats=st,
                      device="cpu", **GEO)
    with open(op, "rb") as f, open(jax_out, "rb") as g:
        got = f.read()
        assert got == g.read() == ref_streams[params]
    assert st.page_release  # flat-RSS memmap streaming is active
    assert st.tokens == spec.token_count(len(got) - 4, params.width)
    assert st.output_bytes == len(got) and st.input_bytes == len(payload)
    assert st.blocks == -(-len(payload) // 4096)


@pytest.mark.parametrize("pipeline,params,matcher",
                         [("host", P, "chunk"), ("host", P20, "sweep"),
                          ("fused", P, "sweep")],
                         ids=["host24", "host20", "fused24"])
def test_manifest_and_resume_at_a_batch_boundary(
    tmp_path, payload, ref_streams, pipeline, params, matcher
):
    ip, op, mp = _files(tmp_path, payload)
    kw = dict(pipeline=pipeline, matcher=matcher, manifest_path=mp,
              device="cpu", **GEO)
    inj = faults.FaultInjector({3: 5})  # past retries=2: the run dies
    with pytest.raises(RuntimeError, match="injected fault"):
        codec.encode_file(ip, op, params, fault_injector=inj, **kw)
    assert os.path.exists(mp)  # checkpoint survives the crash
    man = manifest.Manifest.load(mp)
    assert man.pipeline == pipeline and man.completed() > 0
    codec.encode_file(ip, op, params, resume=True, **kw)
    with open(op, "rb") as f:
        assert f.read() == ref_streams[params]
    assert not os.path.exists(mp) and not os.path.exists(op + ".partial")


@pytest.mark.parametrize("pipeline,params", [("host", P), ("host", P20),
                                              ("fused", P)],
                         ids=["host24", "host20", "fused24"])
def test_manifests_cross_between_the_packages(
    tmp_path, payload, ref_streams, pipeline, params
):
    """A run killed in one package resumes in the other, both ways, and
    gives the same stream; the manifest JSON is the same dict."""
    ip, op, mp = _files(tmp_path, payload)
    # killed in the JAX package, finished by the port
    with pytest.raises(RuntimeError):
        jax_codec.encode_file(
            ip, op, params, matcher="chunked", pipeline=pipeline,
            manifest_path=mp, fault_injector=jax_faults.FaultInjector({3: 5}),
            **GEO,
        )
    with open(mp) as f:
        d = json.load(f)
    man = convert.manifest_from_dict(d)
    assert convert.manifest_to_dict(man) == d
    assert man == manifest.Manifest.load(mp)
    assert man.completed() == len(d["blocks"]) > 0
    ran = []
    real = codec._batch_inputs

    def spy(x, n, g0, *a):
        ran.append(g0)
        return real(x, n, g0, *a)

    codec._batch_inputs = spy
    try:
        codec.encode_file(ip, op, params, pipeline=pipeline,
                          manifest_path=mp, resume=True, device="cpu", **GEO)
    finally:
        codec._batch_inputs = real
    assert min(ran) > 0  # the completed batches were skipped, not redone
    with open(op, "rb") as f:
        assert f.read() == ref_streams[params]

    # killed in the port, finished by the JAX package
    with pytest.raises(RuntimeError):
        codec.encode_file(
            ip, op, params, pipeline=pipeline, manifest_path=mp,
            fault_injector=faults.FaultInjector({3: 5}), device="cpu", **GEO,
        )
    jman = jax_manifest.Manifest.load(mp)
    assert jman.compatible_with(
        params, 4096, len(payload), pipeline=pipeline,
        batch_blocks=0 if pipeline == "host" else 2,
    )
    assert jman.completed() > 0
    jax_codec.encode_file(ip, op, params, matcher="chunked",
                          pipeline=pipeline, manifest_path=mp, resume=True,
                          **GEO)
    with open(op, "rb") as f:
        assert f.read() == ref_streams[params]


def test_deleted_scratch_restarts_instead_of_zero_fill(
    tmp_path, payload, ref_streams
):
    """A manifest whose .partial payload vanished must restart from batch 0,
    not zero-extend a recreated file into a silently corrupt stream."""
    for pipeline in ("host", "fused"):
        ip, op, mp = _files(tmp_path, payload)
        kw = dict(pipeline=pipeline, manifest_path=mp, device="cpu", **GEO)
        with pytest.raises(RuntimeError):
            codec.encode_file(ip, op, P, **kw,
                              fault_injector=faults.FaultInjector({3: 5}))
        os.unlink(op + ".partial")  # the failure being injected
        codec.encode_file(ip, op, P, resume=True, **kw)
        with open(op, "rb") as f:
            assert f.read() == ref_streams[P]


def test_incompatible_manifest_restarts(tmp_path, payload, ref_streams):
    ip, op, mp = _files(tmp_path, payload)
    with pytest.raises(RuntimeError):
        codec.encode_file(ip, op, P20, manifest_path=mp, device="cpu",
                          fault_injector=faults.FaultInjector({3: 5}), **GEO)
    codec.encode_file(ip, op, P, manifest_path=mp, resume=True, device="cpu",
                      **GEO)
    with open(op, "rb") as f:
        assert f.read() == ref_streams[P]


def test_encode_file_rejections(tmp_path, payload):
    ip, op, _ = _files(tmp_path, payload[:1000])
    with pytest.raises(ValueError, match="byte-aligned") as port:
        codec.encode_file(ip, op, spec.Params(la=9, sb=511),
                          pipeline="fused", device="cpu")
    with pytest.raises(ValueError, match="byte-aligned") as ref:
        jax_codec.encode_file(ip, op, spec.Params(la=9, sb=511),
                              pipeline="fused")
    assert str(port.value) == str(ref.value)
    # the sharded pipeline runs (on a one-member mesh on the device given)
    codec.encode_file(ip, op, P, pipeline="sharded", device="cpu")
    with open(op, "rb") as f:
        assert f.read() == jax_codec.encode_bytes(payload[:1000], P)
    with pytest.raises(ValueError, match="unknown pipeline"):
        codec.encode_file(ip, op, P, pipeline="nope", device="cpu")
    # the fused pipeline takes every matcher name (it refused all but the
    # sweep before the JAX package's XLA matchers were ported)
    codec.encode_file(ip, op, P, pipeline="fused", matcher="chunk",
                      device="cpu")
    with open(op, "rb") as f:
        assert f.read() == jax_codec.encode_bytes(payload[:1000], P)
    with pytest.raises(ValueError, match="unknown matcher"):
        codec.encode_file(ip, op, P, pipeline="fused", matcher="nope",
                          device="cpu")


def test_compress_file_and_decompress_file(tmp_path, payload, ref_streams):
    ip, op, _ = _files(tmp_path, payload)
    back = str(tmp_path / "back")
    lz77_tpu_torch.compress_file(ip, op, P.la, P.sb, device="cpu", **GEO)
    with open(op, "rb") as f:
        assert f.read() == ref_streams[P]
    lz77_tpu_torch.compress_file(ip, op, P.la, P.sb, pipeline="fused",
                                 device="cpu", **GEO)
    with open(op, "rb") as f:
        assert f.read() == ref_streams[P]
    for backend in ("device", "native", "host"):
        n = lz77_tpu_torch.decompress_file(op, back, backend=backend,
                                           device="cpu")
        assert n == len(payload)
        with open(back, "rb") as f:
            assert f.read() == payload


@pytest.mark.parametrize(
    "backend,expect",
    [("device", "device-walk-streamed"), ("native", "native-streamed"),
     ("host", "host")],
)
def test_decode_file_backends(tmp_path, payload, ref_streams, backend, expect):
    sp = tmp_path / "s.lz"
    sp.write_bytes(ref_streams[P20])
    st = codec.DecodeStats()
    n = codec.decode_file(str(sp), str(tmp_path / "o"), backend=backend,
                          stats=st, device="cpu")
    assert n == len(payload) == st.output_bytes
    assert st.backend == expect and st.requested == backend
    assert (tmp_path / "o").read_bytes() == payload
    with pytest.raises(ValueError, match="unknown decode backend"):
        codec.decode_file(str(sp), str(tmp_path / "o"), backend="auto",
                          device="cpu")


# ---- the cases of the JAX package's streamed device decode tests ----------

def _roundtrip(tmp_path, data, params, **kw):
    stream = native.encode(data, params)
    sp = tmp_path / "s.lz"
    sp.write_bytes(stream)
    op = tmp_path / "s.out"
    st = codec.DecodeStats()
    tot = codec.decode_file_device(str(sp), str(op), stats=st, device="cpu",
                                   **kw)
    assert st.backend == "device-walk-streamed"
    assert tot == len(data)
    assert op.read_bytes() == data == native.decode(stream)
    return st


@pytest.mark.parametrize(
    "la,sb",
    [(15, 4095), (15, 15), (9, 511)],  # 24-bit, 16-bit, 21-bit tokens
)
def test_device_stream_roundtrip(tmp_path, rng, la, sb):
    p = spec.Params(la=la, sb=sb)
    data = (
        make_text(rng, 60_000)
        + b"\x00" * 30_000
        + np.asarray(rng.integers(0, 256, 20_000, dtype=np.uint8)).tobytes()
    )
    st = _roundtrip(
        tmp_path, data, p, tokens_per_stage=4096, out_cap_words=1 << 16
    )
    assert st.stages >= 3
    assert set(st.phases) == {"read", "validate", "device", "write"}


def test_device_stream_tiny_stages(tmp_path, rng):
    """Aggressively small stages: many window handoffs (a window shorter
    than d_limit grows across stages), and the output-budget limiter
    splitting a file chunk into several stages."""
    p = spec.Params(la=15, sb=255)
    data = b"ab" * 3_000 + make_text(rng, 20_000) + b"\x00" * 9_000
    st = _roundtrip(
        tmp_path, data, p,
        tokens_per_stage=1024, out_cap_words=4096, read_tokens=2048,
    )
    assert st.stages > 8
    _roundtrip(tmp_path, data, p, tokens_per_stage=8, out_cap_words=300,
               read_tokens=64)


def test_device_stream_stage_count_counts_kernel_calls(tmp_path, rng,
                                                       monkeypatch):
    calls = []
    real = decode_walk.walk_decode

    def spy(toks, total, **kw):
        calls.append((total, kw["wp"]))
        return real(toks, total, **kw)

    monkeypatch.setattr(decode_walk, "walk_decode", spy)
    data = make_text(rng, 30_000)
    st = _roundtrip(tmp_path, data, spec.Params(la=15, sb=255),
                    tokens_per_stage=2048)
    assert st.stages == len(calls) >= 3
    # every stage after the first is primed with the d_limit-byte window
    assert calls[0][1] == 0 and {c[1] for c in calls[1:]} == {255}
    assert all(c[0] <= 2048 for c in calls)


def test_device_stream_edge_inputs(tmp_path):
    for data in (b"", b"x", b"\x00" * 14):
        _roundtrip(tmp_path, data, spec.Params())


def test_device_stream_rejects_corrupt_with_the_jax_texts(tmp_path):
    """Corrupt and truncated streams raise the same ValueError text in both
    packages."""
    p = spec.Params()
    cases = {
        # offset beyond decoded history
        "history": jax_bitio.build_stream(
            np.array([0, 300], np.int64), np.array([0, 3], np.int64),
            np.array([65, 66], np.int64), p),
        # offset 0 with a length
        "zero": bitio.build_stream(
            np.array([0, 0], np.int64), np.array([0, 2], np.int64),
            np.array([65, 66], np.int64), p),
        "no_header": b"\xff\x0f",
        "bad_header": b"\xff\x0f\x01\x00" + b"\x00" * 6,  # la = 1
    }
    sp = tmp_path / "c.lz"
    for name, stream in cases.items():
        sp.write_bytes(stream)
        with pytest.raises(ValueError, match="header|corrupt") as ref:
            jax_codec.decode_file_device(str(sp), str(tmp_path / "o"),
                                         interpret=True)
        with pytest.raises(ValueError, match="header|corrupt") as port:
            codec.decode_file_device(str(sp), str(tmp_path / "o"),
                                     device="cpu")
        assert str(port.value) == str(ref.value), name
        with pytest.raises(ValueError):
            codec.decode_file(str(sp), str(tmp_path / "o"), backend="device",
                              device="cpu")


def test_device_stream_truncated_payload_decodes_whole_tokens(tmp_path, rng):
    """A stream cut mid-token decodes its whole tokens, as the native
    streamed decoder does (the EOF padding rule, lz77.c:266-280)."""
    data = make_text(rng, 5_000)
    stream = native.encode(data, spec.Params())
    sp = tmp_path / "t.lz"
    sp.write_bytes(stream[: len(stream) // 2 + 1])
    n = codec.decode_file_device(str(sp), str(tmp_path / "o"), device="cpu")
    m = native.decode_file(str(sp), str(tmp_path / "o2"))
    assert n == m > 0
    assert (tmp_path / "o").read_bytes() == (tmp_path / "o2").read_bytes()
    assert data.startswith((tmp_path / "o").read_bytes())
