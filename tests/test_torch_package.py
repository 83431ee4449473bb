"""Package rules of the port: what it imports, where it runs, what it
carries across from the JAX package."""

import ast
import json
import os
import pkgutil
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import lz77_tpu
import lz77_tpu_torch
from lz77_tpu_torch import _build, conformance, convert, device, native
from lz77_tpu_torch.experiments import coissue
from lz77_tpu_torch.models import codec, fused
from lz77_tpu_torch.ops import (decode_walk, fused_walk, match, match_chunk,
                                parse_walk)
from lz77_tpu_torch.parallel import distributed, sharded
from lz77_tpu_torch.parallel import mesh as mesh_lib

torch.set_num_threads(1)


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, imported in a fresh interpreter, leaves
    neither ``jax`` nor ``lz77_tpu`` in ``sys.modules``."""
    names = ["lz77_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(
            lz77_tpu_torch.__path__, "lz77_tpu_torch."
        )
    ]
    assert {"lz77_tpu_torch.ops.match", "lz77_tpu_torch.models.fused",
            "lz77_tpu_torch.convert", "lz77_tpu_torch.native",
            "lz77_tpu_torch.cli", "lz77_tpu_torch.ops.match_chunk",
            "lz77_tpu_torch.models.encoder", "lz77_tpu_torch.utils.manifest",
            "lz77_tpu_torch.utils.profiling",
            "lz77_tpu_torch.ops.fused_walk", "lz77_tpu_torch.ops.parse",
            "lz77_tpu_torch.ops.pack", "lz77_tpu_torch.ops.decode",
            "lz77_tpu_torch.models.decoder", "lz77_tpu_torch.corpus",
            "lz77_tpu_torch.dump", "lz77_tpu_torch.conformance",
            "lz77_tpu_torch.experiments.coissue",
            "lz77_tpu_torch.parallel.mesh",
            "lz77_tpu_torch.parallel.sharded",
            "lz77_tpu_torch.parallel.distributed",
            "lz77_tpu_torch.experiments.multihost_bigrun",
            "lz77_tpu_torch.experiments.bigrun_r5"} <= set(names)
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        "from lz77_tpu_torch import cli\n"
        "from lz77_tpu_torch.parallel.sharded import make_sharded_exact_step\n"
        "assert cli.main(['-h']) == 1\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'lz77_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300,
    )
    assert res.returncode == 0, res.stderr


def test_default_device_raises_without_a_card():
    _no_card()
    with pytest.raises(RuntimeError, match="CUDA"):
        device.resolve()
    with pytest.raises(RuntimeError, match="CUDA"):
        lz77_tpu_torch.compress(b"x")
    with pytest.raises(RuntimeError, match="CUDA"):
        lz77_tpu_torch.decompress(lz77_tpu.compress(b"x", backend="numpy"))
    assert device.resolve("cpu") == torch.device("cpu")


@pytest.mark.parametrize(
    "call",
    [
        lambda: match.find_matches(
            np.zeros(8, np.uint8), np.zeros(100, np.uint8),
            np.zeros(14, np.uint8), 0, 8, la=15, sb=100, device="cuda"),
        lambda: fused.encode_batch_walk(
            np.zeros((1, 8), np.uint8), np.zeros((1, 4095), np.uint8),
            np.zeros((1, 14), np.uint8), np.zeros(1, np.int32),
            np.full(1, 8, np.int32), 8, 0, la=15, sb=4095, device="cuda"),
        lambda: fused.encode_bytes_fused(b"abc", device="cuda"),
        lambda: decode_walk.decode_tokens_walk(
            np.array([0]), np.array([0]), np.array([65]), off_bits=12,
            device="cuda"),
        lambda: match.find_matches(
            np.zeros(8, np.uint8), np.zeros(100, np.uint8),
            np.zeros(14, np.uint8), 0, 8, la=15, sb=100, matcher="chunk"),
        lambda: codec.encode_bytes(b"abc", pipeline="host"),
        lambda: list(codec.iter_block_bits(
            np.zeros(8, np.uint8), lz77_tpu_torch.Params())),
        lambda: decode_walk.decode_tokens_walk_packed(
            np.array([0]), np.array([0]), np.array([65]), off_bits=12),
        lambda: fused_walk.encode_batch_sweepwalk(
            np.zeros((1, 8), np.uint8), np.zeros((1, 4095), np.uint8),
            np.zeros((1, 14), np.uint8), np.zeros(1, np.int32),
            np.full(1, 8, np.int32), 8, 0, la=15, sb=4095),
        lambda: fused.encode_bytes_fused(b"abc", parser="merged"),
        lambda: fused.encode_bytes_fused(b"abc", parser="scan"),
        lambda: fused.encode_batch_device(
            np.zeros((1, 8), np.uint8), np.zeros((1, 4095), np.uint8),
            np.zeros((1, 14), np.uint8), np.zeros(1, np.int32),
            np.full(1, 8, np.int32), 8, 0, la=15, sb=4095, device="cuda"),
        lambda: coissue.call_v(3),
        lambda: coissue.probe(),
        lambda: conformance.run_conformance(1, "device"),
        lambda: conformance.run_big_streamed(1e-6, "."),
        lambda: mesh_lib.make_mesh(),
        lambda: sharded.encode_bytes_sharded(b"abc"),
        lambda: sharded.encode_bytes_sharded(b"abc", device="cuda"),
        lambda: codec.encode_bytes(
            b"abc", pipeline="host", match_fn=sharded.sharded_match_fn(
                mesh_lib.make_mesh(4, 2, devices=["cuda"] * 8),
                lz77_tpu_torch.Params())),
        lambda: codec.encode_file(__file__, os.devnull, pipeline="sharded"),
        lambda: distributed.encode_bytes_multihost(b"abc"),
        lambda: distributed.encode_bytes_multihost(b"abc", force=True),
        lambda: distributed.encode_file_multihost(__file__, os.devnull),
        lambda: distributed.encode_bytes_multihost(b"abc", device="cuda"),
        lambda: sharded.make_sharded_pipeline_step(
            mesh_lib.make_mesh(4, 2, devices=["cuda"] * 8),
            lz77_tpu_torch.Params()),
        lambda: match.find_matches(
            np.zeros(8, np.uint8), np.zeros(100, np.uint8),
            np.zeros(14, np.uint8), 0, 8, la=15, sb=100, matcher="brute"),
        lambda: match.find_matches(
            np.zeros(8, np.uint8), np.zeros(100, np.uint8),
            np.zeros(14, np.uint8), 0, 8, la=15, sb=100, matcher="sorted"),
        lambda: match.find_matches(
            np.zeros(8, np.uint8), np.zeros(100, np.uint8),
            np.zeros(14, np.uint8), 0, 8, la=15, sb=100, matcher="chunked"),
        lambda: match.find_matches(
            np.zeros(8, np.uint8), np.zeros(100, np.uint8),
            np.zeros(14, np.uint8), 0, 8, la=15, sb=100, matcher="bitplane"),
        lambda: codec.encode_bytes(b"abc", pipeline="host", matcher="brute"),
        lambda: fused.encode_bytes_fused(b"abc", matcher="sorted"),
        lambda: codec.encode_bytes(b"abc", matcher="chunked"),
        lambda: sharded.encode_bytes_sharded(b"abc", matcher="bitplane"),
        lambda: distributed.encode_bytes_multihost(b"abc", matcher="chunked"),
        lambda: sharded.make_sharded_exact_step(
            mesh_lib.make_mesh(4, 2, devices=["cuda"] * 8),
            lz77_tpu_torch.Params())(
            np.zeros((4, 8), np.uint8), np.zeros((4, 4095), np.uint8),
            np.zeros((4, 14), np.uint8), np.zeros(4, np.int32),
            np.full(4, 8, np.int32), 0),
    ],
    ids=["find_matches", "encode_batch_walk", "encode_bytes_fused",
         "decode_tokens_walk", "find_matches_chunk", "encode_bytes_host",
         "iter_block_bits", "decode_tokens_walk_packed",
         "encode_batch_sweepwalk", "encode_bytes_fused_merged",
         "encode_bytes_fused_scan", "encode_batch_device", "coissue_call_v",
         "coissue_probe", "run_conformance", "run_big_streamed",
         "make_mesh", "encode_bytes_sharded", "encode_bytes_sharded_cuda",
         "sharded_match_fn", "encode_file_sharded", "encode_bytes_multihost",
         "encode_bytes_multihost_forced", "encode_file_multihost",
         "encode_bytes_multihost_cuda", "make_sharded_pipeline_step",
         "find_matches_brute", "find_matches_sorted", "find_matches_chunked",
         "find_matches_bitplane", "encode_bytes_host_brute",
         "encode_bytes_fused_sorted", "encode_bytes_chunked",
         "encode_bytes_sharded_bitplane", "encode_bytes_multihost_chunked",
         "make_sharded_exact_step"],
)
def test_cuda_without_a_card_raises_and_does_not_fall_back(call):
    _no_card()
    def counts():
        return (match.match_sweep.launches,
                parse_walk.walk_parse_pack.launches,
                decode_walk.walk_decode.launches,
                match_chunk.match_chunk.launches,
                decode_walk.walk_decode_packed.launches,
                fused_walk.sweep_walk.launches,
                *(f.launches for f in (coissue.call_v, coissue.call_s,
                                       coissue.call_f, coissue.call_q)))

    before = counts()
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
    assert before == counts()


def test_file_entry_points_raise_without_a_card(tmp_path):
    _no_card()
    ip = tmp_path / "in"
    ip.write_bytes(b"file entry points run on the card " * 9)
    sp = tmp_path / "s.lz"
    sp.write_bytes(lz77_tpu.compress(ip.read_bytes(), backend="numpy"))
    for pipeline in ("host", "fused", "sharded"):
        with pytest.raises(RuntimeError, match="CUDA"):
            lz77_tpu_torch.compress_file(str(ip), str(tmp_path / "o"),
                                         pipeline=pipeline)
    with pytest.raises(RuntimeError, match="CUDA"):
        lz77_tpu_torch.decompress_file(str(sp), str(tmp_path / "o"))
    with pytest.raises(RuntimeError, match="CUDA"):
        codec.decode_file_device(str(sp), str(tmp_path / "o"))
    # the multi-process file encode raises before it writes anything, and
    # so does each rank of its command line
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed.encode_file_multihost(str(ip), str(tmp_path / "mh.lz"))
    assert not (tmp_path / "mh.lz").exists()
    with pytest.raises(RuntimeError, match="rank 0 of 1 exited 1"):
        distributed.launch(["-i", str(ip), "-o", str(tmp_path / "mh.lz")], 1,
                           timeout=120)
    assert not list(tmp_path.glob("mh.lz*"))
    # the host backends need no card
    assert lz77_tpu_torch.decompress_file(
        str(sp), str(tmp_path / "o"), backend="native") == ip.stat().st_size


def test_kernel_build_raises_without_nvcc():
    """The kernels are built from source at first use; a machine without
    the CUDA toolkit gets an error that says so, not a fallback."""
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is present")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.kernels()


def test_cpu_tensors_take_the_plain_version_and_count_no_launch(rng):
    data = bytes(rng.integers(0, 3, 400, dtype=np.uint8))
    s = lz77_tpu_torch.compress(data, device="cpu")
    assert lz77_tpu_torch.decompress(s, device="cpu") == data
    assert match.match_sweep.launches == 0
    assert parse_walk.walk_parse_pack.launches == 0
    assert decode_walk.walk_decode.launches == 0
    s2 = lz77_tpu_torch.compress(data, device="cpu", pipeline="host",
                                 matcher="chunk")
    assert s2 == s
    assert match_chunk.match_chunk.launches == 0
    s3 = fused.encode_bytes_fused(data, parser="merged", device="cpu")
    assert s3 == s
    assert fused_walk.sweep_walk.launches == 0


def test_every_kernel_source_is_built_and_packaged():
    """Each ``csrc/*.cu`` is in the build's source list, and the packaging
    glob carries the directory."""
    on_disk = sorted(f for f in os.listdir(_build.CSRC) if f.endswith(".cu"))
    assert sorted(_build.KERNEL_SOURCES) == on_disk
    assert "fused_walk.cu" in on_disk
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "pyproject.toml")) as f:
        assert 'lz77_tpu_torch = ["csrc/*.cu", "csrc/*.cuh"]' in f.read()
    # every header a source includes lies beside it
    for src in on_disk:
        with open(os.path.join(_build.CSRC, src)) as f:
            for line in f:
                if line.startswith('#include "'):
                    assert os.path.exists(
                        os.path.join(_build.CSRC, line.split('"')[1]))


def test_every_subpackage_is_packaged():
    """``pyproject.toml`` lists every package of the port, so an install
    carries the experiments too."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "pyproject.toml")) as f:
        text = f.read()
    pkgs = ["lz77_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(
            lz77_tpu_torch.__path__, "lz77_tpu_torch.") if m.ispkg]
    assert "lz77_tpu_torch.experiments" in pkgs
    for name in pkgs:
        assert f'"{name}",' in text, name


def test_kernel_tag_follows_headers_too(tmp_path, monkeypatch):
    """The library's name hashes every file under ``csrc/``: a changed
    header (which no ``KERNEL_SOURCES`` entry names) gives a new tag, so a
    library built from the old header is never loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    headers = sorted(f for f in os.listdir(csrc) if f.endswith(".cuh"))
    assert headers == ["decode_common.cuh", "match_common.cuh"]
    assert not set(headers) & set(_build.KERNEL_SOURCES)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    assert _build.kernel_tag() != ""
    seen = [_build.kernel_tag()]
    assert seen[0] == _build.kernel_tag()
    for name in (*headers, "match.cu"):
        with open(csrc / name, "ab") as f:
            f.write(b"\n// changed\n")
        assert _build.kernel_tag() not in seen
        seen.append(_build.kernel_tag())


def test_convert_params_and_batch():
    p = convert.params_from_reference(np.int64(16), np.int32(4095))
    assert (p.la, p.sb, p.width) == (16, 4095, 24)
    assert p == lz77_tpu_torch.Params(16, 4095)
    with pytest.raises(ValueError):
        convert.params_from_reference(1, 4095)
    gb = np.arange(12, dtype=np.int64).reshape(2, 6)
    out = convert.batch_from_numpy(
        gb, np.zeros((2, 3)), np.zeros((2, 1)), [0, 3], [7, 6],
        np.int32(12), np.int32(2), device="cpu",
    )
    blocks, halos, rights, avails, vexts, vt, entry = out
    assert blocks.dtype == halos.dtype == rights.dtype == torch.uint8
    assert avails.dtype == vexts.dtype == entry.dtype == torch.int32
    assert entry.shape == (1,) and int(entry) == 2 and vt == 12
    np.testing.assert_array_equal(blocks.numpy(), gb)


def test_convert_tables_lox_and_tokens_round_trip(rng):
    """LOX and decode words unpack to the fields that went in, bytes >= 128
    (sign bit of the int32 word) included."""
    N, la = 50, 15
    L = rng.integers(0, 15, N)
    O = rng.integers(0, 65536, N)
    x = rng.integers(0, 256, N, dtype=np.uint8)
    tail = rng.integers(128, 256, 14, dtype=np.uint8)
    Lt, Ot = convert.tables_from_numpy(L.reshape(5, 10), O.reshape(5, 10), "cpu")
    assert Lt.dtype == Ot.dtype == torch.int32 and Lt.shape == (5, 10)
    lox = convert.lox_from_numpy(L, O, x, tail, la, device="cpu")
    w = lox.numpy().view(np.uint32)
    assert w.shape == (N + la,)
    np.testing.assert_array_equal(w[:N] & 0xFFFF, O)
    np.testing.assert_array_equal((w[:N] >> 16) & 0xFF, L)
    np.testing.assert_array_equal(w[:N] >> 24, x)
    np.testing.assert_array_equal(w[N : N + 14], tail.astype(np.uint32) << 24)
    assert w[N + 14] == 0

    off = rng.integers(0, 65536, 40)
    ln = rng.integers(0, 255, 40)
    nxt = rng.integers(0, 256, 40)
    t = convert.tokens_from_numpy(off, ln, nxt, device="cpu")
    assert t.dtype == torch.int32
    u = t.numpy().view(np.uint32)
    np.testing.assert_array_equal(u & 0xFFFF, off)
    np.testing.assert_array_equal((u >> 16) & 0xFF, ln)
    np.testing.assert_array_equal(u >> 24, nxt)


def test_run_report_and_scaling_efficiency_match_jax():
    """The port's copy of ``utils.metrics`` gives the JAX package's values
    (``tests/test_utils.py``'s case and the edges)."""
    from lz77_tpu.utils import metrics as jax_metrics
    from lz77_tpu_torch.utils import metrics

    for kw in (dict(mode="encode", input_bytes=1000, output_bytes=500,
                    seconds=0.5),
               dict(mode="decode", input_bytes=0, tokens=7, blocks=2,
                    seconds=0.0, device="cuda", backend="device")):
        got = json.loads(metrics.RunReport(**kw).to_json())
        assert got == json.loads(jax_metrics.RunReport(**kw).to_json())
    assert json.loads(metrics.RunReport(
        mode="encode", input_bytes=1000, output_bytes=500,
        seconds=0.5).to_json())["mb_per_s"] == 0.002
    for args in ((7.2, 1.0, 8), (3.0, 2.0, 2), (1.0, 0.0, 4), (1.0, 1.0, 0),
                 (0.0, 1.0, 3), (5.0, -1.0, 2)):
        assert (metrics.scaling_efficiency(*args)
                == jax_metrics.scaling_efficiency(*args))
    assert metrics.scaling_efficiency(7.2, 1.0, 8) == pytest.approx(0.9)


def test_native_cli_builds_once_and_round_trips(tmp_path, rng):
    """``native.build_cli`` builds the standalone CLI into the port's build
    directory once; its encode is ``native.encode``'s stream and its decode
    gives the input back."""
    cli_bin = native.build_cli()
    assert cli_bin == native.build_cli()
    assert os.path.dirname(cli_bin) == _build.BUILD_DIR
    data = bytes(rng.integers(0, 4, 20000, dtype=np.uint8)) + b"tail" * 500
    src, enc, dec = tmp_path / "in", tmp_path / "in.lz", tmp_path / "out"
    src.write_bytes(data)
    for la, sb in ((15, 4095), (8, 500)):
        res = subprocess.run(
            [cli_bin, "-c", "-i", str(src), "-o", str(enc), "-l", str(la),
             "-s", str(sb), "-r"], capture_output=True, text=True)
        assert res.returncode == 0, res.stderr
        assert json.loads(res.stderr.strip().splitlines()[-1])["mode"] == \
            "encode"
        assert enc.read_bytes() == native.encode(data, lz77_tpu_torch.Params(
            la, sb))
        subprocess.run([cli_bin, "-d", "-i", str(enc), "-o", str(dec)],
                       check=True)
        assert dec.read_bytes() == data


# Public names of the JAX package with no same-named counterpart in the port
# module of the same path.  An alias names the port's function that takes
# its place; every other entry is a decided difference whose reason stands
# in ROADMAP.md section 3.
JAX_ALIASES = {
    "lz77_tpu/ops/pallas_bitplane.py::find_matches_bitplane_pallas":
        "lz77_tpu_torch/ops/match.py::match_sweep",
    "lz77_tpu/ops/pallas_match.py::find_matches_pallas":
        "lz77_tpu_torch/ops/match_chunk.py::match_chunk",
    "experiments/bigrun_r5.py::chunk_equal":
        "lz77_tpu_torch/conformance.py::chunk_equal",
}
JAX_DECIDED = {
    "lz77_tpu/ops/decode_walk.py::decode_geometry",
    "lz77_tpu/ops/decode_walk.py::stage_tokens",
    "lz77_tpu/ops/parse_walk.py::walk_geometry",
    "lz77_tpu/ops/parse_walk.py::stage_lox",
    "lz77_tpu/ops/fused_walk.py::geometry",
    "lz77_tpu/ops/pallas_bitplane.py::preferred_block_size",
    "lz77_tpu/native.py::available",
    "experiments/multihost_bigrun.py::run_cluster",
    "experiments/multihost_bigrun.py::free_port",
}


_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)


def _module_body(path):
    with open(path) as f:
        return ast.parse(f.read()).body


def _public_defs(path):
    """The public top-level functions and classes of a module (``ast``)."""
    return {n.name for n in _module_body(path)
            if isinstance(n, _DEFS) and not n.name.startswith("_")}


def _top_level(path):
    """Every name a module binds at its top level: functions, classes,
    assignments and ``from`` imports (``ast``)."""
    names = set()
    for n in _module_body(path):
        if isinstance(n, _DEFS):
            names.add(n.name)
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            names.update(t.id for t in targets if isinstance(t, ast.Name))
        elif isinstance(n, ast.ImportFrom):
            names.update(a.asname or a.name for a in n.names)
    return names


def test_every_public_jax_function_has_a_counterpart():
    """Every public top-level function and class of ``lz77_tpu/**/*.py``
    and ``experiments/*.py`` (read with ``ast``; neither is imported) has a
    same-named counterpart in the port module of the same path
    (``lz77_tpu_torch/...``, ``lz77_tpu_torch/experiments/...``), or an
    entry in ``JAX_ALIASES`` (whose target exists) or ``JAX_DECIDED``
    (whose name ROADMAP.md section 3 gives); no entry is stale."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pairs = []
    for d, _, files in os.walk(os.path.join(root, "lz77_tpu")):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(d, f), root)
                pairs.append((rel, "lz77_tpu_torch" + rel[len("lz77_tpu"):]))
    for f in os.listdir(os.path.join(root, "experiments")):
        if f.endswith(".py"):
            pairs.append((f"experiments/{f}", f"lz77_tpu_torch/experiments/{f}"))
    assert len(pairs) > 30
    missing = set()
    for src, dst in pairs:
        dst_path = os.path.join(root, dst)
        have = _top_level(dst_path) if os.path.exists(dst_path) else set()
        missing |= {f"{src}::{name}" for name in
                    _public_defs(os.path.join(root, src)) - have}
    assert missing == set(JAX_ALIASES) | JAX_DECIDED
    assert not any(k.endswith("::make_sharded_exact_step") for k in missing)
    for target in JAX_ALIASES.values():
        path, name = target.split("::")
        assert name in _top_level(os.path.join(root, path)), target
    with open(os.path.join(root, "ROADMAP.md")) as f:
        roadmap = f.read()
    section = roadmap.split("### 3.")[1].split("\n## ")[0]
    for key in JAX_DECIDED:
        assert f"`{key.split('::')[1]}`" in section, key
