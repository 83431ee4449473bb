"""Port CLI (lz77_tpu_torch.cli) against the JAX package's CLI.

Both ``main(argv)`` run in-process on the same files: same exit code, same
stderr text for every validation error, same stdout, same output file.  The
port's runs add ``--device cpu`` (its kernels' plain PyTorch versions); what
the two surfaces name differently (``--backend device`` for ``jax``, the
matcher names, ``--device`` for ``--platform``) is pinned here too.  The
JAX CLI's ``--pipeline sharded`` runs on its virtual 8-device CPU mesh.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from lz77_tpu import cli as jax_cli
from lz77_tpu_torch import cli, native, spec
from lz77_tpu_torch.models import spec_np

from conftest import CORPUS_SMALL, make_text

torch.set_num_threads(1)

CPU = ["--device", "cpu"]


def run(main, argv, capsys):
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def both(argv, capsys, port_extra=(), jax_extra=()):
    """Run both CLIs on ``argv``; returns ((rc, out, err), (rc, out, err))."""
    ref = run(jax_cli.main, list(argv) + list(jax_extra), capsys)
    got = run(cli.main, list(argv) + list(port_extra), capsys)
    return ref, got


@pytest.fixture()
def scratch(tmp_path):
    inp = tmp_path / "in.bin"
    inp.write_bytes(b"differential cli test input, abcabcabcabc" * 40)
    return {"in": str(inp), "out": str(tmp_path / "out.bin"),
            "out2": str(tmp_path / "out2.bin"), "dir": tmp_path}


def fill(argv, scratch):
    return [a.replace("{in}", scratch["in"]).replace("{out}", scratch["out"])
            for a in argv]


# every validation error of the reference surface, in its order
ERROR_MATRIX = [
    (["-c", "-o", "{out}"], "Input file must be provided"),
    (["-c", "-i", "{in}"], "Output file must be provided"),
    (["-i", "{in}", "-o", "{out}"], "Select ENCODE or DECODE mode"),
    (["-c", "-i", "{in}", "-o", "{out}", "-l", "999"],
     "Bad lookahead size value."),
    (["-c", "-i", "{in}", "-o", "{out}", "-l", "1"],
     "Bad lookahead size value."),
    (["-c", "-i", "{in}", "-o", "{out}", "-s", "70000"],
     "Bad search-buffer size value."),
    (["-c", "-i", "{in}", "-i", "{in}", "-o", "{out}"],
     "Multiple input files not allowed."),
    (["-c", "-i", "{in}", "-o", "{out}", "-o", "{out}"],
     "Multiple output files not allowed."),
    # the order of the checks: duplicates before ranges before missing files
    (["-i", "{in}", "-i", "{in}", "-l", "1"],
     "Multiple input files not allowed."),
    (["-l", "1", "-s", "70000"], "Bad lookahead size value."),
    (["-s", "70000"], "Bad search-buffer size value."),
    (["-c", "-i", "{in}", "-o", "{out}", "-s", "1024"], "is degenerate"),
    (["-c", "-i", "{in}", "-o", "{out}", "-s", "1"], "is degenerate"),
    (["-c", "-i", "{in}", "-o", "{out}", "-s", "0", "--force-sb"],
     "is degenerate"),
    (["-c", "-i", "{in}.nope", "-o", "{out}"], "Opening input file: "),
    (["-d", "-i", "{in}.nope", "-o", "{out}"], "Opening input file: "),
]


@pytest.mark.parametrize("argv,message", ERROR_MATRIX,
                         ids=[f"{i}-{m.strip(' :.')}" for i, (_, m)
                              in enumerate(ERROR_MATRIX)])
def test_validation_errors_match(scratch, capsys, argv, message):
    ref, got = both(fill(argv, scratch), capsys)
    assert ref[0] == got[0] == 1
    assert message in ref[2]
    assert got[2] == ref[2]  # the same text, byte for byte
    assert got[1] == ref[1] == ""
    assert not os.path.exists(scratch["out"])


def test_help_alone_prints_usage_then_fails(capsys):
    ref, got = both(["-h"], capsys)
    assert got == ref
    assert ref[0] == 1 and ref[1].startswith("Usage: lz77 <options>")
    assert cli.USAGE_TEXT == jax_cli.USAGE_TEXT


def test_help_with_full_command_still_encodes(scratch, capsys):
    argv = ["-h", "-c", "-i", scratch["in"], "-o", scratch["out"],
            "--backend", "native"]
    rc, out, _ = run(jax_cli.main, argv, capsys)
    with open(scratch["out"], "rb") as f:
        ref_stream = f.read()
    os.unlink(scratch["out"])
    rc2, out2, _ = run(cli.main, argv, capsys)
    assert rc == rc2 == 0 and out2 == out == cli.USAGE_TEXT
    with open(scratch["out"], "rb") as f:
        assert f.read() == ref_stream


@pytest.mark.parametrize("mode", ["-c", "-d"])
def test_unwritable_output_message_matches(scratch, capsys, mode):
    src = scratch["in"]
    if mode == "-d":
        src = scratch["out2"]
        with open(src, "wb") as f:
            f.write(native.encode(b"some bytes to decode" * 9))
    argv = [mode, "-i", src, "-o", str(scratch["dir"] / "no" / "dir" / "o"),
            "--backend", "native"]
    ref, got = both(argv, capsys)
    assert got == ref
    assert ref[0] == 1 and ref[2].startswith("Opening output file: ")


def test_mode_last_one_wins(scratch, capsys):
    argv = ["-d", "-c", "-i", scratch["in"], "-o", scratch["out"],
            "--backend", "native"]
    assert run(jax_cli.main, argv, capsys)[0] == 0
    with open(scratch["out"], "rb") as f:
        ref_stream = f.read()
    assert run(cli.main, argv, capsys)[0] == 0
    with open(scratch["out"], "rb") as f:
        assert f.read() == ref_stream  # both encoded


@pytest.mark.parametrize(
    "flags",
    [[], ["-l", "32"], ["-s", "1023"], ["-l", "8", "-s", "255"],
     ["-l", "8", "-s", "500", "--block-size", "512"],
     ["-s", "4", "--force-sb"], ["--block-size", "256", "--batch-blocks", "3"],
     ["-s", "15", "--pipeline", "fused", "--block-size", "512"]],
    ids=["default", "l32", "s1023", "l8s255", "unaligned20", "force_sb",
         "geometry", "fused16"],
)
def test_device_encode_and_decode_match_over_flag_matrix(
    scratch, capsys, flags
):
    """Encode on the device backend of both CLIs: the same stream; decode
    each with every decode backend of the port: the input again."""
    with open(scratch["in"], "rb") as f:
        data = f.read()
    base = ["-c", "-i", scratch["in"], "-o"]
    assert run(jax_cli.main, base + [scratch["out2"]] + flags, capsys)[0] == 0
    assert run(cli.main, base + [scratch["out"]] + flags + CPU, capsys)[0] == 0
    with open(scratch["out"], "rb") as f, open(scratch["out2"], "rb") as g:
        stream = f.read()
        assert stream == g.read()
    back = str(scratch["dir"] / "back")
    for be in ("device", "native", "host"):
        rc, _, _ = run(cli.main, ["-d", "-i", scratch["out"], "-o", back,
                                  "--decode-backend", be] + CPU, capsys)
        assert rc == 0
        with open(back, "rb") as f:
            assert f.read() == data


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_host_backends_roundtrip_and_match(scratch, capsys, backend):
    data = CORPUS_SMALL["runs"](None)[:500]
    with open(scratch["in"], "wb") as f:
        f.write(data)
    argv = ["-c", "-i", scratch["in"], "-o", scratch["out"], "--backend",
            backend, "--threads", "2"]
    ref, got = both(argv, capsys)
    assert ref[0] == got[0] == 0
    with open(scratch["out"], "rb") as f:
        assert f.read() == spec_np.encode(data, spec.Params())
    argv = ["-d", "-i", scratch["out"], "-o", scratch["out2"], "--backend",
            backend]
    ref, got = both(argv, capsys)
    assert ref[0] == got[0] == 0
    with open(scratch["out2"], "rb") as f:
        assert f.read() == data


def _report(err: str) -> dict:
    return json.loads(
        [ln for ln in err.strip().splitlines() if ln.startswith("{")][-1]
    )


def test_report_has_the_same_keys(scratch, capsys, rng):
    data = make_text(rng, 3000)
    with open(scratch["in"], "wb") as f:
        f.write(data)
    enc = ["-c", "-i", scratch["in"], "-o", scratch["out"], "-s", "255",
           "--report", "--block-size", "512"]
    for extra in ([], ["--pipeline", "fused", "-l", "255"],
                  ["--manifest", str(scratch["dir"] / "m.json")]):
        ref, got = both(enc + extra, capsys, port_extra=CPU)
        assert ref[0] == got[0] == 0
        r, g = _report(ref[2]), _report(got[2])
        # the port counts transfers on the host pipeline too
        assert set(g) - {"h2d_bytes", "d2h_bytes"} == \
            set(r) - {"h2d_bytes", "d2h_bytes"}
        assert set(g["phases"]) == set(r["phases"])
        assert (r["backend"], g["backend"]) == ("jax", "device")
        assert (r["matcher"], g["matcher"]) == ("chunked", "sweep")
        for k in ("mode", "resumable", "pipeline", "input_bytes",
                  "output_bytes", "tokens", "blocks", "ratio",
                  "page_release"):
            assert g[k] == r[k], k
    for be, jbe in (("device", "device"), ("native", "native"),
                    ("host", "host"), ("native", "auto")):
        ref = run(jax_cli.main, ["-d", "-i", scratch["out"], "-o",
                                 scratch["out2"], "--report",
                                 "--decode-backend", jbe], capsys)
        got = run(cli.main, ["-d", "-i", scratch["out"], "-o",
                             scratch["out2"], "--report",
                             "--decode-backend", be] + CPU, capsys)
        r, g = _report(ref[2]), _report(got[2])
        assert set(g) == set(r)
        assert g["decode_backend"] == r["decode_backend"]
        assert g["output_bytes"] == r["output_bytes"] == len(data)
    # native and numpy backends: the same report, key for key
    for argv in (["-c", "-i", scratch["in"], "-o", scratch["out"],
                  "--backend", "native", "--report"],
                 ["-c", "-i", scratch["in"], "-o", scratch["out"],
                  "--backend", "numpy", "--report"],
                 ["-d", "-i", scratch["out"], "-o", scratch["out2"],
                  "--backend", "native", "--report"]):
        ref, got = both(argv, capsys)
        r, g = _report(ref[2]), _report(got[2])
        assert set(g) == set(r) and g["backend"] == r["backend"]


def test_default_decode_is_the_streamed_device_decode(scratch, capsys, rng):
    data = make_text(rng, 2000)
    with open(scratch["in"], "wb") as f:
        f.write(native.encode(data, spec.Params(9, 511)))
    rc, _, err = run(cli.main, ["-d", "-i", scratch["in"], "-o",
                                scratch["out"], "--report"] + CPU, capsys)
    assert rc == 0 and _report(err)["decode_backend"] == "device-walk-streamed"
    with open(scratch["out"], "rb") as f:
        assert f.read() == data


def test_corrupt_stream_messages_match(scratch, capsys):
    from lz77_tpu_torch import bitio
    import numpy as np

    bad = bitio.build_stream(
        np.array([0, 300], np.int64), np.array([0, 3], np.int64),
        np.array([65, 66], np.int64), spec.Params(),
    )
    for stream in (bad, b"\xff\x0f"):
        with open(scratch["in"], "wb") as f:
            f.write(stream)
        for be in ("device", "native"):
            argv = ["-d", "-i", scratch["in"], "-o", scratch["out"],
                    "--decode-backend", be]
            ref, got = both(argv, capsys, port_extra=CPU)
            assert got == ref
            assert ref[0] == 1 and ref[2].startswith("Error reading bits: ")


def test_manifest_and_pipeline_through_the_cli(scratch, capsys, rng):
    data = make_text(rng, 6000)
    with open(scratch["in"], "wb") as f:
        f.write(data)
    mp = str(scratch["dir"] / "m.json")
    for pipe, p in (("host", ["-l", "8", "-s", "500"]), ("fused", ["-s", "15"])):
        argv = ["-c", "-i", scratch["in"], "-o", scratch["out"], "--manifest",
                mp, "--resume", "--pipeline", pipe, "--block-size", "1024",
                "--batch-blocks", "2"] + p
        assert run(cli.main, argv + CPU, capsys)[0] == 0
        with open(scratch["out"], "rb") as f:
            la, sb = (8, 500) if pipe == "host" else (15, 15)
            assert f.read() == native.encode(data, spec.Params(la, sb))
        assert not os.path.exists(mp)


def test_edge_inputs_streamed_route(scratch, capsys):
    for data in (b"", b"Z"):
        with open(scratch["in"], "wb") as f:
            f.write(data)
        enc = ["-c", "-i", scratch["in"], "-o"]
        assert run(jax_cli.main, enc + [scratch["out2"]], capsys)[0] == 0
        assert run(cli.main, enc + [scratch["out"]] + CPU, capsys)[0] == 0
        with open(scratch["out"], "rb") as f, open(scratch["out2"], "rb") as g:
            assert f.read() == g.read()
        back = str(scratch["dir"] / "back")
        assert run(cli.main, ["-d", "-i", scratch["out"], "-o", back] + CPU,
                   capsys)[0] == 0
        with open(back, "rb") as f:
            assert f.read() == data
        # empty -> the 4-byte header alone; one byte -> one 24-bit token
        assert os.path.getsize(scratch["out"]) == 4 + 3 * len(data)


# ---- what the port's surface names differently ----------------------------

@pytest.mark.parametrize("name", ["sweep", "chunk", "pallas_bitplane",
                                  "pallas"])
def test_matcher_names_and_jax_aliases(scratch, capsys, name):
    from lz77_tpu_torch.ops import match

    assert cli.DEFAULT_MATCHER == match.DEFAULT_MATCHER
    rc, _, err = run(cli.main, ["-c", "-i", scratch["in"], "-o",
                                scratch["out"], "-s", "255", "--matcher",
                                name, "--report"] + CPU, capsys)
    assert rc == 0
    assert _report(err)["matcher"] in ("sweep", "chunk")
    with open(scratch["in"], "rb") as f, open(scratch["out"], "rb") as g:
        assert g.read() == native.encode(f.read(), spec.Params(15, 255))


@pytest.mark.parametrize("name", ["chunked", "brute", "sorted", "bitplane"])
def test_xla_matcher_names_exit_1(scratch, capsys, name):
    """The name dates from when the port refused the JAX package's XLA
    matchers; they run now, as plain tensor code: rc 0, the native stream,
    and the report names the matcher that ran."""
    rc, _, err = run(cli.main, ["-c", "-i", scratch["in"], "-o",
                                scratch["out"], "--matcher", name,
                                "--report"] + CPU, capsys)
    assert rc == 0
    assert _report(err)["matcher"] == name
    with open(scratch["in"], "rb") as f, open(scratch["out"], "rb") as g:
        assert g.read() == native.encode(f.read())
    rc, _, err = run(cli.main, ["-c", "-i", scratch["in"], "-o",
                                scratch["out"], "--matcher", "nope"] + CPU,
                     capsys)
    assert rc == 1
    assert err.startswith("Encode error: unknown matcher") and name in err


@pytest.mark.parametrize(
    "extra", [["--pipeline", "sharded"], ["--mesh", "4x2"],
              ["--host-devices", "8"],
              ["--pipeline", "sharded", "--mesh", "banana"]],
    ids=["sharded", "mesh", "host_devices", "bad_mesh"],
)
def test_multi_device_flags_are_parsed_and_answered_with_exit_1(
    scratch, capsys, extra
):
    """The multi-device flags since the sharded pipeline landed: the JAX
    CLI's exit code for each argv (only the bad ``--mesh`` exits 1, with the
    JAX text), and the serial stream from each that encodes; a 4x2 mesh of
    eight CPU members too.  The name dates from when the flags were
    refused."""
    argv = ["-c", "-i", scratch["in"], "-o", scratch["out"]] + extra
    ref = run(jax_cli.main, argv, capsys)
    ref_stream = None
    if os.path.exists(scratch["out"]):
        with open(scratch["out"], "rb") as f:
            ref_stream = f.read()
        os.unlink(scratch["out"])
    got = run(cli.main, argv + CPU, capsys)
    assert got[0] == ref[0] == (1 if "banana" in extra else 0)
    with open(scratch["in"], "rb") as f:
        want = native.encode(f.read(), spec.Params())
    if ref[0]:
        assert got[2] == ref[2] == (
            "Encode error: --mesh must look like '4x2', got 'banana'\n")
        assert not os.path.exists(scratch["out"])
        return
    with open(scratch["out"], "rb") as f:
        assert f.read() == ref_stream == want
    if extra == ["--pipeline", "sharded"]:
        rc, _, err = run(cli.main, argv + ["--host-devices", "8", "--mesh",
                                           "4x2", "--device", "cpu",
                                           "--block-size", "256",
                                           "--report"], capsys)
        rep = json.loads(err.strip().splitlines()[-1])
        with open(scratch["out"], "rb") as f:
            assert rc == 0 and f.read() == want
        assert rep["pipeline"] == "sharded" and rep["shards"] == 4
        assert rep["resyncs"] == rep["resync_head_tokens"] == 0
        assert rep["resync_bulk"] == 0 and rep["h2d_bytes"] > 0


def test_no_card_is_an_error_not_a_fallback(scratch, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for argv in (["-c", "-i", scratch["in"], "-o", scratch["out"]],
                 ["-c", "-i", scratch["in"], "-o", scratch["out"],
                  "--pipeline", "fused", "--device", "cuda"]):
        rc, _, err = run(cli.main, argv, capsys)
        assert rc == 1 and err.startswith("Encode error: ") and "CUDA" in err
    with open(scratch["out2"], "wb") as f:
        f.write(native.encode(b"abc" * 50))
    rc, _, err = run(cli.main, ["-d", "-i", scratch["out2"], "-o",
                                scratch["out"]], capsys)
    assert rc == 1 and err.startswith("Error reading bits: ") and "CUDA" in err


def test_fused_pipeline_rejects_unaligned_width_like_jax(scratch, capsys):
    argv = ["-c", "-i", scratch["in"], "-o", scratch["out"], "--pipeline",
            "fused", "-l", "8", "-s", "500"]
    ref, got = both(argv, capsys, port_extra=CPU)
    assert ref[0] == got[0] == 1
    assert got[2] == ref[2]


def test_decode_backend_is_ignored_with_a_warning_off_the_device_backend(
    scratch, capsys
):
    with open(scratch["out2"], "wb") as f:
        f.write(native.encode(b"warn me " * 30))
    rc, _, err = run(cli.main, ["-d", "-i", scratch["out2"], "-o",
                                scratch["out"], "--backend", "native",
                                "--decode-backend", "host"], capsys)
    assert rc == 0 and "only applies to --backend device" in err


def test_profile_flag_writes_a_trace(scratch, capsys):
    pdir = scratch["dir"] / "prof"
    rc, _, _ = run(cli.main, ["-c", "-i", scratch["in"], "-o", scratch["out"],
                              "-s", "63", "--profile", str(pdir)] + CPU,
                   capsys)
    assert rc == 0
    assert {"trace.json", "key_averages.txt", "key_averages.json"} <= \
        set(os.listdir(pdir))
    with open(pdir / "key_averages.json") as f:
        d = json.load(f)
    assert d["wall_us"] > 0 and d["rows"]


def test_module_entry_point(scratch):
    """``python -m lz77_tpu_torch.cli`` is the command line."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-m", "lz77_tpu_torch.cli", "-c", "-i",
         scratch["in"], "-o", scratch["out"], "-s", "63", "--device", "cpu",
         "--report"],
        capture_output=True, text=True, timeout=300, cwd=root,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert _report(res.stderr)["backend"] == "device"
    with open(scratch["in"], "rb") as f, open(scratch["out"], "rb") as g:
        assert native.decode(g.read()) == f.read()
