"""Corpus conformance runner (SURVEY.md §4d, §7 phase 2), on the port.

Per corpus file, asserts the full compatibility contract:

* bit-exact roundtrip through our encoder + decoder;
* the C reference binary decodes our stream bit-exactly;
* we decode the C reference binary's stream bit-exactly;
* our compressed size <= the reference encoder's (the §2.4 guarantee).

Usage::

    python -m lz77_tpu_torch.conformance [--scale N]
        [--backend native|device|fused] [--device cuda|cpu]
        [--markdown out.md] [--json out.json] [--big GIGABYTES]

``--big G`` additionally runs a G-gigabyte memmap-streamed encode_file with
a checkpoint manifest (bounded memory) and verifies the decode.

The port's copy of ``lz77_tpu.conformance``: the same rows with the same
keys.  Where it differs, it does so by decision:

* ``--backend device`` (``codec.encode_bytes`` on the device) takes the
  place of ``jax``; an unknown backend raises.  ``fused`` is
  ``fused.encode_bytes_fused``, the walk route.
* Our streams are decoded by ``codec.decode_bytes``'s ``device`` backend
  (the walk decode kernel), where the JAX runner decodes on the host.
* The C reference binary is built from the sources in the directory that
  ``$LZ77_REFERENCE_DIR`` names.  Without it the rows have no C columns:
  missing, not failed.
* :func:`run_conformance` and :func:`run_big_streamed` take every matcher
  name; the default is the port's ``sweep`` (K1), where the JAX runner's
  big run defaults to its XLA ``chunked``.  :func:`run_big_streamed`'s
  self-check
  decodes in a ``python -m lz77_tpu_torch.cli -d ... --report --device D``
  subprocess.  ``--big-pipeline sharded`` runs ``encode_file``'s sharded
  pipeline on a one-member mesh on ``--device`` when it is given, else on
  every visible card.

Every function takes ``device=`` and passes it on; the default is the card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from . import corpus as corpus_lib
from . import device as device_lib
from . import spec
from .ops.match import DEFAULT_MATCHER

REFERENCE_ENV = "LZ77_REFERENCE_DIR"
BACKENDS = ("native", "device", "fused")


def build_oracle(workdir: str) -> str | None:
    """Compile the C reference binary (adding the missing -lm) from the
    sources in ``$LZ77_REFERENCE_DIR``; None without them or on failure."""
    ref = os.environ.get(REFERENCE_ENV)
    if not ref or not os.path.isdir(ref):
        return None
    binary = os.path.join(workdir, "lz77_ref")
    srcs = [os.path.join(ref, f)
            for f in ("main.c", "lz77.c", "tree.c", "bitio.c")]
    res = subprocess.run(
        ["gcc", "-O2", "-o", binary, *srcs, "-lm", "-I", ref],
        capture_output=True,
    )
    return binary if res.returncode == 0 else None


def _ref_run(binary: str, mode: str, src: str, dst: str) -> None:
    subprocess.run([binary, mode, "-i", src, "-o", dst],
                   check=True, capture_output=True)


def _our_encode(data: bytes, backend: str, device, matcher: str) -> bytes:
    params = spec.Params()
    if backend == "native":
        from . import native

        return native.encode(data, params)
    if backend == "fused":
        from .models import fused

        return fused.encode_bytes_fused(data, params, matcher=matcher,
                                        device=device)
    from .models import codec

    return codec.encode_bytes(data, params, matcher=matcher, device=device)


def _our_decode(stream: bytes, device) -> bytes:
    from .models import codec

    return codec.decode_bytes(stream, device=device)


def run_conformance(
    scale: int = 1, backend: str = "native", workdir: str | None = None,
    *, device: str | torch.device | None = None,
    streams: dict | None = None,
    matcher: str | None = None,
) -> list[dict]:
    """Run the per-file conformance matrix; returns one record per file.

    ``streams``, if given, receives each file's stream under its name.
    ``matcher`` (default ``sweep``) is the device encoders' match finder,
    any name of ``ops.match.get_matcher``; the native encoder has none and
    raises if one is given."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; available: "
                         f"{', '.join(BACKENDS)}")
    if matcher is not None and backend == "native":
        raise ValueError("backend 'native' takes no matcher")
    from .ops import match as match_ops

    matcher = match_ops.route_matcher(matcher or DEFAULT_MATCHER)
    device = device_lib.resolve(device)
    own_tmp = None
    if workdir is None:
        own_tmp = tempfile.TemporaryDirectory()
        workdir = own_tmp.name
    oracle = build_oracle(workdir)
    files = corpus_lib.get_corpus(scale=scale)
    rows = []
    for name, data in sorted(files.items()):
        t0 = time.perf_counter()
        ours = _our_encode(data, backend, device, matcher)
        enc_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = _our_decode(ours, device)
        dec_s = time.perf_counter() - t0
        if streams is not None:
            streams[name] = ours
        row = {
            "file": name,
            "bytes": len(data),
            "ours_bytes": len(ours),
            "ours_ratio": round(len(ours) / max(1, len(data)), 4),
            "roundtrip": out == data,
            "encode_mb_s": round(len(data) / max(enc_s, 1e-9) / 1e6, 2),
            "decode_mb_s": round(len(data) / max(dec_s, 1e-9) / 1e6, 2),
        }
        if oracle is not None:
            ip = os.path.join(workdir, "cin")
            op = os.path.join(workdir, "cout")
            with open(ip, "wb") as f:
                f.write(data)
            _ref_run(oracle, "-c", ip, op)
            with open(op, "rb") as f:
                ref_stream = f.read()
            row["ref_bytes"] = len(ref_stream)
            row["size_le_ref"] = len(ours) <= len(ref_stream)
            # C decodes ours
            with open(ip, "wb") as f:
                f.write(ours)
            _ref_run(oracle, "-d", ip, op)
            with open(op, "rb") as f:
                row["c_decodes_ours"] = f.read() == data
            # we decode C's
            row["we_decode_c"] = _our_decode(ref_stream, device) == data
        rows.append(row)
    if own_tmp is not None:
        own_tmp.cleanup()
    return rows


def chunk_equal(a_path: str, b_path: str, n: int) -> bool:
    """Whether ``b_path`` holds the first ``n`` bytes of ``a_path`` and
    nothing else, compared 64 MiB at a time."""
    if os.path.getsize(b_path) != n:
        return False
    a = np.memmap(a_path, dtype=np.uint8, mode="r")
    b = np.memmap(b_path, dtype=np.uint8, mode="r")
    step = 64 << 20
    for s0 in range(0, n, step):
        if not np.array_equal(a[s0 : s0 + step], b[s0 : s0 + step]):
            return False
    return True


def run_big_streamed(gigabytes: float, workdir: str,
                     matcher: str = DEFAULT_MATCHER,
                     block_size: int | None = None,
                     batch_blocks: int | None = None,
                     pipeline: str = "host",
                     device: str | torch.device | None = None) -> dict:
    """Memmap-streamed encode_file of a multi-GB input with a manifest.

    The input is written to disk once (deterministic mixed corpus tiles)
    and encoded through the bounded-memory manifest path — ``pipeline``
    selects the engine ('host' = device match + host parse; 'fused' = the
    device-resident match+parse+pack pipeline; 'sharded' = the same over a
    mesh: one member on ``device`` when it is given, else every visible
    card).  Verification is two-fold:

    * **self**: the port's own streamed bounded-memory decoder (its CLI's
      ``-d`` in a subprocess, on ``device`` — O(window) RSS, recorded),
      chunk-compared against the source.
    * **oracle**: the C reference binary decodes the same stream
      file-to-file, cross-checking the format contract.
    """
    import resource

    from .models import codec

    dev = device_lib.resolve(device)
    n = int(gigabytes * (1 << 30))
    src = os.path.join(workdir, "big.bin")
    corpus_lib.write_big_file(src, n)
    dst = src + ".lz"
    params = spec.Params()
    stats = codec.EncodeStats()
    kwargs = {}
    if block_size:
        kwargs["block_size"] = block_size
    if batch_blocks:
        kwargs["batch_blocks"] = batch_blocks

    t0 = time.perf_counter()
    codec.encode_file(
        src, dst, params, matcher=matcher, stats=stats,
        manifest_path=dst + ".manifest", pipeline=pipeline, device=device,
        **kwargs,
    )
    enc_s = time.perf_counter() - t0
    # Peak RSS up to this point proves the bounded-memory claim for the
    # encode path itself.
    enc_rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024

    # Self-verification: our streamed decoder, file-to-file in a CLI
    # subprocess.  The decode's bounded-memory claim is pinned by the
    # subprocess's OWN --report peak_rss_mb (RUSAGE_SELF at exit):
    # getrusage(RUSAGE_CHILDREN) on the parent would count the encode's
    # resident set, inherited before exec, and earlier children.
    dec_path = os.path.join(workdir, "big.dec")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "lz77_tpu_torch.cli", "-d", "-i", dst,
         "-o", dec_path, "--report", "--device", dev.type],
        capture_output=True, cwd=os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))),
    )
    self_dec_s = time.perf_counter() - t0
    self_rss_mb = None
    try:
        rep = json.loads(res.stderr.decode().strip().splitlines()[-1])
        self_rss_mb = float(rep["peak_rss_mb"])
    except (IndexError, KeyError, TypeError, ValueError):
        pass
    ok_self = res.returncode == 0 and chunk_equal(src, dec_path, n)
    if os.path.exists(dec_path):
        os.unlink(dec_path)

    # Oracle cross-check: the C reference binary decodes the same stream.
    oracle = build_oracle(workdir)
    ok_oracle = None
    oracle_dec_s = None
    if oracle is not None:
        t0 = time.perf_counter()
        _ref_run(oracle, "-d", dst, dec_path)
        oracle_dec_s = time.perf_counter() - t0
        ok_oracle = chunk_equal(src, dec_path, n)
        os.unlink(dec_path)

    return {
        "input_bytes": n,
        "output_bytes": stats.output_bytes,
        "ratio": round(stats.output_bytes / n, 4),
        "pipeline": pipeline,
        "encode_mb_s": round(n / enc_s / 1e6, 2),
        "encode_peak_rss_mb": round(enc_rss_mb, 1),
        "page_release": stats.page_release,
        "h2d_bytes_per_input_byte": round(stats.h2d_bytes / n, 3)
        if stats.h2d_bytes else None,
        "d2h_bytes_per_input_byte": round(stats.d2h_bytes / n, 3)
        if stats.d2h_bytes else None,
        "self_decode_mb_s": round(n / self_dec_s / 1e6, 2),
        "self_decode_peak_rss_mb": (
            round(self_rss_mb, 1) if self_rss_mb is not None else None
        ),
        "oracle_decode_mb_s": (
            round(n / oracle_dec_s / 1e6, 2) if oracle_dec_s else None
        ),
        "verified": ok_self and (ok_oracle is not False),
        "verifier": "self-streamed+c-reference" if ok_oracle is not None
        else "self-streamed",
        "self_verified": ok_self,
        "oracle_verified": ok_oracle,
        "phases": stats.phases.as_dict(),
    }


def to_markdown(rows: list[dict]) -> str:
    cols = ["file", "bytes", "ours_bytes", "ref_bytes", "ours_ratio",
            "size_le_ref", "roundtrip", "c_decodes_ours", "we_decode_c",
            "encode_mb_s", "decode_mb_s"]
    head = "| " + " | ".join(cols) + " |\n"
    head += "|" + "|".join("---" for _ in cols) + "|\n"
    body = ""
    for r in rows:
        body += "| " + " | ".join(str(r.get(c, "-")) for c in cols) + " |\n"
    return head + body


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="lz77_tpu_torch.conformance")
    ap.add_argument("--scale", type=int, default=1)
    ap.add_argument("--backend", default="native", choices=BACKENDS)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: the CUDA card (raises without one)")
    ap.add_argument("--markdown", default=None)
    ap.add_argument("--json", dest="json_out", default=None)
    ap.add_argument("--big", type=float, default=0.0,
                    help="additionally run an N-GB streamed encode_file")
    ap.add_argument("--big-matcher", default=DEFAULT_MATCHER)
    ap.add_argument("--big-block-size", type=int, default=None)
    ap.add_argument("--big-batch-blocks", type=int, default=None)
    ap.add_argument("--big-pipeline", default="host",
                    choices=("host", "fused", "sharded"))
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory() as wd:
        rows = run_conformance(args.scale, args.backend, wd,
                               device=args.device)
        result = {"files": rows}
        if args.big > 0:
            result["big_streamed"] = run_big_streamed(
                args.big, wd, matcher=args.big_matcher,
                block_size=args.big_block_size,
                batch_blocks=args.big_batch_blocks,
                pipeline=args.big_pipeline, device=args.device,
            )
    ok = all(
        r["roundtrip"] and r.get("size_le_ref", True)
        and r.get("c_decodes_ours", True) and r.get("we_decode_c", True)
        for r in rows
    )
    if args.big > 0:
        ok = ok and result["big_streamed"]["verified"]
    if args.markdown:
        with open(args.markdown, "w") as f:
            f.write("# Corpus conformance (backend=%s, scale=%d)\n\n"
                    % (args.backend, args.scale))
            f.write(to_markdown(rows))
            if args.big > 0:
                f.write("\n## Streamed multi-GB encode\n\n```json\n")
                f.write(json.dumps(result["big_streamed"], indent=2))
                f.write("\n```\n")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(result, f, indent=2)
    print(json.dumps({"conformance_ok": ok, "files": len(rows)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
