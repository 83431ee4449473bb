"""Multi-GB big run at flat RSS, each process measuring its own peak.

The port of the JAX repository's ``experiments/bigrun_r5.py``.  Phases,
one JSON line each:

* ``corpus``: an N-GiB file of the conformance corpus's files at scale 4,
  in order and round again (``corpus.write_big_file``);
* ``native-encode``: the standalone C++ CLI (``native.build_cli``) encodes
  file to file through its streamed O(window) encoder; its ``-r`` report
  gives its own peak RSS;
* ``native-decode`` (+ ``-verify``): the same CLI decodes its stream;
* ``cli-decode`` (+ ``-verify``): the port's CLI, ``python -m
  lz77_tpu_torch.cli -d ... --report --decode-backend native`` (the
  native streamed route, the phase the JAX driver measures): interpreter
  baseline + O(window), self-reported;
* ``cli-decode-device`` (+ ``-verify``): the port's CLI with its default
  backend, the streamed walk decode (K3) on ``--device``, stage by stage at
  bounded host memory;
* ``oracle-decode``: the C reference binary, built from the sources in
  ``$LZ77_REFERENCE_DIR``, decodes the same stream (``ok`` null, and why,
  without them);
* ``done``: the stream's size.

Any failed check exits non-zero.

Usage::

    python -m lz77_tpu_torch.experiments.bigrun_r5 GB [WORKDIR]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

from .. import conformance, native
from .. import corpus as corpus_lib

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lz77_tpu_torch.experiments.bigrun_r5",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("gb", type=float, nargs="?", default=4.0,
                    help="input size in GiB (default 4)")
    ap.add_argument("workdir", nargs="?", default=os.path.join(
        tempfile.gettempdir(), "lz77_tpu_torch_bigrun_r5"))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the cli-decode-device phase runs")
    a = ap.parse_args(argv)
    work = a.workdir
    os.makedirs(work, exist_ok=True)
    n = int(a.gb * (1 << 30))
    src = os.path.join(work, "big.bin")

    t0 = time.perf_counter()
    if not (os.path.exists(src) and os.path.getsize(src) == n):
        corpus_lib.write_big_file(src, n)
    emit({"phase": "corpus", "bytes": n, "seconds": time.perf_counter() - t0})

    cli = native.build_cli()
    enc = os.path.join(work, "big.lz")
    dec = os.path.join(work, "big.dec")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)

    def run_reported(args, tag):
        t0 = time.perf_counter()
        r = subprocess.run(args, capture_output=True, text=True, env=env)
        dt = time.perf_counter() - t0
        if r.returncode != 0:
            raise SystemExit(f"{tag} exited {r.returncode}: {r.stderr[-2000:]}")
        rep = json.loads(r.stderr.strip().splitlines()[-1])
        rep["phase"] = tag
        rep["wall_seconds"] = dt
        emit(rep)
        return rep

    def verify(tag):
        ok = conformance.chunk_equal(src, dec, n)
        emit({"phase": f"{tag}-verify", "ok": ok})
        os.unlink(dec)
        if not ok:
            raise SystemExit(f"{tag}: the decoded file != input")

    run_reported([cli, "-c", "-i", src, "-o", enc, "-r"], "native-encode")
    run_reported([cli, "-d", "-i", enc, "-o", dec, "-r"], "native-decode")
    verify("native-decode")
    cli_d = [sys.executable, "-m", "lz77_tpu_torch.cli", "-d", "-i", enc,
             "-o", dec, "--report"]
    run_reported(cli_d + ["--decode-backend", "native"], "cli-decode")
    verify("cli-decode")
    run_reported(cli_d + ["--device", a.device], "cli-decode-device")
    verify("cli-decode-device")

    oracle = conformance.build_oracle(work)
    if oracle is None:
        emit({"phase": "oracle-decode", "ok": None,
              "reason": f"${conformance.REFERENCE_ENV} names no C sources"})
    else:
        t0 = time.perf_counter()
        subprocess.run([oracle, "-d", "-i", enc, "-o", dec], check=True)
        dt = time.perf_counter() - t0
        ok = conformance.chunk_equal(src, dec, n)
        os.unlink(dec)
        emit({"phase": "oracle-decode", "ok": ok, "seconds": dt,
              "mb_s_of_input": n / dt / 1e6})
        if not ok:
            raise SystemExit("the C reference's decode != input")
    emit({"phase": "done", "stream_bytes": os.path.getsize(enc)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
