"""Multi-process encode at file scale.

The port of the JAX repository's ``experiments/multihost_bigrun.py``: runs
``parallel.distributed.encode_file_multihost`` over N local processes (a
Gloo group; each rank on ``cuda:{rank % device_count}``, or on the CPU with
``--device cpu``) on a >= 1 GB corpus file, and prints one JSON line a
phase:

* ``corpus``: the input, the conformance corpus's files at scale 4 in
  order and round again (``corpus.write_big_file``), kept when one of the
  right size is already in the work directory;
* ``multihost-{N}proc``: the launcher's wall and MB/s (process start-up
  included, as the JAX driver measures), the slowest rank's encode wall
  and MB/s, every rank's report (``wall``, ``peak_rss_mb``, its K1 and K4
  ``launches``, bytes moved each way), and against the one-process run of
  the same engine ``scaling_efficiency_vs_1proc`` (launcher walls, the JAX
  driver's key) and ``encode_scaling_efficiency_vs_1proc`` (rank walls);
* ``identity-{N}proc``: the stream equals the first rank count's;
* ``self-decode``: ``native.decode_file`` of the stream equals the input;
* ``oracle-decode``: the C reference binary, built from the sources in
  ``$LZ77_REFERENCE_DIR``, decodes it to the input (``ok`` null, and why,
  without them).

Ranks that share one card share its SMs: their MB/s measure contention on
it, not scaling across cards.  The matcher is ``sweep`` (K1); la=15, sb=15
(16-bit tokens, the fused route), blocks of 256 KiB in batches of 8, as
the JAX driver.
Any failed check exits non-zero.

Usage::

    python -m lz77_tpu_torch.experiments.multihost_bigrun GB NPROCS...
        [WORKDIR] [--device cuda|cpu]

e.g. ``python -m lz77_tpu_torch.experiments.multihost_bigrun 1 1 2``.
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
from ..parallel import distributed
from ..utils import metrics

BLOCK_SIZE, BATCH_BLOCKS = 1 << 18, 8
LA, SB = 15, 15
TIMEOUT_S = 7200  # a rank count that takes longer fails the run


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lz77_tpu_torch.experiments.multihost_bigrun",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("gb", type=float, help="input size in GiB")
    ap.add_argument("rest", nargs="+", metavar="NPROCS... [WORKDIR]")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    nprocs = [int(t) for t in a.rest if t.isdigit()]
    work = (a.rest[-1] if not a.rest[-1].isdigit() else
            os.path.join(tempfile.gettempdir(), "lz77_tpu_torch_mh_bigrun"))
    if not nprocs:
        ap.error("give at least one process count")
    os.makedirs(work, exist_ok=True)

    n = int(a.gb * (1 << 30))
    src = os.path.join(work, "big.bin")
    t0 = time.perf_counter()
    if not (os.path.exists(src) and os.path.getsize(src) == n):
        corpus_lib.write_big_file(src, n)
    emit({"phase": "corpus", "bytes": n,
          "seconds": time.perf_counter() - t0})

    distributed.prebuild(a.device)
    ref_stream = None
    walls: dict[int, tuple[float, float]] = {}
    for np_ in nprocs:
        out = os.path.join(work, f"out_{np_}.lz")
        t0 = time.perf_counter()
        reports = distributed.launch(
            ["-i", src, "-o", out, "-l", str(LA), "-s", str(SB),
             "--block-size", str(BLOCK_SIZE),
             "--batch-blocks", str(BATCH_BLOCKS), "--matcher", "sweep",
             "--mode", "file", "--device", a.device],
            np_, timeout=TIMEOUT_S,
        )
        wall = time.perf_counter() - t0
        slowest = max(r["wall"] for r in reports)
        walls[np_] = (wall, slowest)
        row = {
            "phase": f"multihost-{np_}proc", "device": a.device,
            "wall_seconds": wall, "mb_s": n / wall / 1e6,
            "encode_seconds": slowest, "encode_mb_s": n / slowest / 1e6,
            "per_host": reports, "stream_bytes": os.path.getsize(out),
        }
        if 1 in walls and np_ > 1:
            w1, s1 = walls[1]
            row["scaling_efficiency_vs_1proc"] = metrics.scaling_efficiency(
                n / wall, n / w1, np_)
            row["encode_scaling_efficiency_vs_1proc"] = (
                metrics.scaling_efficiency(n / slowest, n / s1, np_))
        emit(row)
        if ref_stream is None:
            ref_stream = out
        else:
            same = conformance.chunk_equal(ref_stream, out,
                                           os.path.getsize(ref_stream))
            emit({"phase": f"identity-{np_}proc", "ok": same})
            if not same:
                raise SystemExit(f"{np_}-process stream != {nprocs[0]}-process "
                                 "stream")

    # verify with the streamed native decoder and the C oracle
    dec = os.path.join(work, "big.dec")
    t0 = time.perf_counter()
    native.decode_file(ref_stream, dec)
    dec_s = time.perf_counter() - t0
    ok = conformance.chunk_equal(src, dec, n)
    emit({"phase": "self-decode", "ok": ok, "seconds": dec_s})
    os.unlink(dec)
    if not ok:
        raise SystemExit("native.decode_file(stream) != input")
    oracle = conformance.build_oracle(work)
    if oracle is None:
        emit({"phase": "oracle-decode", "ok": None,
              "reason": f"${conformance.REFERENCE_ENV} names no C sources"})
        return 0
    subprocess.run([oracle, "-d", "-i", ref_stream, "-o", dec], check=True)
    ok = conformance.chunk_equal(src, dec, n)
    os.unlink(dec)
    emit({"phase": "oracle-decode", "ok": ok})
    if not ok:
        raise SystemExit("the C reference's decode != input")
    return 0


if __name__ == "__main__":
    sys.exit(main())
