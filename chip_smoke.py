#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py [--seed 0] [--text-mib 32] [--profile]
                          [--profile-dir build/profile]

It builds the CUDA kernels from ``lz77_tpu_torch/csrc`` (first use), holds
every kernel against its plain PyTorch version on the card with tolerance 0
(all outputs are integers and bytes) at small shapes and at the main path's
shape, times both, and then drives ten paths, each once, with the kernels'
launch counts set to 0 just before and read just after:

* the library path: ``compress`` and ``decompress`` of word-salad text plus
  4 MiB of zeros and 4 MiB of random bytes at the reference defaults,
  checked byte for byte against the native host codec;
* the CLI path, file to file through ``lz77_tpu_torch.cli.main``: encode
  with the host-parse pipeline and the chunk matcher under a manifest, the
  same encode killed after two batches and finished with ``--resume``, the
  streamed device decode, an unaligned token width (``-l 8 -s 500``) on
  8 MiB, the fused pipeline on files, and the packed-word decode through
  its public function; every stream equal to the native encoder's and every
  decoded file equal to its input;
* the merged path: ``encode_bytes_fused(parser="merged")`` of the same
  input, one launch of the merged sweep+walk kernel a batch and none of the
  match sweep or the walk parse; the stream equal to the native encoder's
  and to the walk route's, and decoded back;
* the co-issue probe: ``experiments.coissue.probe()`` at the experiment's
  own sizes, its four kernels (X-V, X-S, X-F, X-Q: one thread block on one
  SM each), its JSON line printed with the experiment's verdict;
* the conformance runner: ``run_conformance(scale=4)`` over the corpus's
  eight classes and a real source file (about 37 MiB), once with the
  ``device`` backend and once with the walk route (``fused``), every file
  round-tripped and its stream equal to the native encoder's; then the
  stream inspector (``dump``) on one stream, its token count against the
  parsed stream's;
* the sharded path: ``encode_bytes_sharded`` of the same input on 1x1, 8x1
  and 4x2 meshes whose members all sit on the one card (K1 launched once a
  block and window member, K2 once a block, K4 and K5 never), each stream
  equal to the native encoder's and decoded back; ``encode_file(pipeline=
  "sharded")`` on 4x2 killed after two batches and resumed; the CLI's
  ``--pipeline sharded`` (default mesh, ``--device cuda --host-devices 8
  --mesh 4x2``, ``-l 8 -s 500`` on 8 MiB); the host pipeline with the 4x2
  mesh's ``sharded_match_fn`` on 8 MiB;
* the exact entry-carried sharded step (``make_sharded_exact_step``):
  first its five outputs against the same step on a CPU mesh (the plain
  versions) on two 256 KiB blocks from entries 0, 7 and la + 3; then, counts
  zeroed, the same input in 1 MiB blocks and batches of 8 on 1x1, 8x1 and
  4x2 meshes on the card, chained batch to batch through the exit tensor,
  each batch's padded rows packed into a stream equal to the native
  encoder's (the 1x1 one decoded by ``decompress``), and on 8 MiB of text
  ``Params(255, 65535)`` and ``Params(8, 500)`` on 4x2 and the chunk
  matcher on 8x1 (K1 once a member of a shard a batch, K2 once a shard, K4
  only for ``chunk``, K3 only for the decode, K5 and K6 never).  Its
  ``exact_step`` line gives each mesh's median ms a batch of the step and
  of its unpack into padded rows, MB/s with the host pack beside
  ``encode_bytes_sharded``'s, the peak device memory and ``phase_s``;
* the multi-process path (``parallel.distributed``): local ranks of
  ``python -m lz77_tpu_torch.parallel.distributed`` on a Gloo group at
  localhost, every rank on cuda:0 (NCCL refuses two ranks on one card):
  ``encode_bytes_multihost`` of the same input on 1 (the distributed code
  in a world of one), 2 and 4 ranks (the fused route: K1 and the scan
  parser), each rank's K1 launches one a batch of its range;
  ``encode_file_multihost`` on 4 ranks at the defaults and at la 15, sb
  300 on 8 MiB (21-bit tokens: the host route and the partial-byte merge)
  with the sweep (K1) and the chunk matcher (K4); a fault on batch 0
  retried; runs of zeros across every rank boundary (each later rank
  re-runs its range); every stream equal to ``native.encode``'s, the first
  decoded by ``decompress`` (K3); then both big-run drivers
  (``experiments.multihost_bigrun`` on 1 and 2 ranks and
  ``experiments.bigrun_r5``) at 0.125 GiB.  Its line carries each
  run's rank reports, MB/s by rank count (input bytes over the slowest
  rank's wall) and the scaling efficiency against one rank: ranks that
  share one card measure contention on it, not scaling across cards;
* the edge phase (``drive_edge_path``, which runs alone too): the
  reference's range, la 2..255 against sb 1..65535, at the points of
  ``lz77_tpu_torch.edges.GRID`` (sb 1, 2 and 3, where offsets take 0, 1
  and 2 bits; power-of-two sb; la 2 and 255) on 82,520 bytes of text,
  zeros, random bytes and a run across a block boundary.  Every codec
  kernel (K1 full and over a 2-member window split, K2, K3 whole and
  primed, K4, K5, K6) is first held against its plain version at every
  point; then, counts zeroed, every encode route (fused walk / merged /
  scan where the width is byte-aligned, else their ValueError; the host
  pipeline with both matchers; a 2x2 mesh on the card) gives
  ``native.encode``'s stream and every decode route (``decompress``, the
  chunked, host and native backends, the packed decode, the streamed
  decode at stages of 64 and 4,096 tokens) the input, with one 2-rank
  ``distributed.launch`` at (255, 1) and the CLI's default decode of a
  ``--force-sb -s 1`` stream; last the corrupt-stream corpus
  (``edges.corrupt_streams``: cut, flipped and padded streams) through
  every decode backend and the streamed decode, on cuda and on the CPU,
  with the same bytes or the same error text, and one small K3 launch
  after it to show the context survived.  Its ``edges`` line gives the
  grid, the checks by kernel and by route, the corpus and the seconds;
* the XLA matchers' phase (``drive_xla_matcher_path``, which runs alone
  too): the JAX package's ``brute``, ``sorted``, ``chunked`` and
  ``bitplane``, plain tensor code on the card, each held against K1 with
  (L, O) error 0 on 1 MiB blocks of text, zeros and random bytes at the
  defaults, ``sorted``, ``chunked`` and ``bitplane`` at la 255, sb 65535,
  every matcher at every point of ``edges.GRID``, ``brute_range`` and
  ``bitplane_range`` split 2 and 4 ways and combined; then, counts zeroed,
  the CLI's host pipeline with each name on 8 MiB (decoded by K3), the
  fused walk with ``sorted`` (K2 on its tables), a 2x2 mesh on the card
  with ``bitplane`` and ``brute`` on the window axis, two ranks with
  ``chunked``, K1, K4 and K5 launched by none.  Its ``xla_matchers`` line
  gives each matcher's median time at each shape with K1's beside it, its
  peak device memory, its device kernels a call, the grid and route
  checks, the matchers' calls on the routes, and the card.

K1 over a range of distances (the window axis) is held against its plain
version on splits of 2, 3 and 4 members at la 2 / 15 / 255 x sb 15 / 4095
/ 65535, on ranges starting and ending at every residue mod 4, on zeros,
random bytes and far offsets, and the members' combined tables against
unranged K1; at the main path's shapes too: every member of splits of 2
and 4 on the 8 MiB text batch, and the one-block shards of the 4x2 mesh.
K1's record carries each member's time at the main shape (``ranged_ms``).

The plain tensor modules (the scan parser, the chunked decoder) run on the
card on the first 8 MiB and are held against the same references.

The probe's kernels are held against their plain versions: V, F (k 8)
and Q from a random slab and from one-hot slabs (a word at the corners and
at the ends of a thread's four lanes, in each slab) after 1, 2, 7 and 33
bodies, S across the scalar table's wrap (ns 8, 4096 and 10,000), F at k
24; each timed output (V at nv 1,000, S at ns 10,000, F and Q at nv 100
with 88 scalar steps an iteration, and again with the probe's k) is held
too, then timed beside its plain version and its bound (V: issue at one
SM, two instructions an element; S: the latency of its chain, one
shared-memory load-to-use a step; F: the larger, Q: the sum).
``bound_by`` takes the words "bytes" and "operations" only, so each X
entry of the ``kernels`` line also says in ``bound_note`` what its bound
counts. The ``probe_kernels`` records of V, F and Q carry ptxas' report
(registers, spill bytes, stack, static shared memory) and their SASS
opcode counts (``cuobjdump -sass``); V's adds ``shfl_ms``, the limit its
shuffles would set.

The walk decode is also held against its plain version's tiled
decomposition on the small cases, and run as the streamed decode runs it:
3.5 MiB in stages primed with the d_limit bytes before each, at la=15 with
sb=4095 and sb=65535, stage by stage against the plain version, with a
corrupt stage that the kernel and the plain version both reject and on which
``decode_file_device`` raises.  It is timed on the whole stream, on 8 MiB of
zeros, of random bytes and of text at sb=65535, at tiles of 2048 to 14336
words (``ms_by_tile_words``), with its scratch and its kernel launches a
call (``kernels_per_call``, from ``torch.profiler``).  The walk parse+pack
is held and timed at la 2, 15 and 255 with sub-blocks of one byte, the
default and 65,535, and its sub-blocks' entries and offsets (the exact
step's) held at the main shape.

The packed-word decode is also held against the walk decode's bytes and the
input on streams several of its tiles long (tokens across tile boundaries,
sources more than a tile back, every length residue mod 4, outputs cut
short) and timed on 8 MiB of zeros and of random bytes.  The two matchers
(the sweep and the chunk matcher) are held against each other's tables on
every case, the sweep also on its word grid: block lengths and starts at
every residue mod 4, the stream start (dmax in mid-word), valid_ext inside
the last block, la 2..255 against sb 3..65535 (sb 1 and 2 in the edge
phase), zeros, an off == 1 run and random bytes; both are timed on a zeros batch, a random batch and one 1 MiB
block at la=255, sb=65535.  The merged sweep+walk kernel is also held on
blocks of 4095, 4096 and 4097 bytes and blocks shorter than la, and run and
timed on the text batch and a zeros batch at tiles of 512 to 8192
positions (``ms_by_tile``).

Each phase prints one JSON line; any failed check raises and the exit code
is non-zero.  Without a CUDA device it exits non-zero at once: nothing here
runs on the CPU instead.

The default 32 MiB of text (40 MiB in all, five 8 MiB batches) is sized so
the whole script, builds included, ends well inside twenty minutes.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import lz77_tpu_torch as lt
from lz77_tpu_torch import (_build, bitio, cli, conformance, corpus, dump,
                            edges, native, spec)
from lz77_tpu_torch.experiments import coissue
from lz77_tpu_torch.models import codec, fused
from lz77_tpu_torch.ops import (decode_walk, fused_walk, match, match_chunk,
                                parse_walk)
from lz77_tpu_torch.parallel import distributed, sharded
from lz77_tpu_torch.parallel import mesh as mesh_lib
from lz77_tpu_torch.utils import faults, metrics, profiling

HBM_BYTES_PER_S = 3.35e12
# Byte compares are integer ALU work outside the tensor cores.  Assumed peak:
# the data sheet's 67 TFLOP/s fp32 counts an FMA as two, on 128 lanes per
# SM; half of those lanes issue INT32, so 67e12 / 2 / 2 compares a second.
INT_OPS_PER_S = 67e12 / 4
# The co-issue probe's kernels run as one thread block on one of the 132 SMs,
# at the H100 SXM's 1.98 GHz boost clock.  An SM's four warp schedulers
# each issue one 32-lane instruction a clock.
CLOCK_HZ = 1.98e9
SM_ISSUE_LANES_PER_S = 4 * 32 * CLOCK_HZ
# Its scalar chain is bound by latency: each step's load address is the
# previous load's value.  Assumed: one shared-memory load-to-use of 30
# cycles a step.
SMEM_LOAD_TO_USE_S = 30 / CLOCK_HZ
# One SM's shuffle unit serves one warp-wide __shfl_sync (32 lanes) a clock.
SHFL_LANES_PER_S = 32 * CLOCK_HZ
# F and Q are timed at nv 100 with a fixed 88 scalar steps an iteration
# (Q: ns 8,800), so that their times compare from run to run whatever k
# the probe picks; and at the probe's own k beside it.
PROBE_TIMED_K = 88

WRAPPERS = {
    "match_kernel": match.match_sweep,
    "walk_parse_pack_kernel": parse_walk.walk_parse_pack,
    "walk_decode_kernel": decode_walk.walk_decode,
    "match_chunk_kernel": match_chunk.match_chunk,
    "decode_packed_kernel": decode_walk.walk_decode_packed,
    "sweepwalk_kernel": fused_walk.sweep_walk,
    "coissue_v_kernel": coissue.call_v,
    "coissue_s_kernel": coissue.call_s,
    "coissue_f_kernel": coissue.call_f,
    "coissue_q_kernel": coissue.call_q,
}
KERNEL_INFO = {
    "match_kernel": ("lz77_tpu_torch/csrc/match.cu",
                     "lz77_tpu/ops/pallas_bitplane.py:337"),
    "walk_parse_pack_kernel": ("lz77_tpu_torch/csrc/parse_walk.cu",
                               "lz77_tpu/ops/parse_walk.py:47"),
    "walk_decode_kernel": ("lz77_tpu_torch/csrc/decode_walk.cu",
                           "lz77_tpu/ops/decode_walk.py:62"),
    "match_chunk_kernel": ("lz77_tpu_torch/csrc/match_chunk.cu",
                           "lz77_tpu/ops/pallas_match.py:53"),
    "decode_packed_kernel": ("lz77_tpu_torch/csrc/decode_walk_packed.cu",
                             "lz77_tpu/ops/decode_walk.py:316"),
    "sweepwalk_kernel": ("lz77_tpu_torch/csrc/fused_walk.cu",
                         "lz77_tpu/ops/fused_walk.py:62"),
    "coissue_v_kernel": ("lz77_tpu_torch/csrc/coissue.cu",
                         "experiments/coissue.py:71"),
    "coissue_s_kernel": ("lz77_tpu_torch/csrc/coissue.cu",
                         "experiments/coissue.py:80"),
    "coissue_f_kernel": ("lz77_tpu_torch/csrc/coissue.cu",
                         "experiments/coissue.py:95"),
    "coissue_q_kernel": ("lz77_tpu_torch/csrc/coissue.cu",
                         "experiments/coissue.py:112"),
}
# the kernels each driven path must launch at least once
LIBRARY_PATH_KERNELS = ("match_kernel", "walk_parse_pack_kernel",
                        "walk_decode_kernel")
CLI_PATH_KERNELS = ("match_kernel", "walk_parse_pack_kernel",
                    "walk_decode_kernel", "match_chunk_kernel",
                    "decode_packed_kernel")
MERGED_PATH_KERNELS = ("sweepwalk_kernel", "walk_decode_kernel")
CONFORMANCE_PATH_KERNELS = ("match_kernel", "walk_parse_pack_kernel",
                            "walk_decode_kernel")
PROBE_PATH_KERNELS = ("coissue_v_kernel", "coissue_s_kernel",
                      "coissue_f_kernel", "coissue_q_kernel")
SHARDED_PATH_KERNELS = ("match_kernel", "walk_parse_pack_kernel",
                        "walk_decode_kernel")
EXACT_STEP_PATH_KERNELS = ("match_kernel", "walk_parse_pack_kernel",
                           "walk_decode_kernel", "match_chunk_kernel")
# the exact step's runs on the first 8 MiB of text: (name, (data, win),
# (la, sb), matcher)
EXACT_STEP_OTHERS = (
    ("la255_sb65535_4x2", (4, 2), (255, 65535), "sweep"),
    ("l8_s500_4x2", (4, 2), (8, 500), "sweep"),
    ("chunk_8x1", (8, 1), (15, 4095), "chunk"),
)
# (data, win) shapes of the sharded path's meshes, every member on cuda:0
SHARDED_MESHES = ((1, 1), (8, 1), (4, 2))
# GiB the two big-run drivers encode (multihost_bigrun, bigrun_r5)
BIG_RUN_GB = 0.125


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def progress(what: str, t0: float) -> None:
    """One line on stderr, so a run cut by its time limit shows how far it
    got."""
    print(f"chip_smoke: {time.perf_counter() - t0:9.2f} s  {what}",
          file=sys.stderr, flush=True)


def make_text(rng: np.random.Generator, n: int) -> np.ndarray:
    """Word-salad text: 199 random lower-case words of 2..8 letters, drawn
    uniformly and joined by spaces; the word indices come from one call."""
    lens = rng.integers(2, 9, size=199)
    words = np.full((199, 9), ord(" "), np.uint8)
    for i, k in enumerate(lens):
        words[i, :k] = rng.integers(97, 123, size=k, dtype=np.uint8)
    idx = rng.integers(0, 199, size=n // 3 + 1)  # a word + space is >= 3 B
    mask = np.arange(9)[None, :] <= lens[idx][:, None]
    return words[idx][mask][:n]


def make_input(seed: int, text_mib: int) -> bytes:
    rng = np.random.default_rng(seed)
    return b"".join((
        make_text(rng, text_mib << 20).tobytes(),
        bytes(4 << 20),
        rng.integers(0, 256, 4 << 20, dtype=np.uint8).tobytes(),
    ))


def time_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def batch_on_card(x: np.ndarray, g0: int, G: int, B: int, p: spec.Params):
    n = x.shape[0]
    gn = min(G, -(-n // B) - g0)
    arrs = codec._batch_inputs(x, n, g0, gn, gn, B, p.d_limit, p.len_limit)
    return [torch.from_numpy(a).cuda() for a in arrs], min(gn * B, n - g0 * B)


# ---------------------------------------------------------------- K1 -----

def check_match(name, x, g0, G, B, p, reps=0, kernel="match_kernel"):
    """Kernel vs plain on one batch; returns the record (timed if reps).

    ``kernel``: "match_kernel" (K1) or "match_chunk_kernel" (K4); each is
    also held against the other's tables on the same batch."""
    fn, plain = {
        "match_kernel": (match.match_sweep, match.match_sweep_plain),
        "match_chunk_kernel": (match_chunk.match_chunk,
                               match_chunk.match_chunk_plain),
    }[kernel]
    args, _ = batch_on_card(x, g0, G, B, p)
    L, O = fn(*args, la=p.la, sb=p.sb)
    Lp, Op = plain(*args, la=p.la, sb=p.sb)
    torch.cuda.synchronize()
    err = max(max_err(L, Lp), max_err(O, Op))
    rec = {"kernel": kernel, "case": name, "la": p.la, "sb": p.sb,
           "shape": [len(args[0]), B], "max_abs_err": err}
    other = {"match_kernel": "match_chunk_kernel",
             "match_chunk_kernel": "match_kernel"}[kernel]
    L1, O1 = WRAPPERS[other](*args, la=p.la, sb=p.sb)
    rec[f"max_abs_err_vs_{other}"] = max(max_err(L, L1), max_err(O, O1))
    err = max(err, rec[f"max_abs_err_vs_{other}"])
    if err != 0:
        raise AssertionError(f"{kernel} disagrees: {rec}")
    if reps:
        blocks, halos, rights, avails, vexts = args
        pos = torch.arange(B, device="cuda", dtype=torch.int64)[None, :]
        cap = torch.clamp(vexts[:, None] - pos - 1, max=p.len_limit)
        dmax = torch.clamp(pos + avails[:, None], max=p.d_limit)
        # distances this data makes the sweep visit: up to the saturating
        # one where the cap is reached, else every reachable distance
        swept = torch.where(cap > 0, torch.where(L == cap, O.to(torch.int64), dmax), 0)
        ops = int(swept.sum())
        nbytes = sum(t.numel() * t.element_size() for t in (*args, L, O))
        rec.update(
            ms=time_ms(lambda: fn(*args, la=p.la, sb=p.sb), reps),
            plain_ms=time_ms(lambda: plain(*args, la=p.la, sb=p.sb), 1),
            bytes=nbytes, compares=ops,
            exhaustive_compares=int(dmax.sum()),
            bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            ops_ms=ops / INT_OPS_PER_S * 1e3,
            # a second reading, not the bound: four compares a lane
            # operation, as one word-wide XOR tests four distances
            ops_ms_four_a_lane_op=ops / 4 / INT_OPS_PER_S * 1e3,
        )
    return rec, (args, L, O)


def check_ranged(name, args, B, p, d_lo, d_hi):
    """K1 over the distances [d_lo, d_hi) against its plain version on one
    batch on the card; returns the record and the kernel's tables."""
    kw = dict(la=p.la, sb=p.sb, d_lo=d_lo, d_hi=d_hi)
    L, O = match.match_sweep(*args, **kw)
    Lp, Op = match.match_sweep_plain(*args, **kw)
    torch.cuda.synchronize()
    rec = {"kernel": "match_kernel", "case": name, "la": p.la, "sb": p.sb,
           "shape": [len(args[0]), B], "d_lo": d_lo, "d_hi": d_hi,
           "max_abs_err": max(max_err(L, Lp), max_err(O, Op))}
    if rec["max_abs_err"] != 0:
        raise AssertionError(f"ranged match_kernel disagrees: {rec}")
    return rec, (L, O)


def check_split(name, x, g0, G, B, p, n_win, plain=True):
    """The window axis's split of the distances over ``n_win`` members
    (``sharded._win_ranges``): each member's ranged K1 against its plain
    version (``plain``; else kernel alone), and the max of their
    ``combine_key``s against unranged K1."""
    args, _ = batch_on_card(x, g0, G, B, p)
    recs, keys = [], []
    for d_lo, d_hi in sharded._win_ranges(p.d_limit, n_win):
        if plain:
            rec, (L, O) = check_ranged(f"{name}_split{n_win}", args, B, p,
                                       d_lo, d_hi)
            recs.append(rec)
        else:
            L, O = match.match_sweep(*args, la=p.la, sb=p.sb, d_lo=d_lo,
                                     d_hi=d_hi)
        keys.append(match.combine_key(L, O, p.d_limit))
    Lc, Oc = match.split_key(torch.amax(torch.stack(keys), dim=0), p.d_limit)
    L1, O1 = match.match_sweep(*args, la=p.la, sb=p.sb)
    err = max(max_err(Lc, L1), max_err(Oc, O1))
    recs.append({"kernel": "match_kernel", "case": f"{name}_split{n_win}",
                 "la": p.la, "sb": p.sb, "members": n_win,
                 "max_abs_err": err, "combined_vs_unranged": True})
    if err != 0:
        raise AssertionError(f"combined ranged tables differ: {recs[-1]}")
    return recs


def check_ranged_cases(rng, mixed, far) -> list:
    """Ranged K1 on the card, max error 0: splits of 2, 3 and 4 members at
    la 2 / 15 / 255 x sb 15 / 4095 / 65535 from the stream start (avail 0,
    then avail < d_limit: members with nothing in range), ranges that start
    at every residue mod 4 and end at every residue (the staged window,
    and so each position's alignment, follows d_hi), zeros (a member w > 0
    stops at d_lo) and random bytes.  The plain version makes a pass per
    reachable distance, so the sb 65535 cases run on 4,500 bytes; far
    offsets (sources 65,000 back) take a range near d_limit against the
    plain version, and splits on them the kernel alone against unranged
    K1."""
    recs = []
    for la in (2, 15, 255):
        for sb in (15, 4095, 65535):
            xs, G, B = ((mixed, 5, 1801) if sb < 65535
                        else (mixed[:4500], 3, 1501))
            for n_win in (2, 3, 4):
                recs += check_split(f"la{la}_sb{sb}", xs, 0, G, B,
                                    spec.Params(la, sb), n_win)
    p0 = spec.Params()
    args, _ = batch_on_card(mixed, 0, 5, 1801, p0)
    for d_lo in range(2, 10):
        for width in (1, 6, 301):
            recs.append(check_ranged(f"d_lo{d_lo}_width{width}", args, 1801,
                                     p0, d_lo, d_lo + width)[0])
    for name, xs in (("zeros", np.zeros(8000, np.uint8)),
                     ("random", rng.integers(0, 256, 8000, dtype=np.uint8))):
        for p, G, B in ((p0, 5, 1801), (spec.Params(255, 65535), 3, 1333)):
            for n_win in (2, 4):
                recs += check_split(name, xs, 0, G, B, p, n_win)
    pw = spec.Params(15, 65535)
    args, _ = batch_on_card(far, 1, 2, 30000, pw)
    recs.append(check_ranged("far_offsets", args, 30000, pw, 61001,
                             65535)[0])
    for p in (pw, spec.Params(255, 65535)):
        for n_win in (2, 3, 4):
            recs += check_split("far_offsets", far, 1, 2, 30000, p, n_win,
                                plain=False)
    return recs


def time_ranged(x, g0, args, B, p, rec1) -> list:
    """K1 over ranges at the main path's shapes, each member against its
    plain version (max error 0) and timed, n=3: every member of splits of 2
    and 4 on the text batch ``args`` (rows ``g0``..), with the members'
    combined tables against unranged K1; then one-block shards, the shape
    the 4x2 mesh gives each member, at its two ranges, from the stream start
    and from the text batch's first block.  Returns the check records."""
    L1, O1 = match.match_sweep(*args, la=p.la, sb=p.sb)
    rec1["ranged_ms"] = {}
    recs = []
    for n_win in (2, 4):
        keys = []
        for w, (d_lo, d_hi) in enumerate(sharded._win_ranges(p.d_limit,
                                                             n_win)):
            rec, (L, O) = check_ranged(f"main_path_batch_split{n_win}_w{w}",
                                       args, B, p, d_lo, d_hi)
            recs.append(rec)
            keys.append(match.combine_key(L, O, p.d_limit))
            kw = dict(la=p.la, sb=p.sb, d_lo=d_lo, d_hi=d_hi)
            rec1["ranged_ms"][f"{n_win}_members_w{w}"] = {
                "d_lo": d_lo, "d_hi": d_hi,
                "ms": time_ms(lambda: match.match_sweep(*args, **kw), 3)}
        Lc, Oc = match.split_key(torch.amax(torch.stack(keys), dim=0),
                                 p.d_limit)
        err = max(max_err(Lc, L1), max_err(Oc, O1))
        rec1["ranged_ms"][f"{n_win}_members_combined_err"] = err
        recs.append({"kernel": "match_kernel",
                     "case": f"main_path_batch_split{n_win}", "members": n_win,
                     "max_abs_err": err, "combined_vs_unranged": True})
        if err != 0:
            raise AssertionError(f"main-shape split of {n_win} differs")
    for row in (0, g0):
        shard, _ = batch_on_card(x, row, 1, B, p)
        for d_lo, d_hi in sharded._win_ranges(p.d_limit, 2):
            recs.append(check_ranged(f"shard_4x2_row{row}", shard, B, p,
                                     d_lo, d_hi)[0])
    return recs


# ---------------------------------------------------------------- K2 -----

def check_walk(name, args, L, O, vt, entry, p, sub_block, reps=0,
               sub_blocks=False):
    """K2 against its plain version; ``sub_blocks``: the sub-blocks'
    ``entries`` and ``offsets`` too, against the plain version's
    ``sub_block`` form (the exact sharded step's return)."""
    blocks, _, rights = args[:3]
    N = blocks.numel()
    lox = parse_walk.build_lox(
        L.reshape(N), O.reshape(N), blocks.reshape(N), rights[-1], p.la)
    e = torch.tensor([entry], dtype=torch.int32, device="cuda")
    kw = dict(la=p.la, ob=p.off_bits, lb=p.len_bits)
    got = parse_walk.walk_parse_pack(lox, e, vt, sub_block=sub_block,
                                     sub_blocks=sub_blocks, **kw)
    want = parse_walk.walk_parse_pack_plain(
        lox, e, vt, sub_block=sub_block if sub_blocks else None,
        sub_blocks=sub_blocks, **kw)
    torch.cuda.synchronize()
    (tok, cnt, ex), (tokp, cntp, exp) = got[:3], want[:3]
    c = int(cnt)
    err = max(max_err(cnt, cntp), max_err(ex, exp), max_err(tok[:c], tokp[:c]),
              *(max_err(g, w) for g, w in zip(got[3:], want[3:])))
    rec = {"kernel": "walk_parse_pack_kernel", "case": name, "la": p.la,
           "sb": p.sb, "span": N, "valid_total": vt, "entry": entry,
           "sub_block": sub_block, "tokens": c, "exit": int(ex),
           "max_abs_err": err}
    if sub_blocks:
        rec["sub_blocks_held"] = int(got[3].numel())
    if err != 0:
        raise AssertionError(f"walk_parse_pack_kernel disagrees: {rec}")
    if reps:
        nbytes = lox.numel() * 4 + 4 + c * 4 + 8
        rec.update(
            scratch_bytes=parse_walk.walk_parse_pack.scratch_bytes,
            kernels_per_call=kernels_per_call(lambda: parse_walk.walk_parse_pack(
                lox, e, vt, sub_block=sub_block, **kw)),
            ms=time_ms(lambda: parse_walk.walk_parse_pack(
                lox, e, vt, sub_block=sub_block, **kw), reps),
            plain_ms=time_ms(lambda: parse_walk.walk_parse_pack_plain(
                lox, e, vt, **kw), 1),
            bytes=nbytes, bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            # per token: two field extracts, two shifts, two ors, one add
            ops_ms=c * 7 / INT_OPS_PER_S * 1e3,
        )
    return rec


# ---------------------------------------------------------------- K3 -----

def limits(p: spec.Params) -> dict:
    """The stream's limits, as the decode paths hand them to K3."""
    return dict(off_bits=p.off_bits, d_limit=p.d_limit,
                len_limit=p.len_limit)


def kernels_per_call(fn) -> dict:
    """This package's kernel launches in one call of ``fn``, by name, from
    ``torch.profiler`` (PyTorch's own kernels, copies and fills left out).
    A fill on the device opens the profile: its first activities may be
    lost from the trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    counts: dict = {}
    for ev in prof.events():
        name = ev.name.replace("(anonymous namespace)::", "")
        if ev.device_type != torch.autograd.DeviceType.CUDA \
                or "at::" in name or name.startswith("Mem"):
            continue
        name = name.split("(")[0].split("::")[-1]
        counts[name] = counts.get(name, 0) + 1
    return counts


def check_decode(name, stream: bytes, data: bytes, reps=0, split=None):
    """Kernel vs plain on a stream's tokens; ``split`` decodes the tail of
    the token list primed with the head's output as history window.  Small
    cases are also held against the plain version's tiled decomposition."""
    p, off, ln, nxt = bitio.parse_stream(stream)
    toks = torch.from_numpy(decode_walk.pack_token_words(off, ln, nxt)).cuda()
    T = toks.shape[0]
    win, wp, want = None, 0, data
    if split is not None:
        head = int((ln[:split] + 1).sum())
        win = torch.frombuffer(bytearray(data[:head]), dtype=torch.uint8).cuda()
        wp, toks, T, want = head, toks[split:].contiguous(), T - split, data[head:]
    kw = dict(out_cap=len(want), win=win, wp=wp, **limits(p))
    out, cnt = decode_walk.walk_decode(toks, T, **kw)
    outp, cntp = decode_walk.walk_decode_plain(toks, T, **kw)
    torch.cuda.synchronize()
    err = max(max_err(out, outp), max_err(cnt, cntp))
    rec = {"kernel": "walk_decode_kernel", "case": name, "tokens": T,
           "out_bytes": len(want), "wp": wp, "off_bits": p.off_bits,
           "max_abs_err": err}
    if not reps:
        outt, cntt = decode_walk.walk_decode_plain(
            toks, T, **kw, tile_bytes=4 * decode_walk.TILE_WORDS)
        rec["max_abs_err_vs_tiled_plain"] = max(max_err(out, outt),
                                                max_err(cnt, cntt))
        err = max(err, rec["max_abs_err_vs_tiled_plain"])
    if err != 0 or out.cpu().numpy().tobytes() != want:
        raise AssertionError(f"walk_decode_kernel wrong: {rec}")
    if reps:
        nbytes = T * 4 + wp + len(want) + 4
        rec.update(
            ms=time_ms(lambda: decode_walk.walk_decode(toks, T, **kw), reps),
            plain_ms=time_ms(
                lambda: decode_walk.walk_decode_plain(toks, T, **kw), 1),
            bytes=nbytes, bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            ops_ms=len(want) / INT_OPS_PER_S * 1e3,  # one move per byte
            scratch_bytes=decode_walk.walk_decode.scratch_bytes,
            tile_words=decode_walk.TILE_WORDS,
            kernels_per_call=kernels_per_call(
                lambda: decode_walk.walk_decode(toks, T, **kw)),
        )
        rec["ns_per_token"] = rec["ms"] * 1e6 / T
    return rec, (toks, T, kw)


def check_decode_chain(name, data: bytes, p: spec.Params, stage_tokens: int,
                       corrupt_stage: int, tmp: str, reps=3):
    """The streamed decode's stages by hand, as ``decode_file_device`` runs
    them: stages of ``stage_tokens`` tokens, each primed with the last
    d_limit bytes before it (a device tensor), kernel against the plain
    version's tiled decomposition stage by stage; the stages' bytes joined
    equal the input.  Then a token with a length in stage
    ``corrupt_stage`` gets off == 0: kernel and plain both answer -1 for
    that stage, and ``codec.decode_file_device`` raises on the stream."""
    stream = native.encode(data, p)
    _, off, ln, nxt = bitio.parse_stream(stream)
    words = torch.from_numpy(decode_walk.pack_token_words(off, ln, nxt)).cuda()
    T = words.shape[0]
    ends = np.cumsum(ln.astype(np.int64) + 1)
    bounds = list(range(0, T, stage_tokens)) + [T]

    def run(toks, check=False, stop=None):
        window, outs, err = None, [], 0
        for i, (a, b) in enumerate(zip(bounds, bounds[1:])):
            n_out = int(ends[b - 1] - (ends[a - 1] if a else 0))
            wp = 0 if window is None else int(window.shape[0])
            kw = dict(out_cap=n_out, win=window, wp=wp, **limits(p))
            out, cnt = decode_walk.walk_decode(toks[a:b], b - a, **kw)
            if check:
                outp, cntp = decode_walk.walk_decode_plain(
                    toks[a:b], b - a, **kw,
                    tile_bytes=4 * decode_walk.TILE_WORDS)
                err = max(err, max_err(cnt, cntp))
                if i == stop:
                    return int(cnt), int(cntp), err
                err = max(err, max_err(out, outp))
            window = (out if window is None else
                      torch.cat([window, out]))[-p.d_limit:]
            outs.append(out)
        return outs, err

    outs, err = run(words, check=True)
    got = torch.cat(outs).cpu().numpy().tobytes()
    rec = {"kernel": "walk_decode_kernel", "case": name, "la": p.la,
           "sb": p.sb, "tokens": T, "out_bytes": len(data),
           "stages": len(bounds) - 1, "stage_tokens": stage_tokens,
           "max_abs_err": err}
    if err != 0 or got != data:
        raise AssertionError(f"walk_decode_kernel chain wrong: {rec}")
    a = bounds[corrupt_stage]
    j = a + int(np.flatnonzero(ln[a:] > 0)[0])
    bad = words.clone()
    bad[j] = int(decode_walk.pack_token_words(
        np.array([0]), ln[j : j + 1], nxt[j : j + 1])[0])
    c, cp, err = run(bad, check=True, stop=corrupt_stage)
    off_bad = off.copy()
    off_bad[j] = 0
    path = os.path.join(tmp, f"{name}.lz")
    with open(path, "wb") as f:
        f.write(bitio.build_stream(off_bad, ln, nxt, p))
    try:
        codec.decode_file_device(path, path + ".out",
                                 tokens_per_stage=stage_tokens)
        raised = None
    except ValueError as e:
        raised = str(e)
    rec.update(corrupt_stage=corrupt_stage, corrupt_token=j,
               corrupt_count=c, corrupt_count_plain=cp, corrupt_raised=raised)
    if (c, cp, err) != (-1, -1, 0) \
            or raised != "corrupt stream: invalid token":
        raise AssertionError(f"walk_decode_kernel corrupt stage: {rec}")
    rec["ms"] = time_ms(lambda: run(words), reps)
    rec["ms_per_stage"] = rec["ms"] / rec["stages"]
    return rec


# ---------------------------------------------------------------- K6 -----

def check_decode_packed(name, stream: bytes, data: bytes, reps=0,
                        cap_words=None):
    """Packed-word kernel vs its plain version, vs K3's bytes and vs the
    input.  ``cap_words`` cuts the output short: the tokens that do not fit
    whole are dropped by all three alike."""
    p, off, ln, nxt = bitio.parse_stream(stream)
    toks = torch.from_numpy(decode_walk.pack_token_words(off, ln, nxt)).cuda()
    T = toks.shape[0]
    words = len(data) // 4 + 2 if cap_words is None else cap_words
    ends = np.cumsum(ln.astype(np.int64) + 1)
    kept = int(ends[ends <= 4 * words][-1]) if (ends <= 4 * words).any() else 0
    kw = dict(off_bits=p.off_bits, out_cap_words=words)
    out, cnt = decode_walk.walk_decode_packed(toks, T, **kw)
    outp, cntp = decode_walk.walk_decode_packed_plain(toks, T, **kw)
    ref, _ = decode_walk.walk_decode(
        toks, T, out_cap=min(4 * words, len(data)), off_bits=p.off_bits)
    torch.cuda.synchronize()
    raw = out.view(torch.uint8)
    err = max(max_err(out, outp), max_err(cnt, cntp),
              max_err(raw[: ref.shape[0]], ref))
    rec = {"kernel": "decode_packed_kernel", "case": name, "tokens": T,
           "out_bytes": len(data), "out_cap_words": words, "kept_bytes": kept,
           "off_bits": p.off_bits, "max_abs_err": err}
    host = raw.cpu().numpy()
    if err != 0 or int(cnt) != len(data) or host[kept:].any() \
            or host[:kept].tobytes() != data[:kept] \
            or (cap_words is None and kept != len(data)):
        raise AssertionError(f"decode_packed_kernel wrong: {rec}")
    if reps:
        nbytes = T * 4 + len(data) + 4
        rec.update(
            ms=time_ms(
                lambda: decode_walk.walk_decode_packed(toks, T, **kw), reps),
            plain_ms=time_ms(lambda: decode_walk.walk_decode_packed_plain(
                toks, T, out_cap_words=words), 1),
            bytes=nbytes, bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            ops_ms=len(data) / INT_OPS_PER_S * 1e3,  # one move per byte
            tile_words=decode_walk.TILE_WORDS,
            tiles=-(-words // decode_walk.TILE_WORDS),
            scratch_bytes=decode_walk.walk_decode_packed.scratch_bytes,
        )
        rec["ns_per_token"] = rec["ms"] * 1e6 / T
    return rec


# ---------------------------------------------------------------- K5 -----

def check_sweepwalk(name, x, g0, G, B, p, entry=0, cut=0, reps=0):
    """The merged kernel vs its plain version and vs K1 + K2 on the card, on
    one batch; ``cut`` takes bytes off ``valid_total`` (a ragged span)."""
    args, vt = batch_on_card(x, g0, G, B, p)
    vt -= cut
    blocks, _, rights = args[:3]
    N = blocks.numel()
    e = torch.tensor([entry], dtype=torch.int32, device="cuda")
    kw = dict(la=p.la, sb=p.sb)
    wkw = dict(la=p.la, ob=p.off_bits, lb=p.len_bits)
    tok, cnt, ex = fused_walk.sweep_walk(*args, e, vt, **kw)
    tokp, cntp, exp = fused_walk.sweep_walk_plain(*args, e, vt, **kw)
    L, O = match.match_sweep(*args, **kw)
    lox = parse_walk.build_lox(
        L.reshape(N), O.reshape(N), blocks.reshape(N), rights[-1], p.la)
    tok2, cnt2, ex2 = parse_walk.walk_parse_pack(lox, e, vt, **wkw)
    torch.cuda.synchronize()
    c = int(cnt)
    err = max(max_err(cnt, cntp), max_err(ex, exp), max_err(tok[:c], tokp[:c]))
    err2 = max(max_err(cnt, cnt2), max_err(ex, ex2), max_err(tok[:c], tok2[:c]))
    rec = {"kernel": "sweepwalk_kernel", "case": name, "la": p.la,
           "sb": p.sb, "shape": [len(blocks), B], "valid_total": vt,
           "entry": entry, "tokens": c, "exit": int(ex),
           "max_abs_err": err, "max_abs_err_vs_match_plus_walk": err2}
    if err != 0 or err2 != 0:
        raise AssertionError(f"sweepwalk_kernel disagrees: {rec}")
    if reps:
        _, _, _, avails, vexts = args
        pos = torch.arange(B, device="cuda", dtype=torch.int64)[None, :]
        cap = torch.clamp(vexts[:, None] - pos - 1, max=p.len_limit)
        dmax = torch.clamp(pos + avails[:, None], max=p.d_limit)
        # the sweep's compares, counted as for K1 (positions below vt only)
        swept = torch.where(cap > 0, torch.where(L == cap, O.to(torch.int64), dmax), 0)
        ops = int(swept.reshape(-1)[:vt].sum())
        nbytes = sum(t.numel() * t.element_size() for t in args) + 4 + c * 4 + 8

        def walk_route():
            Lw, Ow = match.match_sweep(*args, **kw)
            lw = parse_walk.build_lox(Lw.reshape(N), Ow.reshape(N),
                                      blocks.reshape(N), rights[-1], p.la)
            return parse_walk.walk_parse_pack(lw, e, vt, **wkw)

        rec.update(
            ms=time_ms(lambda: fused_walk.sweep_walk(*args, e, vt, **kw), reps),
            match_plus_walk_ms=time_ms(walk_route, reps),
            bytes=nbytes, compares=ops,
            bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            ops_ms=ops / INT_OPS_PER_S * 1e3,
        )
    return rec, (args, e, vt)


# ---------------------------------------------------------- CLI path -----

# ------------------------------------------------------- X-V .. X-Q -----

def probe_bounds(nv: int, steps: int) -> tuple[float, float]:
    """ms: ``nv`` vector bodies at one SM's issue rate (two instructions a
    slab element: ``(x ^ a) | (x & b)`` is one three-input LOP3, ``+ 1``
    one add; the add need not take the INT32 lanes, and the LOP3s alone
    fill the SM's 64 INT32 lanes a clock as long), and ``steps`` scalar
    steps at one shared-memory load-to-use each (a latency, not a
    rate)."""
    ops = nv * coissue.SLAB * coissue.RR * coissue.LANES * 2
    return ops / SM_ISSUE_LANES_PER_S * 1e3, steps * SMEM_LOAD_TO_USE_S * 1e3


def probe_shfl_ms(nv: int) -> float:
    """ms: the shuffles of ``coissue_v_kernel``'s design, one a row a
    thread a body (32 a thread, 256 threads), at one SM's shuffle rate.
    Not a bound of the function: the limit of this design's one addition
    to it, beside its time."""
    return nv * coissue.SLAB * 32 * coissue.RR / SHFL_LANES_PER_S * 1e3


def probe_err(kernel: str, got, plain_result) -> int:
    """Max abs error of a probe wrapper's result against its plain
    version's, taken in the order the wrapper returns them."""
    if kernel == "coissue_s_kernel":
        got, want = (got,), (plain_result,)
    elif kernel == "coissue_v_kernel":
        want = plain_result[:1], plain_result
    else:
        slab, tp = plain_result
        want = slab[:1], tp, slab
    return max(max_err(a, b) for a, b in zip(got, want))


def check_probe(seed: torch.Tensor, init: torch.Tensor) -> list:
    """The probe's kernels against their plain versions on the card,
    tolerance 0: V, F and Q from a random slab (all 8 slabs) and from
    ``coissue.ONE_HOT``'s slabs (one word in each slab, at the corners and
    at the ends of a thread's four lanes) after 1, 2, 7 and 33 bodies,
    which show a wrong roll, a wrong in-place order or a wrong shuffle (33
    wraps the rows); S across the table's wrap twice (stores land where
    the chain loads after 2,048 steps), F also at k 24; and the default
    slab, zeros, gives nv everywhere."""
    checks = []

    def held(kernel, case, got, plain_result, **info):
        err = probe_err(kernel, got, plain_result)
        rec = {"kernel": kernel, "case": case, **info, "max_abs_err": err}
        if err != 0:
            raise AssertionError(f"{kernel} disagrees: {rec}")
        checks.append(rec)

    slabs = [("random_slab", init)] + [
        (f"one_hot_r{r}_l{l}", coissue.one_hot_slab(r, l).to(init.device))
        for r, l in coissue.ONE_HOT]
    for name, x in slabs:
        for nv in (1, 2, 7, 33):
            held("coissue_v_kernel", f"nv{nv}_{name}",
                 coissue.call_v(nv, init=x), coissue.kernel_v(x, nv), nv=nv)
            held("coissue_f_kernel", f"nv{nv}_k8_{name}",
                 coissue.call_f(seed, nv, 8, x),
                 coissue.kernel_f(seed, x, nv, 8), nv=nv, k=8)
            held("coissue_q_kernel", f"nv{nv}_ns{8 * nv}_{name}",
                 coissue.call_q(seed, nv, 8 * nv, 8, x),
                 coissue.kernel_q(seed, x, nv, 8 * nv, 8), nv=nv, ns=8 * nv,
                 unroll=8)
    for ns in (8, 4096, 10000):
        held("coissue_s_kernel", f"ns{ns}", coissue.call_s(seed, ns, 8),
             coissue.kernel_s(seed, ns, 8), ns=ns, unroll=8)
    held("coissue_f_kernel", "nv7_k24", coissue.call_f(seed, 7, 24, init),
         coissue.kernel_f(seed, init, 7, 24), nv=7, k=24)
    _, slab = coissue.call_v(5, device=init.device)
    if not bool((slab == 5).all()):
        raise AssertionError("coissue_v_kernel: the default slab is not zeros")
    return checks


def sass_opcodes() -> dict:
    """{kernel: {opcode: count}} over the kernel library's SASS
    (``cuobjdump -sass``), opcodes without their modifiers; {} where the
    toolkit has no ``cuobjdump``."""
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", _build.build_kernels()],
                          capture_output=True, text=True, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            cur = out.setdefault(line.split("Function :")[1].strip(), {})
            continue
        parts = line.split("*/", 1)
        if cur is None or not parts[0].strip().startswith("/*") \
                or len(parts) < 2 or not parts[1].strip():
            continue
        words = parts[1].split()
        op = words[1] if words[0].startswith("@") else words[0]
        op = op.rstrip(";").split(".")[0]
        cur[op] = cur.get(op, 0) + 1
    return out


def probe_resources() -> dict:
    """ptxas' report for the slab kernels (registers, static shared
    memory, and spill bytes, stores + loads, and stack of the kernel and
    of the ``vec_loop`` it calls, together) and their SASS opcodes."""
    report = _build.ptxas_resources("coissue.cu")
    sass = sass_opcodes()

    def entry(name):
        (r,) = [v for k, v in report.items() if f"{len(name)}{name}" in k]
        return r

    loop = entry("vec_loop")
    out = {}
    for name in ("coissue_v_kernel", "coissue_f_kernel", "coissue_q_kernel"):
        r = entry(name)
        out[name] = {
            "registers": r["registers"], "smem_bytes": r["smem_bytes"],
            "spill_bytes": sum(x[k] for x in (r, loop) for k in (
                "spill_store_bytes", "spill_load_bytes")),
            "stack_bytes": r["stack_bytes"] + loop["stack_bytes"],
            "sass_opcodes": next((v for k, v in sass.items()
                                  if f"{len(name)}{name}" in k), None)}
    return out


def time_probe(seed: torch.Tensor, init: torch.Tensor, k: int,
               checks: list) -> list:
    """Each probe kernel's timed output held against its plain version
    (tolerance 0), then timed (median of 3 after a warm-up) beside its
    plain version and its bound, at loop counts the plain versions (a
    tensor op an element op of the chain) finish in about a second: V at
    nv 1000, S at ns 10,000, F and Q at nv 100 with ``PROBE_TIMED_K`` and
    again with the probe's k.  V, F and Q carry ptxas' report."""
    slab_b, seed_b = init.numel() * 4, seed.numel() * 4
    v_ops, _ = probe_bounds(1000, 0)
    _, s_lat = probe_bounds(0, 10000)

    def f_case(kk):
        fv_ops, fs_lat = probe_bounds(100, 100 * kk)
        return (lambda: coissue.call_f(seed, 100, kk, init),
                lambda: coissue.kernel_f(seed, init, 100, kk),
                max(fv_ops, fs_lat))

    def q_case(kk):
        fv_ops, fs_lat = probe_bounds(100, 100 * kk)
        return (lambda: coissue.call_q(seed, 100, 100 * kk, 8, init),
                lambda: coissue.kernel_q(seed, init, 100, 100 * kk, 8),
                fv_ops + fs_lat)

    kt = PROBE_TIMED_K
    # (kernel, case, kernel call, plain call, ops bound in ms, bytes, what
    #  that bound counts, the same at the probe's k or None)
    cases = (
        ("coissue_v_kernel", "nv1000", lambda: coissue.call_v(1000, init=init),
         lambda: coissue.kernel_v(init, 1000), v_ops, 2 * slab_b,
         "issue: a LOP3 and an add a slab element a body, 128 lanes a clock",
         None),
        ("coissue_s_kernel", "ns10000", lambda: coissue.call_s(seed, 10000, 8),
         lambda: coissue.kernel_s(seed, 10000, 8), s_lat, seed_b + 4,
         "latency: one shared-memory load-to-use a dependent step", None),
        ("coissue_f_kernel", f"nv100_k{kt}", *f_case(kt),
         2 * slab_b + seed_b + 4, "the larger of V's issue and S's latency",
         f_case(k)),
        ("coissue_q_kernel", f"nv100_ns{100 * kt}", *q_case(kt),
         2 * slab_b + seed_b + 4, "V's issue plus S's latency", q_case(k)),
    )

    res = probe_resources()
    recs = []
    for kernel, case, fn, plain, ops_ms, nbytes, note, at_k in cases:
        err = probe_err(kernel, fn(), plain())
        if err != 0:
            raise AssertionError(f"{kernel} disagrees on {case}: {err}")
        rec = {
            "kernel": kernel, "case": case, "timed_output_max_abs_err": err,
            "max_abs_err": max([err] + [c["max_abs_err"] for c in checks
                                        if c["kernel"] == kernel]),
            "ms": time_ms(fn, 3), "plain_ms": time_ms(plain, 1),
            "bytes": nbytes, "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "ops_ms": ops_ms, "bound_note": note, **res.get(kernel, {}),
        }
        if at_k is not None:
            fk, plain_k, ops_k = at_k
            err_k = probe_err(kernel, fk(), plain_k())
            if err_k != 0:
                raise AssertionError(f"{kernel} disagrees at k {k}: {err_k}")
            rec["at_probe_k"] = {"k": k, "ms": time_ms(fk, 3),
                                 "ops_ms": ops_k, "max_abs_err": err_k}
        recs.append(rec)
    recs[0]["shfl_ms"] = probe_shfl_ms(1000)
    return recs


def probe_by_k(ks=(0, 8, 16, 32, 88), n=(20_000, 40_000)) -> dict:
    """us an iteration of F and Q at several k (F's scalar steps an
    iteration, Q's ns / nv), each a slope over ``n`` iterations as the
    probe takes it, and the least-squares line through F's for k > 0: a
    per-step slope near ``scal_step_ns`` says the chain keeps its own
    speed once the slab warps are done, and the intercept is the part of
    a slab body the chain did not hide."""
    dev = torch.device("cuda")
    seed = torch.from_numpy(coissue.make_seed(np.random.default_rng(0))) \
        .to(dev)
    tc = lambda fn: coissue.time_call(fn, dev)  # noqa: E731
    f = {k: coissue.slope(lambda m: tc(lambda: coissue.call_f(seed, m, k)),
                          *n) * 1e6 for k in ks}
    q = {k: coissue.slope(lambda m: tc(lambda: coissue.call_q(
        seed, m, m * k, coissue.UNROLL)), *n) * 1e6 for k in ks}
    x = np.array([k for k in ks if k], float)
    slope_us, icept_us = np.polyfit(x, [f[k] for k in ks if k], 1)
    return {"fused_iter_us_by_k": f, "seq_nests_iter_us_by_k": q,
            "fused_step_ns_fit": slope_us * 1e3,
            "fused_intercept_us_fit": icept_us}


def drive_probe_path() -> tuple[dict, dict]:
    """The experiment's own measurement at its own sizes, once, counts
    zeroed before; prints its JSON line.  Returns (result, launches)."""
    reset_counts()
    t0 = time.perf_counter()
    r = coissue.probe()
    seconds = time.perf_counter() - t0
    launches = read_counts(PROBE_PATH_KERNELS, "the probe path")
    print(coissue.result_line(r), flush=True)
    missing = set(coissue.KEYS) - set(r)
    if missing or not all(np.isfinite(v) for v in r.values()):
        raise AssertionError(f"probe result incomplete: {r}")
    nearer_max = abs(r["fused_iter_us"] - r["max_us"]) \
        <= abs(r["fused_iter_us"] - r["sum_us"])
    emit({"coissue": {
        **r, "sizes": {"nv": [coissue.NV1, coissue.NV2],
                       "ns": [coissue.NS1, coissue.NS2],
                       "unroll": coissue.UNROLL},
        "seconds": seconds, "launches": launches, **probe_by_k(),
        "verdict": ("t_F nearer max(t_V, t_S): the chains overlap"
                    if nearer_max else
                    "t_F nearer t_V + t_S: the chains do not overlap"),
    }})
    return r, launches


# ------------------------------------------------------ conformance -----

def drive_conformance(tmp: str) -> dict:
    """``run_conformance(scale=4)`` with the device backend and the walk
    route, counts zeroed before each: every file round-trips and its stream
    equals the native encoder's.  Then the stream inspector on one stream.
    Returns {backend: launches}."""
    files = corpus.get_corpus(4)
    want = {name: native.encode(d, spec.Params()) for name, d in files.items()}
    by_backend = {}
    for backend in ("device", "fused"):
        reset_counts()
        streams = {}
        t0 = time.perf_counter()
        rows = conformance.run_conformance(4, backend, tmp, streams=streams)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_backend[backend] = read_counts(CONFORMANCE_PATH_KERNELS,
                                          f"the conformance path ({backend})")
        bad = [r["file"] for r in rows
               if not r["roundtrip"] or streams[r["file"]] != want[r["file"]]]
        if bad or sorted(streams) != sorted(files):
            raise AssertionError(f"conformance ({backend}) fails on {bad}")
        emit({"conformance": {
            "backend": backend, "scale": 4, "files": len(rows),
            "input_bytes": sum(r["bytes"] for r in rows), "wall_s": wall,
            "rows": rows, "launches": by_backend[backend],
            "roundtrip": True, "streams_equal_native": True,
        }})
    stream = streams["synthetic:english"]
    buf = io.StringIO()
    dump.dump(stream, limit=3, as_json=True, out=buf)
    info = json.loads(buf.getvalue())
    tokens = int(bitio.parse_stream(stream)[1].shape[0])
    if info["tokens"] != tokens or len(info["first_tokens"]) != 3:
        raise AssertionError(f"dump says {info['tokens']}, stream {tokens}")
    emit({"dump": {"file": "synthetic:english", "tokens": tokens,
                   "literals": info["literals"], "matches": info["matches"],
                   "decoded_bytes": info["decoded_bytes"]}})
    return by_backend


def reset_counts() -> None:
    for w in WRAPPERS.values():
        w.launches = 0


def read_counts(must_launch, what) -> dict:
    counts = {k: w.launches for k, w in WRAPPERS.items()}
    idle = [k for k in must_launch if counts[k] < 1]
    if idle:
        raise AssertionError(f"{what} never launched {idle}: {counts}")
    return counts


def run_cli(argv, expect_rc=0):
    """``cli.main(argv + ["--report"])`` -> the run report (or None); the
    CLI's stderr is captured, and shown if the exit code is not expected."""
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main(list(argv) + ["--report"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    text = err.getvalue()
    if rc != expect_rc:
        raise AssertionError(f"cli {argv}: exit {rc}, stderr: {text[-2000:]}")
    lines = [ln for ln in text.strip().splitlines() if ln.startswith("{")]
    rep = json.loads(lines[-1]) if lines and rc == 0 else {}
    rep["wall_s"] = dt
    return rep


@contextlib.contextmanager
def injected_fault(fail_batches):
    """While active, ``codec.encode_file`` (what the CLI calls) runs with a
    fault injector that fails the given batches: a deterministic kill."""
    orig = codec.encode_file

    def faulty(*a, **k):
        return orig(*a, fault_injector=faults.FaultInjector(fail_batches), **k)

    codec.encode_file = faulty
    try:
        yield
    finally:
        codec.encode_file = orig


def read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def drive_cli_path(data: bytes, ref_stream: bytes, tmp: str):
    """The CLI path, file to file; returns the ``cli`` record.  Raises on
    any stream or file that differs from its reference."""
    G = codec.DEFAULT_BATCH_BLOCKS
    inp, out, man = (os.path.join(tmp, n) for n in ("in", "out.lz", "m.json"))
    with open(inp, "wb") as f:
        f.write(data)
    host = ["-c", "-i", inp, "-o", out, "--pipeline", "host",
            "--matcher", "chunk", "--manifest", man]
    rec = {"input_bytes": len(data)}

    # 1. encode under a manifest, host-parse pipeline, chunk matcher (K4)
    enc = run_cli(host)
    if read(out) != ref_stream:
        raise AssertionError("cli host-pipeline stream != native.encode")
    if os.path.exists(man) or os.path.exists(out + ".partial"):
        raise AssertionError("manifest or scratch left behind")
    os.unlink(out)

    # 2. the same encode killed after two batches, then finished by --resume
    with injected_fault({3: 3}):
        run_cli(host, expect_rc=1)
    with open(man) as f:
        done = len(json.load(f)["blocks"])
    if done != 2 * G or os.path.exists(out):
        raise AssertionError(f"kill left {done} block records, want {2 * G}")
    k4 = match_chunk.match_chunk.launches
    res = run_cli(host + ["--resume"])
    resumed_batches = match_chunk.match_chunk.launches - k4
    batches = -(-len(data) // (G * codec.DEFAULT_BLOCK_SIZE))
    if read(out) != ref_stream or resumed_batches != batches - 2:
        raise AssertionError(
            f"resumed stream differs, or {resumed_batches} batches re-run")

    # 3. streamed device decode (K3 chained stage by stage)
    back = os.path.join(tmp, "round")
    k3 = decode_walk.walk_decode.launches
    dec = run_cli(["-d", "-i", out, "-o", back, "--decode-backend", "device"])
    stages = decode_walk.walk_decode.launches - k3
    if read(back) != data or stages < 2 \
            or dec["decode_backend"] != "device-walk-streamed":
        raise AssertionError(f"cli device decode wrong: {dec}, {stages} stages")
    # the same decode once more through the function the CLI calls, for the
    # host seconds by phase that the CLI's report does not carry
    dst = codec.DecodeStats()
    codec.decode_file(out, back, backend="device", stats=dst)
    if read(back) != data:
        raise AssertionError("codec.decode_file(device) != input")

    # 4. a token width that is no byte multiple: -l 8 -s 500 (20 bits), 8 MiB
    small = data[: 8 << 20]
    p20 = spec.Params(8, 500)
    sin, sout = os.path.join(tmp, "in8"), os.path.join(tmp, "out8.lz")
    with open(sin, "wb") as f:
        f.write(small)
    un = run_cli(["-c", "-i", sin, "-o", sout, "-l", "8", "-s", "500",
                  "--matcher", "chunk"])
    if read(sout) != native.encode(small, p20):
        raise AssertionError("cli -l 8 -s 500 stream != native.encode")
    und = run_cli(["-d", "-i", sout, "-o", back, "--decode-backend", "device"])
    if read(back) != small:
        raise AssertionError("cli -l 8 -s 500 round trip differs")

    # 5. the fused pipeline on files (K1 + K2)
    fus = run_cli(["-c", "-i", inp, "-o", out, "--pipeline", "fused"])
    if read(out) != ref_stream:
        raise AssertionError("cli fused-pipeline stream != native.encode")

    # 6. the packed-word decode (K6), through its public function
    p, off, ln, nxt = bitio.parse_stream(ref_stream)
    t0 = time.perf_counter()
    if decode_walk.decode_tokens_walk_packed(
            off, ln, nxt, off_bits=p.off_bits) != data:
        raise AssertionError("decode_tokens_walk_packed != input")
    packed_s = time.perf_counter() - t0

    mb = len(data) / 1e6
    rec.update({
        "encode_s": enc["wall_s"], "encode_MB_s": mb / enc["wall_s"],
        "decode_s": dec["wall_s"], "decode_MB_s": mb / dec["wall_s"],
        "pipeline": enc["pipeline"], "matcher": enc["matcher"],
        "tokens": enc["tokens"], "blocks": enc["blocks"],
        "phases": enc["phases"], "h2d_bytes": enc["h2d_bytes"],
        "d2h_bytes": enc["d2h_bytes"], "page_release": enc["page_release"],
        "resume_s": res["wall_s"], "resumed_batches": resumed_batches,
        "decode_backend": dec["decode_backend"], "decode_stages": stages,
        "decode_phases": dst.phases,
        "unaligned": {"la": 8, "sb": 500, "width": p20.width,
                      "input_bytes": len(small), "encode_s": un["wall_s"],
                      "encode_MB_s": len(small) / 1e6 / un["wall_s"],
                      "phases": un["phases"], "decode_s": und["wall_s"]},
        "fused_encode_s": fus["wall_s"],
        "fused_encode_MB_s": mb / fus["wall_s"], "fused_phases": fus["phases"],
        "packed_decode_s": packed_s,
        "peak_rss_mb": max(r["peak_rss_mb"] for r in (enc, dec, un, fus)),
        "stream_equals_native": True, "resumed_equals_native": True,
        "unaligned_equals_native": True, "fused_equals_native": True,
        "roundtrip": True,
    })
    return rec


def card_mesh(n_data: int, n_win: int):
    """An n_data x n_win mesh whose members all sit on cuda:0."""
    return mesh_lib.make_mesh(n_data, n_win,
                              devices=["cuda:0"] * (n_data * n_win))


def drive_sharded_path(data: bytes, ref_stream: bytes, tmp: str):
    """The sharded pipeline, counts zeroed before each step and read after:
    ``encode_bytes_sharded`` on 1x1, 8x1 and 4x2 meshes (K1 launches =
    batches x n_data x n_win, K2 = batches x n_data, K4 = K5 = 0; stream ==
    the library path's == ``native.encode``; ``decompress`` gives the data
    back); ``encode_file(pipeline="sharded")`` on 4x2 with a manifest,
    killed after two batches and finished by ``resume=True``; the CLI
    (default mesh, ``--device cuda --host-devices 8 --mesh 4x2``, ``-l 8
    -s 500`` on 8 MiB); the host pipeline with ``sharded_match_fn`` of the
    4x2 mesh on 8 MiB.  Returns (record, launches over the phase)."""
    p0 = spec.Params()
    B = codec.DEFAULT_BLOCK_SIZE
    nblocks = -(-len(data) // B)
    total = {k: 0 for k in WRAPPERS}
    rec = {"input_bytes": len(data), "la": p0.la, "sb": p0.sb,
           "block_size": B, "meshes": {}}

    def counted(what, must_launch=("match_kernel",)):
        counts = read_counts(must_launch, what)
        for k, v in counts.items():
            total[k] += v
        return counts

    for nd, nw in SHARDED_MESHES:
        m = card_mesh(nd, nw)
        reset_counts()
        st = codec.EncodeStats()
        t0 = time.perf_counter()
        s = sharded.encode_bytes_sharded(data, p0, mesh=m, stats=st)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        enc_counts = {k: w.launches for k, w in WRAPPERS.items()}
        back = lt.decompress(s)
        counts = counted(f"the sharded path ({nd}x{nw})",
                         SHARDED_PATH_KERNELS)
        # a batch is n_data blocks, a shard one block: every shard of every
        # batch holds a block (batches x n_data, where n_data divides the
        # blocks, as it does for the 40 one-MiB blocks here)
        batches = -(-nblocks // nd)
        want = {"match_kernel": nblocks * nw,
                "walk_parse_pack_kernel": nblocks,
                "match_chunk_kernel": 0, "sweepwalk_kernel": 0}
        if any(enc_counts[k] != v for k, v in want.items()):
            raise AssertionError(f"sharded {nd}x{nw} launched {enc_counts}, "
                                 f"want {want}")
        if s != ref_stream:
            raise AssertionError(f"sharded {nd}x{nw} stream differs")
        if back != data:
            raise AssertionError(f"sharded {nd}x{nw} round trip differs")
        rec["meshes"][f"{nd}x{nw}"] = {
            "batch_blocks": nd, "batches": batches, "encode_s": dt,
            "encode_MB_s": len(data) / dt / 1e6, "shards": st.shards,
            "resyncs": st.resyncs, "tokens": st.tokens,
            "h2d_bytes": st.h2d_bytes, "d2h_bytes": st.d2h_bytes,
            "phases": st.phases.as_dict(), "launches": counts,
            "stream_equals_native": True, "roundtrip": True,
        }
    # the three meshes again in turns, uncounted: the host clock's spread
    turns = {f"{nd}x{nw}": [] for nd, nw in SHARDED_MESHES}
    for nd, nw in (*SHARDED_MESHES, *SHARDED_MESHES[::-1]):
        t0 = time.perf_counter()
        sharded.encode_bytes_sharded(data, p0, mesh=card_mesh(nd, nw))
        torch.cuda.synchronize()
        turns[f"{nd}x{nw}"].append(len(data) / (time.perf_counter() - t0)
                                   / 1e6)
    rec["encode_MB_s_in_turns"] = turns

    # encode_file on 4x2 with a manifest: killed after two batches, resumed
    inp, out, man = (os.path.join(tmp, n) for n in ("in", "sh.lz", "sh.json"))
    with open(inp, "wb") as f:
        f.write(data)
    m = card_mesh(4, 2)
    kw = dict(pipeline="sharded", mesh=m, batch_blocks=8, manifest_path=man)
    reset_counts()
    try:
        codec.encode_file(inp, out, p0, fault_injector=faults.FaultInjector(
            {2: 1}), **kw)
    except RuntimeError as e:
        if "injected fault" not in str(e):
            raise
    else:
        raise AssertionError("the injected fault did not stop encode_file")
    with open(man) as f:
        done = len(json.load(f)["blocks"])
    st = codec.EncodeStats()
    t0 = time.perf_counter()
    codec.encode_file(inp, out, p0, resume=True, stats=st, **kw)
    resume_s = time.perf_counter() - t0
    counted("the sharded file encode")
    # shards of two blocks; the first two batches' eight are not re-run
    shards = sum(-(-min(8, nblocks - g0) // 2) for g0 in range(0, nblocks, 8))
    batches = -(-nblocks // 8)
    if done != 2 or st.shards != shards - 8 or read(out) != ref_stream:
        raise AssertionError(f"sharded resume: {done} records, {st.shards} "
                             "shards re-run, or the stream differs")
    resumed = batches - 2
    whole = os.path.join(tmp, "sh_whole.lz")
    reset_counts()
    codec.encode_file(inp, whole, p0, pipeline="sharded", mesh=m)
    counted("the sharded file encode, uninterrupted")
    if read(whole) != read(out):
        raise AssertionError("resumed sharded file != uninterrupted one")
    rec["file"] = {"mesh": "4x2", "batch_blocks": 8, "batches": batches,
                   "killed_after_batches": done, "resumed_batches": resumed,
                   "resume_s": resume_s, "resumed_equals_uninterrupted": True,
                   "stream_equals_native": True}

    # the CLI: default mesh, 4x2 on the card, the phase-pack route
    reset_counts()
    clis = {}
    r = run_cli(["-c", "-i", inp, "-o", out, "--pipeline", "sharded"])
    if read(out) != ref_stream:
        raise AssertionError("cli --pipeline sharded stream differs")
    clis["default_mesh"] = r
    r = run_cli(["-c", "-i", inp, "-o", out, "--pipeline", "sharded",
                 "--device", "cuda", "--host-devices", "8", "--mesh", "4x2"])
    if read(out) != ref_stream or r["shards"] != shards:
        raise AssertionError(f"cli sharded 4x2 differs: {r}")
    clis["4x2_on_one_card"] = r
    small = data[: 8 << 20]
    p20 = spec.Params(8, 500)
    sin, sout = os.path.join(tmp, "in8"), os.path.join(tmp, "out8.lz")
    with open(sin, "wb") as f:
        f.write(small)
    r = run_cli(["-c", "-i", sin, "-o", sout, "-l", "8", "-s", "500",
                 "--pipeline", "sharded"])
    if read(sout) != native.encode(small, p20):
        raise AssertionError("cli sharded -l 8 -s 500 stream differs")
    clis["l8_s500_8MiB"] = r
    counted("the sharded CLI")
    rec["cli"] = {k: {f: v.get(f) for f in (
        "wall_s", "mb_per_s", "shards", "resyncs", "resync_head_tokens",
        "resync_bulk", "h2d_bytes", "d2h_bytes", "phases")}
        for k, v in clis.items()}

    # the host pipeline with the 4x2 mesh's match phase
    reset_counts()
    t0 = time.perf_counter()
    s = codec.encode_bytes(small, p0, pipeline="host",
                           match_fn=sharded.sharded_match_fn(m, p0))
    host_s = time.perf_counter() - t0
    counted("the host pipeline with sharded_match_fn")
    if s != native.encode(small, p0):
        raise AssertionError("host pipeline with sharded_match_fn differs")
    rec["host_match_fn"] = {"mesh": "4x2", "input_bytes": len(small),
                            "encode_s": host_s, "stream_equals_native": True}
    rec["launches"] = total
    return rec, total


def exact_rows_stream(step, x: np.ndarray, p: spec.Params, B: int, G: int,
                      unpack_ms: list | None = None):
    """``make_sharded_exact_step`` over every batch of ``x`` from entry 0,
    the exit carried as the device tensor, each batch's rows packed into
    the stream: the token bytes where the width is a byte multiple, else
    ``native.pack_tokens_phase`` with a carried bit phase.  Returns (stream,
    step seconds a batch (device-synchronised), tokens).  With
    ``unpack_ms``, the device ms of each batch's unpacks into padded rows
    (CUDA events around ``sharded._unpack_rows``) are appended to it."""
    n = x.shape[0]
    nblocks = -(-n // B)
    ob, lb, nb = p.off_bits, p.len_bits, p.width // 8
    out = bytearray(bitio.header_bytes(p))
    bitpos = spec.HEADER_BITS
    entry, step_s, tokens = 0, [], 0
    unpack = sharded._unpack_rows

    def timed_unpack(*a):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        got = unpack(*a)
        ev[1].record()
        events.append(ev)
        return got

    if unpack_ms is not None:
        sharded._unpack_rows = timed_unpack
    try:
        for g0 in range(0, nblocks, G):
            gn = min(G, nblocks - g0)
            arrs = codec._batch_inputs(x, n, g0, gn, G, B, p.d_limit,
                                       p.len_limit)
            events = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            off, ln, nxt, counts, entry = step(*arrs, entry)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            if unpack_ms is not None:
                unpack_ms.append(sum(a.elapsed_time(b) for a, b in events))
            live = torch.arange(B, device=counts.device) < counts[:, None]
            if p.width % 8 == 0:
                w = (off.to(torch.int64) | (ln.to(torch.int64) << ob)
                     | (nxt.to(torch.int64) << (ob + lb)))[live]
                out += w.view(torch.uint8).reshape(-1, 8)[:, :nb].cpu() \
                    .numpy().tobytes()
            else:
                o, l_, nx = (t[live].cpu().numpy() for t in (off, ln, nxt))
                if o.shape[0]:
                    buf, bits = native.pack_tokens_phase(o, l_, nx, p,
                                                         bitpos % 8)
                    if bitpos % 8:
                        out[-1] |= int(buf[0])
                        out += buf[1:].tobytes()
                    else:
                        out += buf.tobytes()
                    bitpos += bits
            tokens += int(live.sum())
            del off, ln, nxt, counts, live
    finally:
        sharded._unpack_rows = unpack
    return bytes(out), step_s, tokens


def check_exact_step() -> list:
    """The exact step on the card against the same step on a CPU mesh (the
    plain versions), all five outputs at error 0: one batch of two 256 KiB
    blocks of text at la 15, sb 255 (the plain K1 on the CPU makes one pass
    a few distances), on 2x1 from entries 0, 7 and la + 3 and on 1x2 (K1
    over two distance ranges) from entry 7."""
    rng = np.random.default_rng(5)
    p = spec.Params(15, 255)
    B = 256 << 10
    x = make_text(rng, 2 * B + 3000)
    arrs = codec._batch_inputs(x, x.shape[0], 0, 2, 2, B, p.d_limit,
                               p.len_limit)
    recs = []
    for (nd, nw), entry in (((2, 1), 0), ((2, 1), 7), ((2, 1), p.la + 3),
                            ((1, 2), 7)):
        got = sharded.make_sharded_exact_step(card_mesh(nd, nw), p)(
            *arrs, entry)
        want = sharded.make_sharded_exact_step(
            mesh_lib.make_mesh(nd, nw, devices=["cpu"] * (nd * nw)), p)(
            *arrs, entry)
        torch.cuda.synchronize()
        err = max(max_err(g.cpu(), w) for g, w in zip(got, want))
        rec = {"case": f"{nd}x{nw}_entry{entry}", "la": p.la, "sb": p.sb,
               "blocks": 2, "block_size": B, "entry0": entry,
               "counts": got[3].tolist(), "exit": int(got[4]),
               "max_abs_err": err}
        if err != 0 or any(g.device.type != "cuda" for g in got):
            raise AssertionError(f"exact step disagrees with the CPU's: {rec}")
        recs.append(rec)
    return recs


def drive_exact_step_path(data: bytes, ref_stream: bytes, sh_rec: dict):
    """``make_sharded_exact_step``: first held against the same step on a
    CPU mesh (uncounted); then, counts zeroed, the 40 MiB at the defaults
    in 1 MiB blocks and batches of 8 on 1x1, 8x1 and 4x2 meshes on the
    card, each stream equal to ``native.encode``'s (the 1x1 one decoded by
    ``decompress``), and on the 8 MiB of text `Params(255, 65535)` on 4x2,
    `Params(8, 500)` (20-bit tokens) on 4x2 and ``matcher="chunk"`` on 8x1.
    Asserts the launches: K1 once a member of a shard a batch, K2 once a
    shard with valid bytes, K4 only for ``chunk``, K3 only for the decode,
    K5 and K6 never.  Returns (record, launches)."""
    t_phase = time.perf_counter()
    checks = check_exact_step()
    p0 = spec.Params()
    B, G = codec.DEFAULT_BLOCK_SIZE, 8
    x = np.frombuffer(data, np.uint8)
    nblocks = -(-x.shape[0] // B)
    batches = -(-nblocks // G)
    small = x[: 8 << 20]
    rec = {"input_bytes": len(data), "la": p0.la, "sb": p0.sb,
           "block_size": B, "batch_blocks": G,
           "sub_block": sharded.exact_sub_block(B), "checks": checks,
           "meshes": {}, "others": {}}
    want = {k: 0 for k in WRAPPERS}
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    for nd, nw in SHARDED_MESHES:
        unpack_ms = []
        t0 = time.perf_counter()
        s, step_s, tokens = exact_rows_stream(
            sharded.make_sharded_exact_step(card_mesh(nd, nw), p0), x, p0,
            B, G, unpack_ms)
        dt = time.perf_counter() - t0
        if s != ref_stream:
            raise AssertionError(f"exact step {nd}x{nw} stream differs")
        want["match_kernel"] += batches * nd * nw
        want["walk_parse_pack_kernel"] += batches * nd
        rec["meshes"][f"{nd}x{nw}"] = {
            "batches": len(step_s), "tokens": tokens,
            "step_ms_median": statistics.median(step_s) * 1e3,
            "step_ms": [t * 1e3 for t in step_s],
            "unpack_ms_median": statistics.median(unpack_ms),
            "encode_s": dt, "encode_MB_s": len(data) / dt / 1e6,
            "encode_bytes_sharded_MB_s":
                sh_rec["meshes"][f"{nd}x{nw}"]["encode_MB_s"],
            "stream_equals_native": True,
        }
        if (nd, nw) == (1, 1):
            if lt.decompress(s) != data:
                raise AssertionError("exact step stream does not decode")
            want["walk_decode_kernel"] += 1
            rec["meshes"]["1x1"]["roundtrip"] = True
        del s
    for name, (nd, nw), (la, sb), matcher in EXACT_STEP_OTHERS:
        p = spec.Params(la, sb)
        t0 = time.perf_counter()
        s, step_s, tokens = exact_rows_stream(
            sharded.make_sharded_exact_step(card_mesh(nd, nw), p,
                                            matcher=matcher), small, p, B, G)
        dt = time.perf_counter() - t0
        if s != native.encode(small.tobytes(), p):
            raise AssertionError(f"exact step {name} stream differs")
        k = "match_chunk_kernel" if matcher == "chunk" else "match_kernel"
        want[k] += nd * nw
        want["walk_parse_pack_kernel"] += nd
        rec["others"][name] = {
            "la": p.la, "sb": p.sb, "width": p.width, "matcher": matcher,
            "input_bytes": int(small.shape[0]), "tokens": tokens,
            "step_ms": step_s[0] * 1e3, "encode_s": dt,
            "stream_equals_native": True}
    launches = read_counts(EXACT_STEP_PATH_KERNELS, "the exact step path")
    if launches != want:
        raise AssertionError(f"exact step path launched {launches}, "
                             f"want {want}")
    rec.update(launches=launches,
               peak_device_bytes=torch.cuda.max_memory_allocated(),
               phase_s=time.perf_counter() - t_phase)
    return rec, launches


# the kernels the multi-process path must launch: K1 in the ranks (both
# routes), K4 in the ranks (host route, matcher chunk), K3 in this process
MULTIHOST_PATH_KERNELS = ("match_kernel", "match_chunk_kernel",
                          "walk_decode_kernel")
RANK_KERNELS = ("match_kernel", "match_chunk_kernel")


def drive_multihost_path(data: bytes, ref_stream: bytes, tmp: str):
    """The multi-process encode (``parallel.distributed``): every run is
    local ranks of ``python -m lz77_tpu_torch.parallel.distributed`` on a
    Gloo group at localhost, every rank on cuda:0, and every stream is
    checked against ``native.encode`` of the same input (and against the
    library path's stream where there is one).  The kernels and the native
    library are built before: ranks only load them.  Returns (record,
    launches over the phase: K1 and K4 from the ranks' reports, K3 from
    this process's decode)."""
    G = codec.DEFAULT_BATCH_BLOCKS
    B = codec.DEFAULT_BLOCK_SIZE
    inp = os.path.join(tmp, "mh_in")
    with open(inp, "wb") as f:
        f.write(data)
    rank_launches = {k: 0 for k in RANK_KERNELS}
    runs = {}

    def run(name, src, want, nproc, args=()):
        out = os.path.join(tmp, f"mh_{name}.lz")
        t0 = time.perf_counter()
        reports = distributed.launch(["-i", src, "-o", out, *args], nproc,
                                     timeout=600)
        wall = time.perf_counter() - t0
        got = read(out)
        if got != want:
            raise AssertionError(f"multihost {name}: stream != native.encode")
        for r in reports:
            for k in RANK_KERNELS:
                rank_launches[k] += r["launches"][k]
        slowest = max(r["wall"] for r in reports)
        n = os.path.getsize(src)
        runs[name] = {
            "nproc": nproc, "args": list(args), "input_bytes": n,
            "launcher_wall_s": wall, "slowest_rank_wall_s": slowest,
            "MB_s": n / slowest / 1e6, "ranks": reports,
            "stream_equals_native": True,
        }
        return runs[name], got

    # 1. encode_bytes_multihost of the whole input at the reference
    #    defaults (the fused route: K1 + the scan parser), on 1 (the
    #    distributed code in a world of one), 2 and 4 ranks
    nblocks = -(-len(data) // B)
    for nproc in (1, 2, 4):
        rec, stream = run(f"bytes_{nproc}", inp, ref_stream, nproc,
                          ["--mode", "bytes"] + (["--force"] if nproc == 1
                                                 else []))
        # a rank's K1 launches: one a batch of its range, twice where the
        # range was re-run from its true entry
        for r in rec["ranks"]:
            lo, hi = distributed.block_range(nblocks, nproc, r["rank"])
            want = -(-(hi - lo) // G) * (2 if r["resync_bulk"] else 1)
            if r["launches"]["match_kernel"] != want:
                raise AssertionError(f"bytes_{nproc} rank {r['rank']}: "
                                     f"{r['launches']}, want {want} K1")
    # 5. the decode of run 1's stream with decompress (K3)
    if lt.decompress(stream) != data:
        raise AssertionError("decompress(multihost stream) != input")

    # 2. encode_file_multihost on 4 ranks: the defaults (fused route), then
    #    Params(15, 300) on 8 MiB (21-bit tokens: the host route and the
    #    partial-byte merge) with K1 and with K4
    run("file_4", inp, ref_stream, 4, ["--mode", "file"])
    small = os.path.join(tmp, "mh_in8")
    with open(small, "wb") as f:
        f.write(data[: 8 << 20])
    p21 = spec.Params(15, 300)
    want21 = native.encode(data[: 8 << 20], p21)
    for matcher in ("sweep", "chunk"):
        rec, _ = run(f"file_4_l15_s300_{matcher}", small, want21, 4,
                     ["--mode", "file", "-l", "15", "-s", "300",
                      "--matcher", matcher])
        # 8 one-MiB blocks over 4 ranks: one batch a rank, one launch of
        # the matcher's kernel each and none of the other's
        k = "match_chunk_kernel" if matcher == "chunk" else "match_kernel"
        want = {o: 1 if o == k else 0 for o in RANK_KERNELS}
        if any(r["launches"] != want for r in rec["ranks"]):
            raise AssertionError(f"{matcher}: {rec['ranks']}, want {want}")
    # 3. an injected fault on batch 0 of rank 0, retried
    rec, _ = run("fault_2", inp, ref_stream, 2,
                 ["--mode", "bytes", "--fail-batches", "0:1"])
    if rec["ranks"][0]["retries"] != 1:
        raise AssertionError(f"fault run: {rec['ranks'][0]}")
    # 4. runs of zeros across every rank boundary, entered mid-token: the
    #    chains never meet, so each later rank re-runs its range
    rng = np.random.default_rng(5)
    runs_data = b"".join(bytes(9000 * 64) + make_text(rng, 5000 * 64)
                         .tobytes() for _ in range(4))
    rsrc = os.path.join(tmp, "mh_runs")
    with open(rsrc, "wb") as f:
        f.write(runs_data)
    rec, _ = run("never_resync_4", rsrc, native.encode(runs_data), 4,
                 ["--mode", "bytes"])
    if sum(r["resync_bulk"] for r in rec["ranks"]) < 1:
        raise AssertionError(f"no rank re-ran its range: {rec['ranks']}")

    one = runs["bytes_1"]["MB_s"]
    rec = {
        "input_bytes": len(data), "la": 15, "sb": 4095, "block_size": B,
        "batch_blocks": G, "device": "cuda:0 (every rank)",
        "note": ("ranks share one card and its SMs: MB/s at 2 and 4 ranks "
                 "measure contention on it, not scaling across cards"),
        "MB_s_by_ranks": {n: runs[f"bytes_{n}"]["MB_s"] for n in (1, 2, 4)},
        "scaling_efficiency": {
            n: metrics.scaling_efficiency(runs[f"bytes_{n}"]["MB_s"], one, n)
            for n in (2, 4)},
        "runs": runs, "decompress_equals_input": True,
    }
    return rec, rank_launches


def drive_big_runs(work: str, gb: float) -> dict:
    """The two experiment drivers at ``gb`` GiB on the card, each its own
    process; their phase lines, each ``ok`` phase checked (``oracle-decode``
    may say null: no C sources)."""
    out = {}
    for name, argv in (
        ("multihost_bigrun", [str(gb), "1", "2", work]),
        ("bigrun_r5", [str(gb), work]),
    ):
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", f"lz77_tpu_torch.experiments.{name}",
             *argv], capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise AssertionError(f"{name} exited {res.returncode}: "
                                 f"{res.stderr[-3000:]}")
        phases = [json.loads(ln) for ln in res.stdout.splitlines()
                  if ln.startswith("{")]
        bad = [p for p in phases if p.get("ok") is False]
        if bad or not any(p["phase"].startswith("identity") or
                          p["phase"] == "done" for p in phases):
            raise AssertionError(f"{name}: {bad or phases}")
        out[name] = {"seconds": time.perf_counter() - t0, "phases": phases}
    return out


def profile_summary(profile_dir: str, name: str):
    """Device time by kernel and the device's idle share of one traced
    region, from the numbers ``utils.profiling.trace`` wrote."""
    with open(os.path.join(profile_dir, name, "key_averages.json")) as f:
        d = json.load(f)
    rows = sorted((r for r in d["rows"]
                   if r["on_device"] and r["self_device_us"] > 0),
                  key=lambda r: -r["self_device_us"])
    busy = sum(r["self_device_us"] for r in rows)
    return {
        "call": name, "wall_ms": d["wall_us"] / 1e3, "device_ms": busy / 1e3,
        "device_idle_share": 1 - busy / d["wall_us"],
        "by_kernel": [{"name": r["name"][:80], "calls": r["calls"],
                       "device_ms": r["self_device_us"] / 1e3}
                      for r in rows[:20]],
    }


def profile_paths(data: bytes, stream: bytes, tmp: str, pdir: str):
    """The paths once more under the profiler: the library calls inside
    ``profiling.trace``, three CLI calls under ``--profile DIR``."""
    with profiling.trace(os.path.join(pdir, "library_compress")):
        lt.compress(data)
    with profiling.trace(os.path.join(pdir, "library_decompress")):
        lt.decompress(stream)
    with profiling.trace(os.path.join(pdir, "merged_encode")):
        fused.encode_bytes_fused(data, parser="merged")
    with profiling.trace(os.path.join(pdir, "sharded_encode_4x2")):
        sharded.encode_bytes_sharded(data, mesh=card_mesh(4, 2))
    inp, out = os.path.join(tmp, "in"), os.path.join(tmp, "out.lz")
    calls = {
        "cli_encode_host_chunk": ["-c", "-i", inp, "-o", out, "--pipeline",
                                  "host", "--matcher", "chunk"],
        "cli_encode_host_sweep": ["-c", "-i", inp, "-o", out, "--pipeline",
                                  "host", "--matcher", "sweep"],
        "cli_decode_device": ["-d", "-i", out, "-o",
                              os.path.join(tmp, "round"),
                              "--decode-backend", "device"],
    }
    for name, argv in calls.items():
        run_cli(argv + ["--profile", os.path.join(pdir, name)])
    return [profile_summary(pdir, name) for name in
            ("library_compress", "library_decompress", "merged_encode",
             "sharded_encode_4x2", *calls)]


# ------------------------------------------------------------- edges -----

# the kernels the edge phase's routes must launch (K1 launches nowhere at
# sb 1, where d_limit is 0, but at every other grid point)
EDGE_PATH_KERNELS = ("match_kernel", "walk_parse_pack_kernel",
                     "walk_decode_kernel", "match_chunk_kernel",
                     "decode_packed_kernel", "sweepwalk_kernel")
EDGE_BACKENDS = ("device", "device-chunked", "host", "native")


def edge_kernel_checks(x: np.ndarray, B: int, p: spec.Params) -> list:
    """Every codec kernel against its plain version on the card at one grid
    point, max error 0: K1 (full, and over the two ranges of a 2-member
    window axis with their combined tables), K4 (each also against the
    other's tables), K5 (also against K1 + K2), K2 at two sub-blocks from a
    nonzero entry, K3 on the stream's words (whole, and primed with the
    first half's bytes) and K6.  Each record says whether its kernel
    launched: the wrappers return empty tables without a launch where
    d_limit is 0."""
    name = f"edge_la{p.la}_sb{p.sb}"
    G = -(-x.shape[0] // B)
    recs = []

    def launched(kernel, before, rec):
        rec["launched"] = WRAPPERS[kernel].launches > before
        rec["grid_point"] = [p.la, p.sb]
        recs.append(rec)

    before = match.match_sweep.launches
    rec, (args, L, O) = check_match(name, x, 0, G, B, p)
    launched("match_kernel", before, rec)
    before = match.match_sweep.launches
    for rec in check_split(name, x, 0, G, B, p, 2):
        launched("match_kernel", before, rec)
    before = match_chunk.match_chunk.launches
    rec, _ = check_match(name, x, 0, G, B, p, kernel="match_chunk_kernel")
    launched("match_chunk_kernel", before, rec)
    entry = min(3, p.la - 1)
    for sub in (64, parse_walk.DEFAULT_SUB_BLOCK):
        before = parse_walk.walk_parse_pack.launches
        rec = check_walk(name, args, L, O, x.shape[0] - 333, entry, p, sub)
        launched("walk_parse_pack_kernel", before, rec)
    before = fused_walk.sweep_walk.launches
    rec, _ = check_sweepwalk(name, x, 0, G, B, p, entry=entry, cut=333)
    launched("sweepwalk_kernel", before, rec)
    data = x.tobytes()
    stream = native.encode(data, p)
    T = spec.token_count(len(stream) - spec.HEADER_BYTES, p.width)
    for split in (None, T // 2):
        before = decode_walk.walk_decode.launches
        rec, _ = check_decode(name if split is None else f"{name}_primed",
                              stream, data, split=split)
        launched("walk_decode_kernel", before, rec)
    before = decode_walk.walk_decode_packed.launches
    launched("decode_packed_kernel", before,
             check_decode_packed(name, stream, data))
    return recs


def edge_routes(data: bytes, p: spec.Params, B: int, tmp: str) -> dict:
    """Every encode route at one grid point, each stream equal to
    ``native.encode``'s (the fused parsers only where the width is
    byte-aligned, elsewhere their ValueError), and every decode route
    giving the input back; returns the count of checks by route."""
    want = native.encode(data, p)
    checks = {}

    def held(route, ok):
        if not ok:
            raise AssertionError(f"edge route {route} wrong at la {p.la} "
                                 f"sb {p.sb}")
        checks[route] = checks.get(route, 0) + 1

    for parser in fused.PARSERS:
        if bitio.byte_aligned(p):
            held(f"fused_{parser}", fused.encode_bytes_fused(
                data, p, block_size=B, parser=parser) == want)
        else:
            got = edges.outcome(fused.encode_bytes_fused, data, p,
                                block_size=B, parser=parser)
            held(f"fused_{parser}_refused", got == (
                "ValueError",
                "fused pipeline requires byte-aligned token width"))
    for matcher in ("sweep", "chunk"):
        held(f"host_{matcher}", codec.encode_bytes(
            data, p, pipeline="host", matcher=matcher, block_size=B) == want)
    held("sharded_2x2", sharded.encode_bytes_sharded(
        data, p, mesh=card_mesh(2, 2), block_size=B) == want)
    held("native_decode", native.decode(want) == data)
    held("decompress", lt.decompress(want) == data)
    for backend in ("device-chunked", "host", "native"):
        held(f"decode_bytes_{backend}",
             codec.decode_bytes(want, backend=backend) == data)
    _, off, ln, nxt = bitio.parse_stream(want)
    held("decode_tokens_walk_packed", decode_walk.decode_tokens_walk_packed(
        off, ln, nxt, off_bits=p.off_bits) == data)
    src, dst = os.path.join(tmp, "edge.lz"), os.path.join(tmp, "edge.out")
    with open(src, "wb") as f:
        f.write(want)
    for stage in (64, 4096):
        n = codec.decode_file_device(src, dst, tokens_per_stage=stage)
        held(f"decode_file_device_{stage}", n == len(data)
             and read(dst) == data)
    return checks


def edge_corpus(seed: int, tmp: str) -> tuple[int, int]:
    """The corrupt-stream corpus (``edges.corrupt_streams`` of the small
    input's streams) through every decode backend and the streamed device
    decode on cuda and on the CPU: the same bytes, or the same exception and
    text, else it raises.  Returns (streams, runs that raised on cuda)."""
    small = edges.make_input(seed, **edges.SMALL_SIZES)
    corpus = edges.corrupt_streams(seed, {
        f"la{la}_sb{sb}": native.encode(small, spec.Params(la, sb))
        for la, sb in edges.CORRUPT_GRID})
    src = os.path.join(tmp, "corrupt.lz")
    raised = 0

    def streamed(device):
        dst = os.path.join(tmp, f"corrupt.{device}")
        n = codec.decode_file_device(src, dst, tokens_per_stage=64,
                                     device=device)
        out = read(dst)
        if n != len(out):
            raise AssertionError(f"decode_file_device said {n} bytes, "
                                 f"wrote {len(out)}")
        return out

    for name, s in corpus.items():
        with open(src, "wb") as f:
            f.write(s)
        runs = [(b, lambda d, b=b: codec.decode_bytes(s, backend=b, device=d))
                for b in EDGE_BACKENDS]
        runs.append(("decode_file_device", streamed))
        for what, fn in runs:
            on_card = edges.outcome(fn, "cuda")
            torch.cuda.synchronize()
            on_cpu = edges.outcome(fn, "cpu")
            if on_card != on_cpu:
                raise AssertionError(
                    f"corrupt stream {name}, {what}: cuda gives "
                    f"{str(on_card)[:300]}, cpu {str(on_cpu)[:300]}")
            raised += isinstance(on_card, tuple)
    return len(corpus), raised


def drive_edge_path(seed: int = 0) -> tuple[dict, dict]:
    """The reference's parameter edges on the card (``edges.GRID``: la 2..255
    against sb 1..65535, off_bits 0, 1 and 2 among them), on
    ``edges.make_input`` at ``edges.CARD_SIZES`` from ``seed``: every codec
    kernel against its plain version at every grid point; then, counts
    zeroed, every encode and decode route at every grid point, one 2-rank
    ``distributed.launch`` at (255, 1), the CLI's default decode of a
    ``--force-sb -s 1`` stream, and the corrupt-stream corpus on cuda
    against the CPU, after which one small K3 launch must still succeed.
    Prints the ``edges`` line; returns (record, launches of the routes,
    the ranks' K1 and K4 among them)."""
    t0 = time.perf_counter()
    sizes = edges.CARD_SIZES
    B = sizes["block_size"]
    data = edges.make_input(seed, **sizes)
    x = np.frombuffer(data, np.uint8)
    grid = [spec.Params(la, sb) for la, sb in edges.GRID]
    kernel_recs = []
    for p in grid:
        kernel_recs += edge_kernel_checks(x, B, p)
    # checks by kernel (K1's ranged members and their combined tables
    # apart), and the grid points where a wrapper answered without a launch
    by_kernel, not_launched = {}, {}
    for r in kernel_recs:
        k = r["kernel"] + ("_ranged" if "members" in r or "d_lo" in r
                           else "")
        by_kernel[k] = by_kernel.get(k, 0) + 1
        if not r["launched"] and r["grid_point"] not in \
                not_launched.setdefault(k, []):
            not_launched[k].append(r["grid_point"])
    t1 = time.perf_counter()

    reset_counts()
    by_route = {}
    with tempfile.TemporaryDirectory() as tmp:
        for p in grid:
            for route, n in edge_routes(data, p, B, tmp).items():
                by_route[route] = by_route.get(route, 0) + n
        # the multi-process encode at off_bits 0: two ranks on cuda:0
        inp, out = os.path.join(tmp, "mh_in"), os.path.join(tmp, "mh.lz")
        with open(inp, "wb") as f:
            f.write(data)
        reports = distributed.launch(
            ["-i", inp, "-o", out, "--mode", "bytes", "-l", "255", "-s", "1",
             "--block-size", str(B)], 2, timeout=300)
        if read(out) != native.encode(data, spec.Params(255, 1)):
            raise AssertionError("distributed encode at (255, 1) differs")
        by_route["distributed_2_ranks"] = 1
        # the CLI: --force-sb -s 1 encoded, then its default decode
        lz, back = os.path.join(tmp, "cli.lz"), os.path.join(tmp, "cli.out")
        run_cli(["-c", "--force-sb", "-s", "1", "-l", "4", "-i", inp,
                 "-o", lz])
        run_cli(["-d", "-i", lz, "-o", back])
        if read(lz) != native.encode(data, spec.Params(4, 1)) \
                or read(back) != data:
            raise AssertionError("CLI at -l 4 -s 1 --force-sb differs")
        by_route["cli_force_sb_1"] = 1
        t2 = time.perf_counter()
        n_corrupt, n_raised = edge_corpus(seed, tmp)
        t3 = time.perf_counter()
    launches = read_counts(EDGE_PATH_KERNELS, "the edge path")
    # the context survived the corpus: one small K3 launch, held against
    # its plain version (so not counted)
    tail = data[:5000]
    check_decode("after_corpus", native.encode(tail, spec.Params(255, 1)),
                 tail)
    torch.cuda.synchronize()
    for r in reports:
        for k in RANK_KERNELS:
            launches[k] += r["launches"][k]
    rec = {
        "grid": [list(g) for g in edges.GRID],
        "input_bytes": len(data), "block_size": B,
        "kernel_checks": by_kernel,
        "kernel_checks_without_launch": not_launched,
        "max_abs_err": max(r["max_abs_err"] for r in kernel_recs),
        "route_checks": by_route,
        "corrupt_streams": n_corrupt,
        "corrupt_runs": n_corrupt * (len(EDGE_BACKENDS) + 1),
        "corrupt_runs_cuda_equals_cpu": n_corrupt * (len(EDGE_BACKENDS) + 1),
        "corrupt_runs_raised": n_raised,
        "context_usable_after_corpus": True,
        "launches": launches,
        "kernel_checks_s": t1 - t0, "routes_s": t2 - t1,
        "corpus_s": t3 - t2, "seconds": time.perf_counter() - t0,
    }
    emit({"edges": rec})
    return rec, launches


# ------------------------------------------------------- XLA matchers -----

XLA_MATCHERS = ("brute", "sorted", "chunked", "bitplane")
# the kernels the XLA matchers' routes must launch: K2 on their tables (the
# fused walk, the sharded walk) and K3 for the decodes; never K1, K4 or K5
XLA_PATH_KERNELS = ("walk_parse_pack_kernel", "walk_decode_kernel")
XLA_NEVER = ("match_kernel", "match_chunk_kernel", "sweepwalk_kernel")


@contextlib.contextmanager
def counting_matchers(calls: dict):
    """While active, every call of an XLA matcher or ranged form in this
    process (through ``match.get_matcher`` or the window axis) adds one to
    ``calls[name]``."""
    from lz77_tpu_torch.ops import bitplane

    def counted(name, fn):
        def run(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return run

    saved = [(match.MATCHERS, n, match.MATCHERS[n])
             for n in ("brute", "sorted", "chunked")]
    saved += [(vars(m), n, getattr(m, n)) for m, n in (
        (match, "find_matches_brute_range"),
        (bitplane, "find_matches_bitplane"),
        (bitplane, "find_matches_bitplane_range"))]
    for table, n, fn in saved:
        table[n] = counted(n.replace("find_matches_", ""), fn)
    try:
        yield
    finally:
        for table, n, fn in saved:
            table[n] = fn


def device_kernels(fn) -> int:
    """Device kernels one call of ``fn`` launches (copies left out), from
    ``torch.profiler`` around two calls on the same input.  A one-kernel
    fill opens the profile, as its first activities may be lost: the count
    is odd where the fill was kept, so half of it, rounded down, is a
    call's."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        fn()
        fn()
        torch.cuda.synchronize()
    return sum(1 for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and not ev.name.startswith("Mem")) // 2


def xla_case(name, args, p, reps) -> dict:
    """One XLA matcher on one batch on the card against K1's tables, error
    0; its median CUDA-event time over ``reps`` calls after the checked
    one, K1's beside it, and its peak device memory above what was
    allocated before the call."""
    fn = match.get_matcher(name)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    L, O = fn(*args, la=p.la, sb=p.sb)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    L1, O1 = match.match_sweep(*args, la=p.la, sb=p.sb)
    err = max(max_err(L, L1), max_err(O, O1))
    if err:
        raise AssertionError(f"XLA matcher {name} != match_kernel at "
                             f"la {p.la} sb {p.sb}: error {err}")
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn(*args, la=p.la, sb=p.sb)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return {"ms": statistics.median(times) if times else None,
            "match_kernel_ms": time_ms(
                lambda: match.match_sweep(*args, la=p.la, sb=p.sb), 5),
            "peak_device_bytes": peak, "max_abs_err": err}


def drive_xla_matcher_path(seed: int = 0) -> tuple[dict, dict]:
    """The JAX package's XLA matchers on the card (plain tensor code, no
    kernel of their own), each held against K1 with (L, O) error 0: at the
    defaults on a 1 MiB block of text, of zeros and of random bytes from
    ``seed``; ``sorted``, ``chunked`` and ``bitplane`` at la 255, sb 65535
    on the text block (``brute`` left out: its stack of 254 equality rows
    a distance, 65,535 distances); every matcher at every point of
    ``edges.GRID`` on the edge phase's input; ``brute_range`` and
    ``bitplane_range`` split 2 and 4 ways (the window axis's ranges),
    the members combined by ``combine_key``.  Then, counts zeroed, the
    routes: the CLI's host pipeline with each name on 8 MiB of text (the
    stream against ``native.encode``, decoded by the CLI's default decode,
    K3), ``codec.encode_bytes(pipeline="fused", matcher="sorted")`` (K2 on
    its tables), ``encode_bytes_sharded`` on a 2x2 mesh on cuda:0 with
    ``bitplane`` and ``brute`` on the window axis, and a 2-rank
    ``distributed.launch`` with ``chunked``; K1, K4 and K5 must launch on
    none of them.  Prints the ``xla_matchers`` line; returns (record,
    launches)."""
    t0 = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(seed + 11)
    p0, deep = spec.Params(), spec.Params(255, 65535)
    B = codec.DEFAULT_BLOCK_SIZE
    # block 1 of each 2 MiB input: a full halo of the same kind before it
    inputs = {"text": make_text(rng, 2 * B),
              "zeros": np.zeros(2 * B, np.uint8),
              "random": rng.integers(0, 256, 2 * B, dtype=np.uint8)}
    by_matcher = {m: {} for m in XLA_MATCHERS}
    kernels_a_call = {}
    for kind, xs in inputs.items():
        args, _ = batch_on_card(xs, 1, 1, B, p0)
        for m in XLA_MATCHERS:
            by_matcher[m][f"{kind}_la15_sb4095"] = xla_case(m, args, p0, 3)
            progress(f"xla {m} {kind} la 15 sb 4095", t0)
            if kind == "text":
                kernels_a_call[m] = device_kernels(
                    lambda: match.get_matcher(m)(*args, la=15, sb=4095))
                progress(f"xla {m} kernels a call", t0)
        del args
    args, _ = batch_on_card(inputs["text"], 1, 1, B, deep)
    for m in ("sorted", "chunked", "bitplane"):
        by_matcher[m]["text_la255_sb65535"] = xla_case(m, args, deep, 1)
        progress(f"xla {m} text la 255 sb 65535", t0)
    del args
    t1 = time.perf_counter()

    # every point of the edge grid, on the edge phase's input, one batch
    edge = np.frombuffer(edges.make_input(seed, **edges.CARD_SIZES),
                         np.uint8)
    eb = edges.CARD_SIZES["block_size"]
    grid_checks = {m: 0 for m in XLA_MATCHERS}
    grid_s = {m: 0.0 for m in XLA_MATCHERS}
    for la, sb in edges.GRID:
        p = spec.Params(la, sb)
        args, _ = batch_on_card(edge, 0, -(-edge.shape[0] // eb), eb, p)
        L1, O1 = match.match_sweep(*args, la=la, sb=sb)
        for m in XLA_MATCHERS:
            ts = time.perf_counter()
            L, O = match.get_matcher(m)(*args, la=la, sb=sb)
            torch.cuda.synchronize()
            grid_s[m] += time.perf_counter() - ts
            if max(max_err(L, L1), max_err(O, O1)):
                raise AssertionError(f"XLA matcher {m} != match_kernel at "
                                     f"edge point la {la} sb {sb}")
            grid_checks[m] += 1
            progress(f"xla {m} edge la {la} sb {sb}", t0)
        del args, L1, O1
    t2 = time.perf_counter()

    # the ranged forms over the window axis's ranges, combined
    args, _ = batch_on_card(inputs["text"], 1, 1, B, p0)
    L1, O1 = match.match_sweep(*args, la=p0.la, sb=p0.sb)
    ranged = {}
    for m in ("brute", "bitplane"):
        for n_win in (2, 4):
            ranges, fn = sharded._win_match(m, p0, n_win)
            keys, ms = [], []
            for d_lo, d_hi in ranges:
                a, b = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                a.record()
                L, O = fn(*args, d_lo=d_lo, d_hi=d_hi)
                b.record()
                torch.cuda.synchronize()
                ms.append(a.elapsed_time(b))
                keys.append(match.combine_key(L, O, p0.d_limit))
            L, O = match.split_key(torch.amax(torch.stack(keys), dim=0),
                                   p0.d_limit)
            err = max(max_err(L, L1), max_err(O, O1))
            if err:
                raise AssertionError(f"{m}_range split {n_win} ways != "
                                     f"match_kernel")
            progress(f"xla {m}_range split {n_win} ways", t0)
            ranged[f"{m}_range_{n_win}"] = {
                "ranges": [list(r) for r in ranges], "member_ms": ms,
                "max_abs_err": err}
    del args, L1, O1, L, O, keys
    t3 = time.perf_counter()

    # the routes, counts zeroed before and read after
    text8 = make_text(rng, 8 << 20).tobytes()
    want8 = native.encode(text8, p0)
    calls: dict = {}
    routes = {}
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp, counting_matchers(calls):
        inp = os.path.join(tmp, "text8")
        with open(inp, "wb") as f:
            f.write(text8)
        lz, back = os.path.join(tmp, "t.lz"), os.path.join(tmp, "t.out")
        for m in XLA_MATCHERS:
            rep = run_cli(["-c", "--pipeline", "host", "--matcher", m,
                           "-i", inp, "-o", lz])
            if read(lz) != want8 or rep["matcher"] != m:
                raise AssertionError(f"CLI --matcher {m} stream differs")
            drep = run_cli(["-d", "-i", lz, "-o", back])
            if read(back) != text8:
                raise AssertionError(f"CLI decode of the {m} stream differs")
            progress(f"xla route cli host {m}", t0)
            routes[f"cli_host_{m}"] = {"encode_wall_s": rep["wall_s"],
                                       "decode_wall_s": drep["wall_s"]}
        ts = time.perf_counter()
        got = codec.encode_bytes(text8, p0, pipeline="fused",
                                 matcher="sorted")
        torch.cuda.synchronize()
        if got != want8 or lt.decompress(got) != text8:
            raise AssertionError("fused walk with matcher sorted differs")
        routes["fused_walk_sorted"] = {"wall_s": time.perf_counter() - ts}
        progress("xla route fused walk sorted", t0)
        head = text8[: 2 << 20]
        want2 = native.encode(head, p0)
        for m in ("bitplane", "brute"):
            ts = time.perf_counter()
            got = sharded.encode_bytes_sharded(
                head, p0, mesh=card_mesh(2, 2), block_size=512 << 10,
                batch_blocks=2, matcher=m)
            torch.cuda.synchronize()
            if got != want2 or lt.decompress(got) != head:
                raise AssertionError(f"sharded 2x2 with {m} differs")
            routes[f"sharded_2x2_{m}"] = {"wall_s": time.perf_counter() - ts,
                                          "input_bytes": len(head)}
            progress(f"xla route sharded 2x2 {m}", t0)
        out = os.path.join(tmp, "mh.lz")
        ts = time.perf_counter()
        reports = distributed.launch(
            ["-i", inp, "-o", out, "--matcher", "chunked"], 2, timeout=300)
        if read(out) != want8:
            raise AssertionError("2-rank encode with chunked differs")
        routes["distributed_2_ranks_chunked"] = {
            "wall_s": time.perf_counter() - ts,
            "rank_launches": [r["launches"] for r in reports]}
    launches = read_counts(XLA_PATH_KERNELS, "the XLA matchers' routes")
    for r in reports:
        for k in RANK_KERNELS:
            launches[k] += r["launches"][k]
    wrong = {k: launches[k] for k in XLA_NEVER if launches[k]}
    if wrong:
        raise AssertionError(f"the XLA matchers' routes launched {wrong}")
    rec = {
        "card": card, "block_bytes": B, "by_matcher": by_matcher,
        "device_kernels_a_call_text_la15_sb4095": kernels_a_call,
        "grid": [list(g) for g in edges.GRID],
        "grid_input_bytes": int(edge.shape[0]), "grid_checks": grid_checks,
        "grid_s": grid_s, "ranged": ranged, "routes": routes,
        "route_input_bytes": len(text8),
        "matcher_calls_on_routes_in_this_process": calls,
        "launches": launches, "tolerance": 0,
        "tables_s": t1 - t0, "grid_phase_s": t2 - t1, "ranged_s": t3 - t2,
        "routes_s": time.perf_counter() - t3,
        "seconds": time.perf_counter() - t0,
    }
    emit({"xla_matchers": rec})
    return rec, launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--text-mib", type=int, default=32,
                    help="MiB of text in the main-path input (>= 8)")
    ap.add_argument("--profile", action="store_true",
                    help="also print the paths' device time by kernel "
                         "(the CLI calls run under --profile DIR)")
    ap.add_argument("--profile-dir", default=os.path.join("build", "profile"),
                    help="where --profile lets the CLI calls write their "
                         "traces")
    a = ap.parse_args()
    if a.text_mib < 8:
        ap.error("--text-mib must be at least 8 (16 MiB of input in all)")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        return 1

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda})
    t0 = time.perf_counter()
    _build.kernels()
    t1 = time.perf_counter()
    native.load()
    emit({"build": {"kernels_s": t1 - t0, "native_s": time.perf_counter() - t1}})

    rng = np.random.default_rng(a.seed + 1)
    p0 = spec.Params()
    data = make_input(a.seed, a.text_mib)
    x = np.frombuffer(data, np.uint8)
    small = np.concatenate([
        make_text(rng, 3000), np.zeros(700, np.uint8),
        rng.integers(0, 4, 1300, dtype=np.uint8),
    ])
    checks = []

    # K1 small: stream start (avail < H), valid_ext inside the last block,
    # deep la, widest window (tile + window > 48 KB of shared memory), a
    # power-of-two sb (d_limit = sb - 1)
    for name, p in (("default", p0), ("la255_sb255", spec.Params(255, 255)),
                    ("la129_sb65535", spec.Params(129, 65535)),
                    ("la4_sb4096", spec.Params(4, 4096))):
        rec, (args, L, O) = check_match(name, small, 0, 3, 1800, p)
        checks.append(rec)
        # K2 small on the same tables: nonzero entry, a valid_total that
        # cuts the data mid-token (nonzero exit), sub-blocks shorter and
        # longer than la
        for sub, entry in ((64, 0), (1000, min(3, p.la - 1))):
            checks.append(check_walk(
                name, args, L, O, small.shape[0] - 679, entry, p, sub))
    far = np.concatenate([small, rng.integers(0, 256, 60000, dtype=np.uint8),
                          small])
    rec, _ = check_match("far_offsets", far, 1, 2, 30000, spec.Params(129, 65535))
    checks.append(rec)
    # K1's word grid: block lengths at every residue mod 4 (so block starts
    # at every residue too) from the stream start (avail 0, then avail <
    # d_limit: dmax in mid-word) to a last block that ends the data
    # (valid_ext inside it); la 2, 4, 255 against sb 3, 4095, 4096, 65535;
    # zeros, an off == 1 run and random bytes.  Each case also against K4.
    mixed = np.concatenate([small, make_text(rng, 3000)])
    for B in (1800, 1801, 1802, 1803):
        rec, _ = check_match(f"phase_B{B}", mixed, 0, 5, B, p0)
        checks.append(rec)
    for la, sb in ((2, 3), (2, 65535), (4, 4095), (4, 4096), (255, 3),
                   (255, 4095), (255, 65535), (15, 3)):
        rec, _ = check_match(f"la{la}_sb{sb}", mixed, 0, 5, 1801,
                             spec.Params(la, sb))
        checks.append(rec)
    run1 = np.concatenate([make_text(rng, 1000), np.full(3000, 113, np.uint8),
                           make_text(rng, 1000)])
    for name, xs in (("zeros", np.zeros(8000, np.uint8)), ("off1_run", run1),
                     ("random", rng.integers(0, 256, 8000, dtype=np.uint8))):
        for p in (p0, spec.Params(255, 65535)):
            rec, _ = check_match(name, xs, 0, 5, 1801, p)
            checks.append(rec)

    # K1 over a range of distances (the sharded pipeline's window axis)
    checks += check_ranged_cases(rng, mixed, far)

    # K4 small, against its plain version and against K1: the same cases,
    # the deepest la with the widest window, the shallowest la, a block
    # length that is no multiple of anything
    for name, p, B in (("default", p0, 1800),
                       ("la255_sb255", spec.Params(255, 255), 1800),
                       ("la255_sb65535", spec.Params(255, 65535), 2500),
                       ("la4_sb4096", spec.Params(4, 4096), 1800),
                       ("la2_sb3", spec.Params(2, 3), 701)):
        rec, _ = check_match(name, small, 0, 3, B, p,
                             kernel="match_chunk_kernel")
        checks.append(rec)
    rec, _ = check_match("far_offsets", far, 1, 2, 30000,
                         spec.Params(255, 65535), kernel="match_chunk_kernel")
    checks.append(rec)

    tiles_src = make_text(rng, 13000)
    # K5 small, against its plain version and against K1 + K2 on the card:
    # the matchers' cases, blocks that are no multiple of the tile, blocks
    # shorter than la (tiles jumped over whole), a ragged valid_total with a
    # nonzero entry, far offsets, zeros and random bytes, every entry
    for name, xs, g0, G5, B5, p, entry, cut in (
        ("default", small, 0, 3, 1800, p0, 0, 0),
        ("la255_sb255", small, 0, 3, 1800, spec.Params(255, 255), 0, 0),
        ("la129_sb65535", small, 0, 3, 1800, spec.Params(129, 65535), 0, 0),
        ("la255_sb65535", small, 0, 2, 2500, spec.Params(255, 65535), 7, 0),
        ("la4_sb4096", small, 0, 3, 1800, spec.Params(4, 4096), 3, 0),
        ("la2_sb3", small, 0, 3, 701, spec.Params(2, 3), 1, 0),
        ("ragged", small, 0, 8, 701, p0, 3, 0),
        ("ragged_cut", small, 0, 3, 701, p0, 3, 679),
        ("second_batch", small, 3, 3, 701, p0, 5, 0),
        ("short_blocks", small, 0, 9, 100, spec.Params(255, 255), 200, 0),
        ("one_byte_blocks", small, 2, 40, 1, p0, 0, 0),
        ("far_offsets", far, 1, 2, 30000, spec.Params(129, 65535), 0, 0),
        ("zeros", np.zeros(5000, np.uint8), 0, 3, 1800, p0, 0, 0),
        ("random", rng.integers(0, 256, 5000, dtype=np.uint8), 0, 3, 1800,
         p0, 0, 0),
        # blocks around one tile: one position short, exact, one over
        ("blocks_4095", tiles_src, 0, 3, 4095, p0, 2, 0),
        ("blocks_4096", tiles_src, 0, 3, 4096, p0, 0, 0),
        ("blocks_4097", tiles_src, 0, 3, 4097, p0, 9, 1000),
        # blocks shorter than la, each a short tile of its own
        ("short_blocks_la15", small, 0, 40, 13, p0, 11, 0),
        ("short_blocks_la255", tiles_src, 1, 30, 200, spec.Params(255, 4095),
         254, 77),
    ):
        rec, _ = check_sweepwalk(name, xs, g0, G5, B5, p, entry, cut)
        checks.append(rec)
    for entry in range(p0.la):
        rec, _ = check_sweepwalk("every_entry", small, 1, 3, 701, p0, entry)
        checks.append(rec)

    # K3 small: text, off=1/2/3 runs, widest window, priming window
    for name, d, p in (
        ("text", make_text(rng, 50000).tobytes(), p0),
        ("off1", bytes(20000), p0), ("off2", b"ab" * 10000, p0),
        ("off3", b"abc" * 7000, p0), ("one", b"A", p0),
        ("far_offsets", far.tobytes(), spec.Params(15, 65535)),
    ):
        s = native.encode(d, p)
        checks.append(check_decode(name, s, d)[0])
        T = spec.token_count(len(s) - 4, p.width)
        for k in {1, T // 3, T - 1} - {0, T}:
            checks.append(
                check_decode(f"{name}_primed_at_{k}", s, d, split=k)[0])
        checks.append(check_decode_packed(name, s, d))
    # K3 as the streamed decode runs it: 3.5 MiB in stages of 2^17 tokens,
    # each primed with the d_limit bytes before it, at the defaults and at
    # the widest window (5000 random bytes that come back every 63,000:
    # sources far back), with a corrupt stage in each
    chain_block = rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
    chain_src = make_text(rng, 3 << 20).tobytes() + b"".join(
        chain_block + make_text(rng, 58000).tobytes() for _ in range(8))
    chains = []
    with tempfile.TemporaryDirectory() as tmp:
        for name, p in (("chain_la15_sb4095", p0),
                        ("chain_la15_sb65535", spec.Params(15, 65535))):
            chains.append(check_decode_chain(name, chain_src, p, 1 << 17, 2,
                                             tmp))
    checks += chains
    del chain_src
    # K6 alone: runs-heavy input, off 2-3 patterns of every phase against
    # the word grid, sources that straddle words, the deepest la (copies
    # long enough for the warp to share: off == 1 and far offsets)
    for name, d, p in (
        ("runs", b"".join(bytes([i]) * (i * 37 % 900 + 1) for i in range(256)),
         p0),
        ("off2_3", b"".join(b"xy" * (i % 50 + 2) + b"pqr" * (i % 40 + 2) +
                            bytes([i % 251]) for i in range(300)), p0),
        ("off4_7", b"abcd" * 3000 + b"abcdefg" * 3000 + b"abcde" * 3000, p0),
        ("la255", b"abcdefghijk" * 3000 + bytes(5000), spec.Params(255, 4095)),
        # long copies from far back: the path the whole warp shares
        ("la255_far", make_text(rng, 301).tobytes() * 60 +
         rng.integers(0, 256, 777, dtype=np.uint8).tobytes() * 9,
         spec.Params(255, 4095)),
    ):
        checks.append(check_decode_packed(name, native.encode(d, p), d))
    # K6 across tiles (a tile is TILE_WORDS words of output): tokens that
    # straddle tile boundaries, off == 1 copies of the longest length across
    # them, sources more than a tile back at the widest window, an output
    # shorter than one tile, every length residue mod 4, outputs cut short
    tile_bytes = 4 * decode_walk.TILE_WORDS
    tiles_text = make_text(rng, 4 * tile_bytes + 4001).tobytes()
    # 5000 bytes that come back every 63,000: copies from 63,000 behind
    far_block = rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
    far_tiles = b"".join(
        far_block + rng.integers(0, 256, 58000, dtype=np.uint8).tobytes()
        for _ in range(4))
    for name, d, p in (
        ("tiles_text", tiles_text, p0),
        ("tiles_off1_len254", bytes(3 * tile_bytes + 77),
         spec.Params(255, 4095)),
        ("tiles_off3", b"abc" * (tile_bytes + 5), p0),
        ("tiles_far_la15", far_tiles, spec.Params(15, 65535)),
        ("tiles_far_la255", far_tiles, spec.Params(255, 65535)),
        ("tiles_text_la255_sb65535", tiles_text[: 200_000 + 3],
         spec.Params(255, 65535)),
        ("under_one_tile", tiles_text[: tile_bytes // 3], p0),
    ):
        s = native.encode(d, p)
        checks.append(check_decode_packed(name, s, d))
        if name == "tiles_text":
            for r in range(4):  # every residue of the length mod 4
                dr = d[: 2 * tile_bytes + 8 + r]
                checks.append(check_decode_packed(
                    f"tiles_len_mod4_{r}", native.encode(dr, p), dr))
            for words in (0, 1, tile_bytes // 8 + 1,
                          decode_walk.TILE_WORDS, 2 * decode_walk.TILE_WORDS + 5,
                          len(d) // 4 - 1):
                checks.append(check_decode_packed(
                    f"tiles_cut_to_{words}_words", s, d, cap_words=words))
    del s, d, tiles_text, far_tiles

    # main-path shapes: the second 8 MiB text batch; the whole stream
    G, B = codec.DEFAULT_BATCH_BLOCKS, codec.DEFAULT_BLOCK_SIZE
    rec1, (args, L, O) = check_match("main_path_batch", x, G, G, B, p0, reps=5)
    checks += time_ranged(x, G, args, B, p0, rec1)
    rec2 = check_walk("main_path_batch", args, L, O, G * B, 0, p0,
                      parse_walk.DEFAULT_SUB_BLOCK, reps=10)
    # the sub-blocks' entries and offsets (the exact sharded step's), from
    # a nonzero entry
    checks.append(check_walk("main_path_batch_sub_blocks", args, L, O, G * B,
                             7, p0, parse_walk.DEFAULT_SUB_BLOCK,
                             sub_blocks=True))
    del args, L, O
    # K2 at la 2, 15 and 255 (byte-aligned widths), from a nonzero entry:
    # sub-blocks of one byte on one 1 MiB block, the default and 65,535 on
    # the second 8 MiB text batch
    rec2["ms_by_la_and_sub_block"] = {}
    for la, sb in ((2, 65), (15, 4095), (255, 255)):
        pk = spec.Params(la, sb)
        for Gk, sub in ((1, 1), (G, parse_walk.DEFAULT_SUB_BLOCK), (G, 65535)):
            args, vt = batch_on_card(x, G, Gk, B, pk)
            L, O = match.match_sweep(*args, la=la, sb=sb)
            r = check_walk(f"la{la}_sub_block{sub}", args, L, O, vt,
                           min(3, la - 1), pk, sub, reps=3)
            checks.append(r)
            rec2["ms_by_la_and_sub_block"][r["case"]] = {
                k: r[k] for k in ("span", "tokens", "ms", "plain_ms",
                                  "bytes_ms", "scratch_bytes")}
            del args, L, O
    rec4, _ = check_match("main_path_batch", x, G, G, B, p0, reps=5,
                          kernel="match_chunk_kernel")
    # K4 alone on a batch of zeros (every position saturates in the first
    # chunk), on random bytes (no early exit, the filter rejects nearly all)
    # and at the deepest la and widest window on one 1 MiB block (66 KB of
    # shared memory a thread block: another occupancy)
    zeros_batch = np.zeros(G * B, np.uint8)
    random_batch = rng.integers(0, 256, G * B, dtype=np.uint8)
    for name, xs, g0, Gk, pk in (
        ("zeros", zeros_batch, 0, G, p0), ("random", random_batch, 0, G, p0),
        ("la255_sb65535", x, G, 1, spec.Params(255, 65535)),
    ):
        args, _ = batch_on_card(xs, g0, Gk, B, pk)
        L4, O4 = match_chunk.match_chunk(*args, la=pk.la, sb=pk.sb)
        L1, O1 = match.match_sweep(*args, la=pk.la, sb=pk.sb)
        if max(max_err(L4, L1), max_err(O4, O1)) != 0:
            raise AssertionError(f"match_chunk_kernel != match_kernel: {name}")
        rec4[f"{name}_ms"] = time_ms(
            lambda: match_chunk.match_chunk(*args, la=pk.la, sb=pk.sb), 3)
        rec1[f"{name}_ms"] = rec4[f"{name}_match_kernel_ms"] = time_ms(
            lambda: match.match_sweep(*args, la=pk.la, sb=pk.sb), 3)
        rec1[f"{name}_match_chunk_kernel_ms"] = rec4[f"{name}_ms"]
        del args, L4, O4, L1, O1
    # K5 on the same text batch, then its time alone on a batch of zeros
    # (the sweep exits at distance 1: the hand-off chain is what is left)
    # and on a batch of random bytes (no early exit, a token a byte)
    rec5, (args, e5, vt5) = check_sweepwalk(
        "main_path_batch", x, G, G, B, p0, reps=5)
    rec5["plain_ms"] = time_ms(lambda: fused_walk.sweep_walk_plain(
        *args, e5, vt5, la=p0.la, sb=p0.sb), 1)
    # the text batch and the zeros batch at other tile sizes (a hop of the
    # hand-off chain a tile); each result held against the module's own
    # tile's, whose size is put back
    zargs, zvt = batch_on_card(zeros_batch, 0, G, B, p0)
    tile_cases = (("text", args, vt5), ("zeros", zargs, zvt))
    wants = [fused_walk.sweep_walk(*ta, e5, tvt, la=p0.la, sb=p0.sb)
             for _, ta, tvt in tile_cases]
    own_tile = fused_walk.TILE
    rec5["tile"] = own_tile
    rec5["ms_by_tile"] = {}
    try:
        for tile in (512, 1024, 2048, 4096, 8192):
            fused_walk.TILE = tile
            row = {}
            for (name, ta, tvt), want in zip(tile_cases, wants):
                got = fused_walk.sweep_walk(*ta, e5, tvt, la=p0.la, sb=p0.sb)
                c = int(want[1])
                if max(max_err(got[1], want[1]), max_err(got[2], want[2]),
                       max_err(got[0][:c], want[0][:c])) != 0:
                    raise AssertionError(f"sweepwalk_kernel at tile {tile} "
                                         f"disagrees on {name}")
                row[f"{name}_ms"] = time_ms(lambda: fused_walk.sweep_walk(
                    *ta, e5, tvt, la=p0.la, sb=p0.sb), 3)
            rec5["ms_by_tile"][tile] = row
    finally:
        fused_walk.TILE = own_tile
    del args, zargs, tile_cases, wants
    for name, xs in (("zeros", zeros_batch), ("random", random_batch)):
        r, _ = check_sweepwalk(f"main_shape_{name}", xs, 0, G, B, p0, reps=5)
        rec5[f"{name}_ms"] = r["ms"]
        rec5[f"{name}_match_plus_walk_ms"] = r["match_plus_walk_ms"]
        rec5[f"{name}_tokens"] = r["tokens"]
    ref_stream = native.encode(data, p0)
    rec3, (toks3, T3, kw3) = check_decode("main_path_stream", ref_stream,
                                          data, reps=3)
    rec3["chains"] = {c["case"]: {k: c[k] for k in ("stages", "ms",
                                                    "ms_per_stage")}
                      for c in chains}
    # the widest window (off_bits 16: a tail of 65,791 bytes, more than a
    # tile) on 8 MiB of text, then both streams at other tile sizes, each
    # result held against the module's own tile's, whose size is put back
    wide_src = data[: 8 << 20]
    r, wide = check_decode("main_shape_sb65535",
                           native.encode(wide_src, spec.Params(15, 65535)),
                           wide_src, reps=3)
    rec3["sb65535_ms"] = r["ms"]
    rec3["sb65535_tokens"] = r["tokens"]
    tile_cases = (("sb4095", (toks3, T3, kw3)), ("sb65535", wide))
    wants = [decode_walk.walk_decode(t, n, **k)[0] for _, (t, n, k)
             in tile_cases]
    own_tile = decode_walk.TILE_WORDS
    rec3["ms_by_tile_words"] = {}
    try:
        for tw in (2048, 4096, 8192, 12288, 14336):
            decode_walk.TILE_WORDS = tw
            row = {}
            for (tname, (t, n, k)), want in zip(tile_cases, wants):
                if max_err(decode_walk.walk_decode(t, n, **k)[0], want):
                    raise AssertionError(
                        f"walk_decode_kernel at tile {tw} disagrees: {tname}")
                row[f"{tname}_ms"] = time_ms(
                    lambda: decode_walk.walk_decode(t, n, **k), 3)
            rec3["ms_by_tile_words"][tw] = row
    finally:
        decode_walk.TILE_WORDS = own_tile
    del toks3, kw3, wide, tile_cases, wants
    rec6 = check_decode_packed("main_path_stream", ref_stream, data, reps=3)
    rec6["walk_decode_kernel_scratch_bytes"] = rec3["scratch_bytes"]
    # the same stream at other tile sizes (fewer, larger tiles: fewer hops
    # of the tile-to-tile hand-off); the module's own size is put back
    own_tile = decode_walk.TILE_WORDS
    rec6["ms_by_tile_words"] = {own_tile: rec6["ms"]}
    try:
        for tw in (2048, 4096, 8192, 14336):
            decode_walk.TILE_WORDS = tw
            r = check_decode_packed(f"main_path_stream_tile_{tw}", ref_stream,
                                    data, reps=3)
            rec6["ms_by_tile_words"][tw] = r["ms"]
    finally:
        decode_walk.TILE_WORDS = own_tile
    # K3 and K6 alone on 8 MiB of zeros (no tile needs another) and of
    # random bytes (short copies, nearly all literals)
    for name, xs in (("zeros", zeros_batch), ("random", random_batch)):
        d = xs.tobytes()
        s = native.encode(d, p0)
        r = check_decode_packed(f"main_shape_{name}", s, d, reps=3)
        rec6[f"{name}_ms"] = r["ms"]
        rec6[f"{name}_tokens"] = r["tokens"]
        r, _ = check_decode(f"main_shape_{name}", s, d, reps=3)
        rec3[f"{name}_ms"] = r["ms"]
        rec3[f"{name}_tokens"] = r["tokens"]
    del zeros_batch, random_batch, d
    checks += [rec1, rec2, rec3, rec4, rec5, rec6]
    # X-V .. X-Q, the co-issue probe's kernels, from --seed: the
    # experiment's seed recipe and a random initial slab
    prng = np.random.default_rng(a.seed + 7)
    p_seed = torch.from_numpy(coissue.make_seed(prng)).cuda()
    p_init = torch.from_numpy(prng.integers(
        -(1 << 31), 1 << 31, (coissue.SLAB, coissue.RR, coissue.LANES),
        dtype=np.int64).astype(np.int32)).cuda()
    probe_checks = check_probe(p_seed, p_init)
    checks += probe_checks
    emit({"kernel_checks": checks, "tolerance": 0})

    # ---- the library path, once, through the public entry points --------
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    st = codec.EncodeStats()
    t0 = time.perf_counter()
    stream = lt.compress(data, stats=st)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = lt.decompress(stream)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    launches = read_counts(LIBRARY_PATH_KERNELS, "the library path")
    peak = torch.cuda.max_memory_allocated()
    if stream != ref_stream:
        raise AssertionError("stream differs from native.encode")
    if back != data:
        raise AssertionError("decompress(compress(x)) != x")
    if native.decode(stream) != data:
        raise AssertionError("native.decode(stream) != x")
    batches = -(-st.blocks // G)
    if batches < min(4, -(-len(data) // (G * B))):
        raise AssertionError(f"main path: {batches} batches, {launches}")
    emit({"main_path": {
        "la": p0.la, "sb": p0.sb, "input_bytes": len(data),
        "stream_bytes": len(stream), "tokens": st.tokens, "batches": batches,
        "encode_s": enc_s, "encode_MB_s": len(data) / enc_s / 1e6,
        "decode_s": dec_s, "decode_MB_s": len(data) / dec_s / 1e6,
        "phases": st.phases.as_dict(), "h2d_bytes": st.h2d_bytes,
        "d2h_bytes": st.d2h_bytes, "peak_device_bytes": peak,
        "launches": launches, "stream_equals_native": True,
        "roundtrip": True, "native_decode": True,
    }})

    # ---- the merged path, once: one kernel a batch, no sweep, no walk ----
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    stm = codec.EncodeStats()
    t0 = time.perf_counter()
    merged = fused.encode_bytes_fused(data, p0, parser="merged", stats=stm)
    torch.cuda.synchronize()
    menc_s = time.perf_counter() - t0
    mback = lt.decompress(merged)
    m_launches = read_counts(MERGED_PATH_KERNELS, "the merged path")
    if (m_launches["sweepwalk_kernel"] != batches
            or m_launches["match_kernel"]
            or m_launches["walk_parse_pack_kernel"]):
        raise AssertionError(f"merged path launched {m_launches}")
    if merged != ref_stream or merged != stream:
        raise AssertionError("merged stream differs from native / walk route")
    if mback != data:
        raise AssertionError("decompress(merged stream) != x")
    # both routes in turns, on this card, for the comparison
    turns = {"walk": [], "merged": []}
    for parser in ("walk", "merged", "merged", "walk"):
        t0 = time.perf_counter()
        fused.encode_bytes_fused(data, p0, parser=parser)
        torch.cuda.synchronize()
        turns[parser].append(time.perf_counter() - t0)
    emit({"merged_path": {
        "la": p0.la, "sb": p0.sb, "input_bytes": len(data),
        "tokens": stm.tokens, "batches": batches, "encode_s": menc_s,
        "encode_MB_s": len(data) / menc_s / 1e6,
        "walk_route_encode_MB_s": len(data) / enc_s / 1e6,
        "in_turns_s": turns, "phases": stm.phases.as_dict(),
        "h2d_bytes": stm.h2d_bytes, "d2h_bytes": stm.d2h_bytes,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "launches": m_launches, "stream_equals_native": True,
        "stream_equals_walk_route": True, "roundtrip": True,
    }})

    # ---- the plain tensor modules on the card, first 8 MiB ---------------
    head = data[: 8 << 20]
    head_ref = native.encode(head, p0)
    t0 = time.perf_counter()
    scan = fused.encode_bytes_fused(head, p0, parser="scan")
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    if scan != head_ref or scan != fused.encode_bytes_fused(head, p0):
        raise AssertionError("scan parser stream differs")
    t0 = time.perf_counter()
    chunked = codec.decode_bytes(head_ref, backend="device-chunked")
    torch.cuda.synchronize()
    chunked_s = time.perf_counter() - t0
    if chunked != head or chunked != lt.decompress(head_ref):
        raise AssertionError("device-chunked decode differs")
    emit({"plain_modules": {
        "note": "plain tensor code, no kernel of their own",
        "input_bytes": len(head), "scan_encode_s": scan_s,
        "scan_encode_MB_s": len(head) / scan_s / 1e6,
        "device_chunked_decode_s": chunked_s,
        "device_chunked_decode_MB_s": len(head) / chunked_s / 1e6,
        "scan_equals_native": True, "device_chunked_equals_input": True,
    }})

    # ---- the CLI path, once, file to file through cli.main --------------
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        cli_rec = drive_cli_path(data, ref_stream, tmp)
        cli_launches = read_counts(CLI_PATH_KERNELS, "the CLI path")
        cli_rec["peak_device_bytes"] = torch.cuda.max_memory_allocated()
        cli_rec["launches"] = cli_launches
        emit({"cli": cli_rec})

        if a.profile:
            emit({"profile": profile_paths(data, stream, tmp, a.profile_dir)})

    # ---- the co-issue probe, once, at the experiment's own sizes --------
    probe_result, probe_launches = drive_probe_path()
    xrecs = time_probe(p_seed, p_init,
                       probe_result["k_scalar_steps_per_iter"], probe_checks)
    emit({"probe_kernels": xrecs})

    # ---- the conformance runner at scale 4, both device encoders --------
    with tempfile.TemporaryDirectory() as tmp:
        conf_launches = drive_conformance(tmp)

    # ---- the sharded pipeline: meshes on the card, file, CLI, match_fn ---
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        sh_rec, sh_launches = drive_sharded_path(data, ref_stream, tmp)
        sh_rec["phase_s"] = time.perf_counter() - t0
        emit({"sharded_path": sh_rec})

    # ---- the exact entry-carried sharded step: meshes, widths, chunk ----
    ex_rec, ex_launches = drive_exact_step_path(data, ref_stream, sh_rec)
    ex_rec["card"] = card
    emit({"exact_step": ex_rec})

    # ---- the multi-process encode: local ranks on cuda:0 over Gloo ------
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        reset_counts()
        mh_rec, rank_launches = drive_multihost_path(data, ref_stream, tmp)
        t1 = time.perf_counter()
        big = drive_big_runs(os.path.join(tmp, "big"), BIG_RUN_GB)
        # this process's launches (K3: the decode) and the ranks' (K1, K4)
        mh_launches = {k: w.launches for k, w in WRAPPERS.items()}
        for k, v in rank_launches.items():
            mh_launches[k] += v
        for ph in big["multihost_bigrun"]["phases"]:
            for r in ph.get("per_host", ()):
                for k in RANK_KERNELS:
                    mh_launches[k] += r["launches"][k]
        idle = [k for k in MULTIHOST_PATH_KERNELS if mh_launches[k] < 1]
        if idle:
            raise AssertionError(f"the multi-process path never launched "
                                 f"{idle}: {mh_launches}")
        mh_rec.update({"card": card, "phase_s": t1 - t0,
                       "big_runs_s": time.perf_counter() - t1,
                       "big_runs": big, "launches": mh_launches})
        emit({"multihost_path": mh_rec})

    # ---- the reference's parameter edges and corrupt streams -----------
    _, edge_launches = drive_edge_path(a.seed)

    # ---- the JAX package's XLA matchers, against K1, and their routes ---
    _, xla_launches = drive_xla_matcher_path(a.seed)

    paths = (launches, m_launches, cli_launches, *conf_launches.values(),
             probe_launches, sh_launches, ex_launches, mh_launches,
             edge_launches, xla_launches)
    kernels = []
    for rec in (rec1, rec2, rec3, rec4, rec5, rec6, *xrecs):
        name = rec["kernel"]
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_INFO[name][0],
            "replaces": KERNEL_INFO[name][1],
            # launches over every driven path together
            "launches": sum(path[name] for path in paths),
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": max(rec["bytes_ms"], rec["ops_ms"]),
            "bound_by": ("bytes" if rec["bytes_ms"] >= rec["ops_ms"]
                         else "operations"),
            "library_ms": None,
            **({"bound_note": rec["bound_note"]} if "bound_note" in rec
               else {}),
        })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
