#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py [--seed 0] [--text-mib 32] [--profile]

It builds the CUDA kernels from ``lz77_tpu_torch/csrc`` (first use), holds
every kernel against its plain PyTorch version on the card with tolerance 0
(all outputs are integers and bytes) at small shapes and at the main path's
shape, times both, and then drives the main path once: ``compress`` and
``decompress`` of word-salad text plus 4 MiB of zeros and 4 MiB of random
bytes at the reference defaults, checked byte for byte against the native
host codec.  Each phase prints one JSON line; any failed check raises and
the exit code is non-zero.  Without a CUDA device it exits non-zero at once:
nothing here runs on the CPU instead.

The default 32 MiB of text (40 MiB in all, five 8 MiB batches) is sized so
the whole script, builds included, ends well inside twenty minutes.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import lz77_tpu_torch as lt
from lz77_tpu_torch import _build, bitio, native, spec
from lz77_tpu_torch.models import codec
from lz77_tpu_torch.ops import decode_walk, match, parse_walk

HBM_BYTES_PER_S = 3.35e12
# Byte compares are integer ALU work outside the tensor cores.  Assumed peak:
# the data sheet's 67 TFLOP/s fp32 counts an FMA as two, on 128 lanes per
# SM; half of those lanes issue INT32, so 67e12 / 2 / 2 compares a second.
INT_OPS_PER_S = 67e12 / 4

WRAPPERS = {
    "match_kernel": match.match_sweep,
    "walk_parse_pack_kernel": parse_walk.walk_parse_pack,
    "walk_decode_kernel": decode_walk.walk_decode,
}
KERNEL_INFO = {
    "match_kernel": ("lz77_tpu_torch/csrc/match.cu",
                     "lz77_tpu/ops/pallas_bitplane.py:337"),
    "walk_parse_pack_kernel": ("lz77_tpu_torch/csrc/parse_walk.cu",
                               "lz77_tpu/ops/parse_walk.py:47"),
    "walk_decode_kernel": ("lz77_tpu_torch/csrc/decode_walk.cu",
                           "lz77_tpu/ops/decode_walk.py:62"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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

def check_match(name, x, g0, G, B, p, reps=0):
    """Kernel vs plain on one batch; returns the record (timed if reps)."""
    args, _ = batch_on_card(x, g0, G, B, p)
    L, O = match.match_sweep(*args, la=p.la, sb=p.sb)
    Lp, Op = match.match_sweep_plain(*args, la=p.la, sb=p.sb)
    torch.cuda.synchronize()
    err = max(max_err(L, Lp), max_err(O, Op))
    rec = {"kernel": "match_kernel", "case": name, "la": p.la, "sb": p.sb,
           "shape": [len(args[0]), B], "max_abs_err": err}
    if err != 0:
        raise AssertionError(f"match_kernel disagrees with plain: {rec}")
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
            ms=time_ms(lambda: match.match_sweep(*args, la=p.la, sb=p.sb), reps),
            plain_ms=time_ms(
                lambda: match.match_sweep_plain(*args, la=p.la, sb=p.sb), 1),
            bytes=nbytes, compares=ops,
            exhaustive_compares=int(dmax.sum()),
            bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            ops_ms=ops / INT_OPS_PER_S * 1e3,
        )
    return rec, (args, L, O)


# ---------------------------------------------------------------- K2 -----

def check_walk(name, args, L, O, vt, entry, p, sub_block, reps=0):
    blocks, _, rights = args[:3]
    N = blocks.numel()
    lox = parse_walk.build_lox(
        L.reshape(N), O.reshape(N), blocks.reshape(N), rights[-1], p.la)
    e = torch.tensor([entry], dtype=torch.int32, device="cuda")
    kw = dict(la=p.la, ob=p.off_bits, lb=p.len_bits)
    tok, cnt, ex = parse_walk.walk_parse_pack(lox, e, vt, sub_block=sub_block, **kw)
    tokp, cntp, exp = parse_walk.walk_parse_pack_plain(lox, e, vt, **kw)
    torch.cuda.synchronize()
    c = int(cnt)
    err = max(max_err(cnt, cntp), max_err(ex, exp), max_err(tok[:c], tokp[:c]))
    rec = {"kernel": "walk_parse_pack_kernel", "case": name, "la": p.la,
           "sb": p.sb, "span": N, "valid_total": vt, "entry": entry,
           "sub_block": sub_block, "tokens": c, "exit": int(ex),
           "max_abs_err": err}
    if err != 0:
        raise AssertionError(f"walk_parse_pack_kernel disagrees: {rec}")
    if reps:
        nbytes = lox.numel() * 4 + 4 + c * 4 + 8
        rec.update(
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

def check_decode(name, stream: bytes, data: bytes, reps=0, split=None):
    """Kernel vs plain on a stream's tokens; ``split`` decodes the tail of
    the token list primed with the head's output as history window."""
    _, off, ln, nxt = bitio.parse_stream(stream)
    toks = torch.from_numpy(decode_walk.pack_token_words(off, ln, nxt)).cuda()
    T = toks.shape[0]
    win, wp, want = None, 0, data
    if split is not None:
        head = int((ln[:split] + 1).sum())
        win = torch.frombuffer(bytearray(data[:head]), dtype=torch.uint8).cuda()
        wp, toks, T, want = head, toks[split:].contiguous(), T - split, data[head:]
    kw = dict(out_cap=len(want), win=win, wp=wp)
    out, cnt = decode_walk.walk_decode(toks, T, **kw)
    outp, cntp = decode_walk.walk_decode_plain(toks, T, **kw)
    torch.cuda.synchronize()
    err = max(max_err(out, outp), max_err(cnt, cntp))
    rec = {"kernel": "walk_decode_kernel", "case": name, "tokens": T,
           "out_bytes": len(want), "wp": wp, "max_abs_err": err}
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
        )
    return rec


def profile_main_path(data: bytes, stream: bytes):
    """Device time by kernel name over one more compress + decompress."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        lt.compress(data)
        lt.decompress(stream)
        torch.cuda.synchronize()
    rows = [
        (e.key, e.count, getattr(e, "device_time_total", 0) / 1e3)
        for e in prof.key_averages()
    ]
    rows = sorted((r for r in rows if r[2] > 0), key=lambda r: -r[2])
    return [{"name": k[:80], "calls": c, "device_ms": ms} for k, c, ms in rows[:30]]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--text-mib", type=int, default=32,
                    help="MiB of text in the main-path input (>= 8)")
    ap.add_argument("--profile", action="store_true",
                    help="also print the main path's device time by kernel")
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

    # K3 small: text, off=1/2/3 runs, widest window, priming window
    for name, d, p in (
        ("text", make_text(rng, 50000).tobytes(), p0),
        ("off1", bytes(20000), p0), ("off2", b"ab" * 10000, p0),
        ("off3", b"abc" * 7000, p0), ("one", b"A", p0),
        ("far_offsets", far.tobytes(), spec.Params(15, 65535)),
    ):
        s = native.encode(d, p)
        checks.append(check_decode(name, s, d))
        T = spec.token_count(len(s) - 4, p.width)
        for k in {1, T // 3, T - 1} - {0, T}:
            checks.append(check_decode(f"{name}_primed_at_{k}", s, d, split=k))

    # main-path shapes: the second 8 MiB text batch; the whole stream
    G, B = codec.DEFAULT_BATCH_BLOCKS, codec.DEFAULT_BLOCK_SIZE
    rec1, (args, L, O) = check_match("main_path_batch", x, G, G, B, p0, reps=5)
    rec2 = check_walk("main_path_batch", args, L, O, G * B, 0, p0,
                      parse_walk.DEFAULT_SUB_BLOCK, reps=10)
    del args, L, O
    ref_stream = native.encode(data, p0)
    rec3 = check_decode("main_path_stream", ref_stream, data, reps=3)
    checks += [rec1, rec2, rec3]
    emit({"kernel_checks": checks, "tolerance": 0})

    # ---- the main path, once, through the public entry points ----------
    for w in WRAPPERS.values():
        w.launches = 0
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
    launches = {k: w.launches for k, w in WRAPPERS.items()}
    peak = torch.cuda.max_memory_allocated()
    if stream != ref_stream:
        raise AssertionError("stream differs from native.encode")
    if back != data:
        raise AssertionError("decompress(compress(x)) != x")
    if native.decode(stream) != data:
        raise AssertionError("native.decode(stream) != x")
    batches = -(-st.blocks // G)
    if batches < min(4, -(-len(data) // (G * B))) \
            or any(v < 1 for v in launches.values()):
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

    if a.profile:
        emit({"profile": profile_main_path(data, stream)})

    kernels = []
    for rec in (rec1, rec2, rec3):
        name = rec["kernel"]
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_INFO[name][0],
            "replaces": KERNEL_INFO[name][1], "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": max(rec["bytes_ms"], rec["ops_ms"]),
            "bound_by": ("bytes" if rec["bytes_ms"] >= rec["ops_ms"]
                         else "operations"),
            "library_ms": None,
        })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
