"""One run of a cell: set-up, warm-up, the measured window, and what the
judge and the metric readers read afterwards.

The system under test is the program's public API, ``lz77_tpu_torch.
compress(data, la, sb)`` and ``decompress(stream)`` with their defaults;
``System`` binds it to a device, and the CPU tests hand in a broken one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time

import numpy as np

from . import pool as pool_lib
from . import trace as trace_lib
from . import traffic


class System:
    """``lz77_tpu_torch``'s ``compress`` / ``decompress`` on ``device``."""

    def __init__(self, device=None):
        import lz77_tpu_torch
        from lz77_tpu_torch.models.codec import EncodeStats

        self.lib = lz77_tpu_torch
        self.stats_type = EncodeStats
        self.device = device

    def stats(self):
        return self.stats_type()

    def compress(self, data: bytes, la: int, sb: int, stats) -> bytes:
        return self.lib.compress(data, la, sb, stats=stats,
                                 device=self.device)

    def decompress(self, stream: bytes) -> bytes:
        return self.lib.decompress(stream, device=self.device)


@dataclasses.dataclass
class Call:
    op: str
    item: int      # index into the deck
    t0: float      # host clock, s
    t1: float
    nin: int       # bytes handed to the call
    nout: int      # bytes it returned
    stats: object  # the program's EncodeStats of a compress call
    error: str | None = None


@dataclasses.dataclass
class Run:
    """What a run leaves for the judge and the metric readers."""
    cell: dict
    config: dict
    mix: dict
    seed: int
    pool: list[bytes]
    deck: list[traffic.Item]
    inputs: list[bytes]  # each deck item's bytes
    setup_s: float
    calls: list[Call]
    # streams of decompress items, made in set-up by the program
    streams: dict[int, bytes]
    # the first window answer of each compress item, judged by the reference
    first: dict[int, bytes]
    # further window answers kept by the seed: (item, stream)
    repeats: list[tuple[int, bytes]]
    # every decompress answer: (item, bytes)
    outputs: list[tuple[int, bytes]]
    view: trace_lib.View | None = None
    peaks: dict | None = None
    device_kind: str = ""

    def calls_of(self, op: str) -> list[Call]:
        return [c for c in self.calls if c.op == op and c.error is None]


def prepare(cell: dict, config: dict, mix: dict, seed: int, system: System,
            *, scale: int = 1) -> Run:
    """Make the pool and the deck from the seed, and warm up: every item is
    compressed once and every decompress item decompressed once, so every
    shape the window uses has run.  The streams of decompress items are
    kept for the window."""
    pool = pool_lib.make_pool(config["files"], seed, scale=scale)
    deck = traffic.deck(mix, config["files"], [len(p) for p in pool], seed)
    inputs = [pool[it.file] if it.size == len(pool[it.file])
              else pool[it.file][it.offset:it.offset + it.size]
              for it in deck]
    run = Run(cell, config, mix, seed, pool, deck, inputs, 0.0, [], {}, {},
              [], [])
    la, sb = config["la"], config["sb"]
    for i, it in enumerate(deck):
        stream = system.compress(inputs[i], la, sb, system.stats())
        if it.op == "decompress":
            run.streams[i] = stream
            system.decompress(stream)
    return run


def window(run: Run, system: System, seconds: float, *, traced: bool,
           start: float) -> None:
    """Cycle through the deck for ``seconds`` (whole calls or whole passes,
    as the mix says) and record every call.  ``start`` is the process's
    start on the host clock: ``setup_s`` runs from it to the window."""
    la, sb = run.config["la"], run.config["sb"]
    keep = np.random.default_rng([run.seed, 0x6B33]).random
    share = float(run.mix.get("keep_share", 0.0))
    by_round = run.mix.get("window_ends", "call") == "round"
    n = len(run.deck)
    gc.collect()
    with (trace_lib.profiled() if traced
          else contextlib.nullcontext()) as events:
        with (trace_lib.span(trace_lib.WINDOW) if traced
              else contextlib.nullcontext()):
            t_open = time.perf_counter()
            run.setup_s = t_open - start
            i = 0
            while True:
                now = time.perf_counter()
                if now - t_open >= seconds and (not by_round or i % n == 0):
                    break
                k = i % n
                it = run.deck[k]
                src = run.streams[k] if it.op == "decompress" \
                    else run.inputs[k]
                stats = system.stats() if it.op == "compress" else None
                err, out = None, b""
                with (trace_lib.span(f"bench.{it.op}#{i}") if traced
                      else contextlib.nullcontext()):
                    t0 = time.perf_counter()
                    try:
                        if it.op == "compress":
                            out = system.compress(src, la, sb, stats)
                        else:
                            out = system.decompress(src)
                    except Exception as e:  # a failed call is counted
                        err = f"{type(e).__name__}: {e}"
                    t1 = time.perf_counter()
                run.calls.append(Call(it.op, k, t0, t1, len(src), len(out),
                                      stats, err))
                if err is None:
                    if it.op == "decompress":
                        run.outputs.append((k, out))
                    elif k not in run.first:
                        run.first[k] = out
                    elif keep() < share:
                        run.repeats.append((k, out))
                i += 1
    if traced:
        run.view = trace_lib.view(events)
