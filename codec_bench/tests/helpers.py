"""Shared by the benchmark's tests: drive ``run.py``'s ``run_cell`` with a
given system, at a pool size a test can hold."""

import importlib.util
import os
import time

from codec_bench import registry

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_module():
    spec = importlib.util.spec_from_file_location(
        "codec_bench_run", os.path.join(HERE, "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_cell(cell_name, system, *, seed, scale, device="cpu", seconds=0.3,
             traced=False, deck=None):
    """One run of the cell at ``1/scale`` of its pool, as ``run.py`` would
    make it after its look for a card; ``deck`` shortens a blocks mix's
    deck."""
    bench = registry.benchmark()
    load = registry.traffic

    def traffic(name, root=registry.HERE):
        mix = load(name, root)
        if deck and mix["items"] == "blocks":
            mix["deck"] = deck
        return mix

    registry.traffic = traffic
    try:
        return run_module().run_cell(
            bench, registry.cell(bench, cell_name), seed, seconds, traced,
            system=system, device=device, start=time.perf_counter(),
            scale=scale)
    finally:
        registry.traffic = load
