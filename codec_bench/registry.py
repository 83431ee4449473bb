"""Find the benchmark's cells, configurations, traffic mixes and metric
readers by the names in ``BENCHMARK.json``.

Each is a file of its own: ``configs/<config>.json``,
``traffic/<traffic>.json`` and ``metrics/<metric>.py``.  A later change adds
a cell, a configuration, a mix or a metric by adding files and entries,
never by editing one that exists.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def benchmark(path: str | None = None) -> dict:
    with open(path or os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def _named(entries: list[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r}")


def cell(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(name: str, root: str = HERE) -> dict:
    with open(os.path.join(root, "configs", f"{name}.json")) as f:
        return json.load(f)


def traffic(name: str, root: str = HERE) -> dict:
    with open(os.path.join(root, "traffic", f"{name}.json")) as f:
        return json.load(f)


def _reported(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def end_to_end(bench: dict, cell_name: str) -> list[dict]:
    """The end-to-end metrics the cell reports (``--trace 0``)."""
    return [m for m in bench["end_to_end"] if _reported(m, cell_name)]


def per_layer(bench: dict, cell_name: str) -> list[dict]:
    """The per-layer metrics the cell reports (``--trace 1``)."""
    return [m for m in bench["per_layer"] if _reported(m, cell_name)]


def reader(name: str, root: str = HERE):
    """The module ``metrics/<name>.py``: its ``read(run)`` gives the
    metric's value, or None where the run has nothing to read."""
    path = os.path.join(root, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "codec_bench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def peaks(kind: str, root: str = HERE) -> dict | None:
    """The published peaks of the device ``kind`` (``peaks.json``)."""
    with open(os.path.join(root, "peaks.json")) as f:
        return json.load(f).get(kind)
