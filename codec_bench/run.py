#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 codec_bench/run.py --workload <cell> --seed <n> --seconds <s>
                               --trace <0|1> [--control half-window]

Makes the cell's inputs from ``--seed``, warms up every shape the window
uses, measures for ``--seconds`` (whole calls, or whole passes over the
deck where the mix says so), judges every answer of the window against the
plain reference (``judge.py``) and prints one JSON line last on standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics), ``device``
(and with ``--trace 1`` ``breakdown``), then ``card``, ``judged`` and, last,
``checks``: each number compared, with its limit.  The same numbers close
standard error.

It exits with a code other than 0, and prints no result, without a CUDA
card (or with fewer than the cell asks for), or when ``jax``, ``jaxlib``,
``flax`` or ``lz77_tpu`` is loaded once the window has closed.
``--control`` runs the control (``controls.py``), which has to come out
not correct; the benchmark's own runs never pass it.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
if REPO not in sys.path:
    sys.path.insert(0, REPO)

FORBIDDEN = ("jax", "jaxlib", "flax", "lz77_tpu")


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout.
    The program builds its kernels into ``build/lz77_tpu_torch``; these
    hold anything PyTorch or Triton would compile."""
    base = os.path.join(REPO, "build", "codec_bench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card() -> dict | None:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        return None
    name, _, limit = out.splitlines()[0].rpartition(",") if out else ("",
                                                                      "", "")
    return {"name": name.strip(), "power_limit": limit.strip()}


def run_cell(bench: dict, cell: dict, seed: int, seconds: float,
             traced: bool, *, system, device: str, start: float,
             scale: int = 1) -> dict:
    """One run of ``cell`` against ``system``; returns the result line's
    object.  ``scale`` divides the pool's sizes (the CPU tests' runs)."""
    import torch

    from codec_bench import judge, registry, runner

    config = registry.config(cell["config"])
    mix = registry.traffic(cell["traffic"])
    on_card = torch.device(device).type == "cuda"
    run = runner.prepare(cell, config, mix, seed, system, scale=scale)
    if on_card:
        torch.cuda.synchronize()
    runner.window(run, system, seconds, traced=traced, start=start)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    run.device_kind = kind
    run.peaks = registry.peaks(kind)

    wanted = registry.per_layer(bench, cell["name"]) if traced \
        else registry.end_to_end(bench, cell["name"])
    metrics = {}
    for m in wanted:
        value = registry.reader(m["name"]).read(run)
        if value is None:
            if not traced:
                raise RuntimeError(f"{m['name']}: the run has nothing to read")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind,
           "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": False, "attempted": len(run.calls),
              "failed": sum(c.error is not None for c in run.calls),
              "metrics": metrics, "device": dev}
    if traced:
        from codec_bench import trace

        dev["busy_s"] = trace.busy_ns(run.view) / 1e9
        dev["window_s"] = run.view.window_ns / 1e9
        names = [f["name"] for f in config["files"]]

        def label(s):
            return f"{s.op}:{names[run.deck[run.calls[s.call].item].file]}"

        result["breakdown"] = trace.breakdown(run.view, label)
        run.view = None
    for c in run.calls:
        if c.error:
            print(f"failed call: {c.op} of item {c.item}: {c.error}",
                  file=sys.stderr)
            break

    # the reference runs once the window's state is freed
    if on_card:
        torch.cuda.empty_cache()
    checks, judged = judge.judge(run, device)
    result["correct"] = judge.correct(checks)
    result["card"] = card() if on_card else None
    result["judged"] = judged
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None)
    args = ap.parse_args(argv)
    _caches()

    import torch

    from codec_bench import controls, registry, runner

    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    system = runner.System("cuda")
    if args.control:
        system = controls.CONTROLS[args.control](system)
    result = run_cell(bench, cell, args.seed, args.seconds,
                      bool(args.trace), system=system, device="cuda",
                      start=START)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
