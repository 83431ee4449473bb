"""Profiling hooks (torch.profiler) — SURVEY.md §5 'tracing/profiling: none'
in the reference; ``--profile DIR`` on the CLI captures a real trace, and
:func:`annotate` names a region in it.
"""

from __future__ import annotations

import contextlib
import json
import os
import time


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Capture a torch.profiler trace when ``log_dir`` is set.

    Host activity always, device activity when a CUDA device is present.
    On exit ``log_dir`` holds ``trace.json`` (Chrome trace format),
    ``key_averages.txt`` (time by operator and kernel name) and
    ``key_averages.json`` (the same as rows of name, calls, self host and
    self device microseconds and whether the row is a device activity — a
    kernel or a copy; a host operator's device time is that of the
    activities it started, so sums take device rows only — and ``wall_us``
    of the traced region).  The trace opens with one fill of one element
    on the device, outside ``wall_us``: CUPTI may drop the first device
    activities of a trace, and without it those were the region's own.
    """
    if not log_dir:
        yield
        return
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        if torch.cuda.is_available():
            # the device's first activities after the start can be lost
            # from the trace: spend them on a one-element fill first
            torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    avgs = prof.key_averages()
    with open(os.path.join(log_dir, "key_averages.txt"), "w") as f:
        f.write(avgs.table(row_limit=50))
    rows = [
        {
            "name": e.key, "calls": e.count,
            "on_device": e.device_type == DeviceType.CUDA,
            "self_host_us": e.self_cpu_time_total,
            # the attribute was renamed from cuda to device across releases
            "self_device_us": getattr(
                e, "self_device_time_total",
                getattr(e, "self_cuda_time_total", 0),
            ),
        }
        for e in avgs
    ]
    with open(os.path.join(log_dir, "key_averages.json"), "w") as f:
        json.dump({"wall_us": wall_us, "rows": rows}, f)


@contextlib.contextmanager
def annotate(name: str):
    """A named region in the profiler's timeline
    (``torch.profiler.record_function``); costs next to nothing when no
    profiler runs.  Unlike the JAX package's, it lets any error through."""
    import torch

    with torch.profiler.record_function(name):
        yield
