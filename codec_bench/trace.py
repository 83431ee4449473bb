"""The traced window: torch.profiler held in memory, and the arithmetic of
device time, idle time and the breakdown.

The benchmark's own spans are ``record_function`` ranges around the window
(``bench.window``) and around each call (``bench.<op>#<i>``, ``i`` the
call's index).  Device activity is every kernel, copy and fill of the
profiler's device timeline, user annotations left out.  Busy time is the
union of those intervals, so work on several streams is not counted twice
(``lz77_tpu_torch/utils/profiling.py`` sums device rows, which equals the
union only on one stream).
"""

from __future__ import annotations

import contextlib
import dataclasses
import re

WINDOW = "bench.window"
_SPAN = re.compile(r"bench\.(\w+)#(\d+)$")


@dataclasses.dataclass
class Span:
    op: str
    call: int
    t0: int  # ns, the profiler's clock
    t1: int


@dataclasses.dataclass
class DeviceOp:
    name: str
    t0: int
    t1: int

    @property
    def copy(self) -> bool:
        return self.name.startswith("Memcpy")


@dataclasses.dataclass
class View:
    """One traced window: its bounds, the benchmark's call spans and the
    device operations that started inside it."""
    t0: int
    t1: int
    spans: list[Span]
    ops: list[DeviceOp]

    @property
    def window_ns(self) -> int:
        return self.t1 - self.t0

    def spans_of(self, op: str) -> list[Span]:
        return [s for s in self.spans if s.op == op]

    def ops_in(self, spans: list[Span]) -> list[DeviceOp]:
        """Device operations that started inside one of ``spans``.  A call
        returns only once its results are on the host, so every operation
        it launched ends inside its span."""
        bounds = sorted((s.t0, s.t1) for s in spans)
        out, k = [], 0
        for o in sorted(self.ops, key=lambda o: o.t0):
            while k < len(bounds) and bounds[k][1] < o.t0:
                k += 1
            if k < len(bounds) and bounds[k][0] <= o.t0:
                out.append(o)
        return out


def union_ns(intervals) -> int:
    """Length of the union of ``(t0, t1)`` intervals."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def busy_ns(view: View, clip=None) -> int:
    """Device busy time in the window, or inside the ``clip`` intervals."""
    iv = [(max(o.t0, view.t0), min(o.t1, view.t1)) for o in view.ops]
    iv = [(a, b) for a, b in iv if b > a]
    if clip is None:
        return union_ns(iv)
    out = []
    for c0, c1 in clip:
        out += [(max(a, c0), min(b, c1)) for a, b in iv if b > c0 and a < c1]
    return union_ns([(a, b) for a, b in out if b > a])


def idle_share(view: View) -> float:
    """Per cent of the window in which no device operation ran."""
    return 100.0 * (1.0 - busy_ns(view) / view.window_ns)


def kernel_ns(ops: list[DeviceOp], pattern: str) -> int:
    """Summed duration of the operations whose name matches ``pattern``."""
    rx = re.compile(pattern)
    return sum(o.t1 - o.t0 for o in ops if rx.search(o.name))


@contextlib.contextmanager
def profiled():
    """Profile the block on host and device; yields a list that holds the
    profiler's events once the block has ended."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    box = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # CUPTI may drop a trace's first device activities: spend them on
        # a one-element fill before the window opens
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        yield box
    box.extend(prof.profiler.kineto_results.events())


def span(name: str):
    import torch

    return torch.profiler.record_function(name)


def view(events) -> View:
    """The window of the profiler's ``events``."""
    from torch.autograd import DeviceType

    spans, ops, win = [], [], None
    for e in events:
        name = e.name()
        t0 = e.start_ns()
        t1 = t0 + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                ops.append(DeviceOp(name, t0, t1))
            continue
        if name == WINDOW:
            win = (t0, t1)
            continue
        m = _SPAN.match(name)
        if m:
            spans.append(Span(m.group(1), int(m.group(2)), t0, t1))
    if win is None:
        raise RuntimeError("the trace holds no window span")
    ops = [o for o in ops if win[0] <= o.t0 < win[1]]
    return View(win[0], win[1], sorted(spans, key=lambda s: s.t0), ops)


def short(name: str) -> str:
    """A kernel's name without its template and argument lists."""
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return name
    base = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", ""))
    return re.split(r"[<(]", base, maxsplit=1)[0].strip() or name


def breakdown(view: View, label, top: int = 10) -> dict:
    """The device operations that took the most time, by name, and the
    longest idle gaps, each named by ``label(span)`` of the benchmark span
    that covers most of it on the host ("between calls" where the host was
    between calls for most of it)."""
    by = {}
    for o in view.ops:
        k = short(o.name)
        by[k] = by.get(k, 0) + (o.t1 - o.t0)
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    gaps, end = [], view.t0
    for a, b in sorted((max(o.t0, view.t0), min(o.t1, view.t1))
                       for o in view.ops):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if view.t1 > end:
        gaps.append((end, view.t1))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    starts = [s.t0 for s in view.spans]
    named = []
    for g0, g1 in gaps:
        best, cover = None, 0
        for s in view.spans[max(0, _last_le(starts, g0)):]:
            if s.t0 >= g1:
                break
            c = min(s.t1, g1) - max(s.t0, g0)
            if c > cover:
                best, cover = s, c
        name = label(best) if best and 2 * cover > g1 - g0 \
            else "between calls"
        named.append([name, (g1 - g0) / 1e9])
    return {"device_ops": [[k, v / 1e9] for k, v in ops],
            "idle_gaps": named}


def _last_le(xs, v) -> int:
    lo, hi = 0, len(xs)
    while lo < hi:
        mid = (lo + hi) // 2
        if xs[mid] <= v:
            lo = mid + 1
        else:
            hi = mid
    return lo - 1
