"""The program's own spans in the traced window, and the card's idle time
inside them.

Under a profiler each compress call's ``EncodeStats`` carries ``spans``:
tuples ``(name, t0_ns, t1_ns)`` on the clock of the
profiler's events (the fused encode's ``encode.stage``, ``encode.upload``,
``encode.launch``, ``encode.wait``, ``encode.fetch`` and
``encode.assemble``).  They are read by attribute: nothing of the program
is imported, and a program without them gives every reader None.

A compress call is paired with its benchmark span by ``Span.call``, the
call's index in ``run.calls``.  Where a program span lies outside its
call's benchmark span by more than ``SLACK_NS`` the two clocks do not
agree, and every reader gives None.
"""

from __future__ import annotations

import bisect

SLACK_NS = 200_000
MIB = 1 << 20
# the spans whose card idle time is read on its own; idle inside a compress
# call but in none of them (the wait, the Python between spans) is "other"
IDLE_PARTS = {
    "stage": ("encode.stage",),
    "copy": ("encode.upload", "encode.fetch"),
    "launch": ("encode.launch",),
    "assemble": ("encode.assemble",),
}


def compress_calls(run):
    """``[(call, benchmark span, program spans)]`` for the traced window's
    compress calls that returned, or None where the run was not traced,
    no call carries a program span, or one lies outside its call."""
    if not run.view:
        return None
    out = []
    for s in run.view.spans_of("compress"):
        c = run.calls[s.call]
        if c.error is not None:
            continue
        ps = list(getattr(c.stats, "spans", None) or ())
        for _, t0, t1 in ps:
            if t0 < s.t0 - SLACK_NS or t1 > s.t1 + SLACK_NS:
                return None
        out.append((c, s, ps))
    if not any(ps for _, _, ps in out):
        return None
    return out


def merged(intervals) -> list[tuple[int, int]]:
    """The union of ``(t0, t1)`` intervals as sorted, disjoint ones."""
    out = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def busy_pieces(view) -> list[tuple[int, int]]:
    """The window's device activity as sorted, disjoint intervals."""
    return merged((max(o.t0, view.t0), min(o.t1, view.t1))
                  for o in view.ops)


def idle_ns(busy, intervals) -> int:
    """Card idle inside ``intervals``: the wall of their union less the
    device busy time inside it (``busy`` from :func:`busy_pieces`).  The
    same as the wall less ``trace.busy_ns(view, clip=intervals)``, in
    one pass over sorted lists."""
    starts = [a for a, _ in busy]
    wall = inside = 0
    for c0, c1 in merged(intervals):
        wall += c1 - c0
        k = max(0, bisect.bisect_right(starts, c0) - 1)
        while k < len(busy) and busy[k][0] < c1:
            a, b = busy[k]
            inside += max(0, min(b, c1) - max(a, c0))
            k += 1
    return wall - inside


def _mib(calls) -> float:
    return sum(c.nin for c, _, _ in calls) / MIB


def _part_intervals(calls, names):
    """The program spans named ``names``, each clipped to its call."""
    return [(max(t0, s.t0), min(t1, s.t1))
            for _, s, ps in calls for name, t0, t1 in ps
            if name in names]


def idle_ms_per_MiB(run, part: str):
    """Card idle in ms per MiB of compress input inside the spans of
    ``part`` (a key of ``IDLE_PARTS``), or, for ``"other"``, inside
    compress calls but in none of those spans: the five parts add up to
    the card's idle time inside compress calls."""
    calls = compress_calls(run)
    if not calls or not _mib(calls):
        return None
    busy = busy_pieces(run.view)
    if part == "other":
        ns = idle_ns(busy, [(s.t0, s.t1) for _, s, _ in calls]) - sum(
            idle_ns(busy, _part_intervals(calls, names))
            for names in IDLE_PARTS.values())
    else:
        ns = idle_ns(busy, _part_intervals(calls, IDLE_PARTS[part]))
    return ns / 1e6 / _mib(calls)


def ms_per_call(run, name: str):
    """Host wall of the spans named ``name``, the mean over compress
    calls, in ms."""
    calls = compress_calls(run)
    if not calls:
        return None
    return sum(t1 - t0 for _, _, ps in calls for n, t0, t1 in ps
               if n == name) / 1e6 / len(calls)
