"""K1's wide-window route (``ops.match.match_chain_plain``, the steps of
``csrc/match_chain.cu``) against the sweep's plain version and the JAX
package's brute matcher, and the rule that routes a call to it.

The route must give the sweep's (L, O) exactly: the longest run, the
nearest distance on ties.  Tolerance 0 (integer tables).  The JAX brute
matcher takes tens of seconds a call at la 255, so it checks la 5 and 15;
``match_sweep_plain`` (held against it in ``test_torch_match.py``) checks
the rest.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lz77_tpu import spec
from lz77_tpu.ops import match as jax_match
from lz77_tpu_torch import _build, native
from lz77_tpu_torch import spec as torch_spec
from lz77_tpu_torch.models import codec
from lz77_tpu_torch.ops import match

from conftest import make_text

torch.set_num_threads(1)


def _batch(x: np.ndarray, starts, B: int, la: int, sb: int):
    """(G, B) batch inputs of the blocks at ``starts``, torch on the CPU."""
    p = spec.Params(la=la, sb=sb)
    n, H, R = x.shape[0], p.d_limit, p.len_limit
    rows = [[], [], [], [], []]
    for start in starts:
        block = np.zeros(B, np.uint8)
        seg = x[start : min(start + B, n)]
        block[: seg.shape[0]] = seg
        halo = np.zeros(H, np.uint8)
        a = min(H, start)
        if a:
            halo[H - a :] = x[start - a : start]
        right = np.zeros(R, np.uint8)
        rseg = x[start + B : min(start + B + R, n)]
        right[: rseg.shape[0]] = rseg
        for r, v in zip(rows, (block, halo, right, a, min(B + R, n - start))):
            r.append(v)
    dtypes = (torch.uint8,) * 3 + (torch.int32,) * 2
    return [torch.as_tensor(np.asarray(r)).to(d)
            for r, d in zip(rows, dtypes)]


def _records(rng, n: int) -> np.ndarray:
    """Records-like text: fixed field names, short numbers and codes."""
    parts = []
    while sum(len(s) for s in parts) < n:
        parts.append(b"id=%d;code=%s;qty=%d;flag=%s\n" % (
            rng.integers(0, 400), bytes(rng.integers(65, 70, 3,
                                                     dtype=np.uint8)),
            rng.integers(0, 9), b"YN"[rng.integers(0, 2):][:1]))
    return np.frombuffer(b"".join(parts)[:n], np.uint8)


def _input(kind: str, n: int = 1200) -> np.ndarray:
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == "zeros":
        return np.zeros(n, np.uint8)
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8)
    if kind.startswith("period"):
        k = int(kind[6:])
        return np.resize(rng.integers(0, 256, k, dtype=np.uint8), n)
    if kind == "records":
        return _records(rng, n)
    if kind == "text":
        return np.frombuffer(make_text(rng, n), np.uint8)
    # two letters: every 4-gram comes back every 16 bytes or so, runs are
    # short, so walks are long and a small budget is passed
    return rng.integers(0, 2, n, dtype=np.uint8) + ord("a")


KINDS = ("zeros", "random", "period1", "period2", "period3", "period4",
         "period5", "period6", "period7", "records", "two_letters")
WINDOWS = (16384, 32767, 65535)
LAS = (2, 3, 4, 5, 15, 255)


def _check(args, la, sb, want, budgets=(None, 0, 2)):
    """The route's plain version at each budget gives ``want``; returns its
    counters at the last budget."""
    for budget in budgets:
        c = match.new_counters("cpu")
        got = match.match_chain_plain(*args, la=la, sb=sb, budget=budget,
                                      counters=c)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), w.numpy())
    return c.tolist()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("i", range(len(LAS)))
def test_route_equals_the_sweep(kind, i):
    """Every la at a window in turn: two blocks from the stream start
    (avail 0, then avail < H) whose second one ends the data (valid_ext
    inside it), at the default budget and at budgets 0 and 2."""
    la, sb = LAS[i], WINDOWS[(i + KINDS.index(kind)) % 3]
    args = _batch(_input(kind), (0, 700), 700, la, sb)
    want = match.match_sweep_plain(*args, la=la, sb=sb)
    walked, hops, fell = _check(args, la, sb, want)
    assert hops <= 2 * walked and fell <= walked
    if torch_spec.len_limit(la) < 4:
        assert walked == 0  # a cap below 4 takes the short runs alone


def test_route_with_the_whole_window():
    """A block whose halo is whole (avail = H) at sb 16385, text with a
    repeat farther back than the block, and runs."""
    rng = np.random.default_rng(7)
    t = np.frombuffer(make_text(rng, 9000), np.uint8)
    x = np.concatenate([t, _input("two_letters", 7000), np.zeros(400,
                       np.uint8), t[:1000], _input("records", 600)])
    args = _batch(x, (16900,), 500, 15, 16385)
    assert int(args[3][0]) == 16385
    want = match.match_sweep_plain(*args, la=15, sb=16385)
    _check(args, 15, 16385, want)


def test_budget_fallback_on_equal_grams():
    """Two letters make every walk long: at budget 3 most walks pass it
    and sweep the rest, and the tables stay the sweep's."""
    args = _batch(_input("two_letters", 2000), (0, 1000), 1000, 255, 32767)
    want = match.match_sweep_plain(*args, la=255, sb=32767)
    walked, hops, fell = _check(args, 255, 32767, want, budgets=(None, 3))
    assert fell > walked // 2 and hops <= 3 * walked


@pytest.mark.parametrize("la,sb,kind", [
    (15, 16385, "records"), (5, 32767, "two_letters"), (15, 65535, "text"),
])
def test_route_equals_jax_brute(la, sb, kind):
    """The JAX package's brute matcher on one block from the stream
    start whose data ends inside it."""
    x = _input(kind, 900)
    args = _batch(x, (0,), 1024, la, sb)
    ref = jax.jit(jax_match.find_matches_brute, static_argnames=("la", "sb"))(
        *(jnp.asarray(a[0].numpy()) for a in args), la=la, sb=sb)
    got = match.match_chain_plain(*args, la=la, sb=sb, budget=2)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(r))


# ---------------------------------------------------------- the routing --

def test_route_depends_only_on_the_window_and_the_range():
    assert match.CHAIN_MIN_DLIM == 16384
    assert not match.takes_chain(16383)
    assert match.takes_chain(16384) and match.takes_chain(65535)
    assert match.takes_chain(32767, 1, None) and match.takes_chain(
        32767, 0, 40000)
    # a ranged call (the sharded window axis) sweeps at any window
    assert not match.takes_chain(65535, 1, 30000)
    assert not match.takes_chain(65535, 2, None)
    assert not match.takes_chain(4095)


@pytest.mark.parametrize("sb,d_lo,d_hi,route", [
    (16384, 1, None, "sweep"),      # d_limit 16,383
    (16385, 1, None, "chain"),
    (65535, 1, None, "chain"),
    (65535, 1, 65535, "sweep"),     # ranged: the last distance left out
    (65535, 3, None, "sweep"),
    (4095, 1, None, "sweep"),
])
def test_match_sweep_routes_cpu_calls(sb, d_lo, d_hi, route, monkeypatch):
    """``match_sweep`` on CPU tensors runs the plain version of the route
    ``takes_chain`` names, and passes the counters to the walk only."""
    seen = []
    monkeypatch.setattr(match, "match_chain_plain",
                        lambda *a, counters=None, **k: seen.append(
                            ("chain", counters)) or (a[0], a[0]))
    monkeypatch.setattr(match, "match_sweep_plain",
                        lambda *a, **k: seen.append(("sweep", None))
                        or (a[0], a[0]))
    args = _batch(_input("text", 300), (0,), 300, 15, sb)
    c = match.new_counters("cpu")
    match.match_sweep(*args, la=15, sb=sb, d_lo=d_lo, d_hi=d_hi, counters=c)
    assert [s[0] for s in seen] == [route]
    assert (seen[0][1] is c) == (route == "chain")


def test_every_kernel_of_the_route_reads_as_match_kernel():
    """Each ``__global__`` of ``csrc/match_chain.cu`` is ``match_kernel``
    in a namespace of its own, so the benchmark's ``\\bmatch_kernel\\b``
    counts the pre-pass in the match layer (and not in parse + pack)."""
    with open(os.path.join(_build.CSRC, "match_chain.cu")) as f:
        src = f.read()
    assert "match_chain.cu" in _build.KERNEL_SOURCES
    kernels = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                         r"\s+)?(\w+)\s*\(", src)
    spaces = re.findall(r"namespace (\w+) \{", src)
    assert len(kernels) == 7 and set(kernels) == {"match_kernel"}
    assert {"grams", "hist", "scan", "scatter", "links", "walk",
            "rest"} <= set(spaces)
    for ns in spaces:
        assert re.search(r"\bmatch_kernel\b", f"void {ns}::match_kernel(int)")


# ------------------------------------------------- the pipeline's counts --

def test_compress_counts_the_walk():
    """``compress`` at DEFLATE's window keeps the route's counts in its
    stats, as the plain version counts them, and the stream is the native
    encoder's; at the default window nothing is walked."""
    rng = np.random.default_rng(11)
    data = make_text(rng, 3000) + bytes(_input("two_letters", 1500))
    p = torch_spec.Params(255, 32767)
    st = codec.EncodeStats()
    import lz77_tpu_torch

    s = lz77_tpu_torch.compress(data, 255, 32767, stats=st, device="cpu")
    assert s == native.encode(data, p)
    x = np.frombuffer(data, np.uint8)
    args = _batch(x, (0,), len(data), 255, 32767)
    c = match.new_counters("cpu")
    match.match_chain_plain(*args, la=255, sb=32767, counters=c)
    assert [st.match_positions, st.match_hops, st.match_fallbacks] \
        == c.tolist()
    assert st.match_positions > 0
    st0 = codec.EncodeStats()
    lz77_tpu_torch.compress(data, stats=st0, device="cpu")
    assert st0.match_positions == st0.match_hops == 0
