"""The port's XLA matchers (``brute``, ``sorted``, ``chunked``, ``bitplane``
and the ranged forms) against the JAX package's functions, tolerance 0.

The JAX oracle is the function of the same name where its CPU compile is
cheap: ``sorted`` at la <= 34 (it unrolls a multi-key sort a k), ``chunked``,
both ranged forms, and ``bitplane`` at two shapes (each costs seconds to
compile: the ranged form once, the host pipeline once).  Everywhere else it
is ``find_matches_brute``: the JAX package's own tests hold its exact
matchers to one table (``tests/test_ops.py``, ``tests/test_bitplane.py``).
Inputs come from a seed through the pipeline's own batch staging, so the
first block sees the stream start (avail < H) and the last block ends the
data (valid_ext < B).  Every pipeline that takes a matcher name is driven
with the new names: the host pipeline (bytes and files, against the JAX
package's streams), the fused walk and scan, the sharded pipeline on a 2x2
CPU mesh, and two CPU ranks of the multi-process encode.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from lz77_tpu import spec as jax_spec
from lz77_tpu.models import codec as jax_codec
from lz77_tpu.ops import bitplane as jax_bitplane
from lz77_tpu.ops import match as jax_match
from lz77_tpu_torch import native, spec
from lz77_tpu_torch.models import codec, fused
from lz77_tpu_torch.ops import bitplane, fused_walk, match
from lz77_tpu_torch.parallel import distributed, sharded
from lz77_tpu_torch.parallel import mesh as mesh_lib
from lz77_tpu_torch.utils import profiling

from conftest import make_text

torch.set_num_threads(1)

XLA = ("brute", "sorted", "chunked", "bitplane")
B, G = 128, 3


def make_data(seed: int, n: int) -> bytes:
    """Text, then zeros, then random bytes, ``n`` in all."""
    rng = np.random.default_rng(seed)
    d = make_text(rng, n // 2) + bytes(n // 4)
    return d + rng.integers(0, 256, n - len(d), dtype=np.uint8).tobytes()


def batch(data: bytes, la: int, sb: int, blk: int = B):
    """Every block of ``data`` as one (G, blk) batch (numpy), as the
    pipelines stage it."""
    x = np.frombuffer(data, np.uint8)
    g = -(-len(data) // blk)
    p = spec.Params(la, sb)
    return codec._batch_inputs(x, len(data), 0, g, g, blk, p.d_limit,
                               p.len_limit)


def tensors(arrs):
    return [torch.from_numpy(np.asarray(a)) for a in arrs]


@functools.lru_cache(maxsize=None)
def jax_batch(fn, la, sb, **kw):
    return jax.jit(jax.vmap(functools.partial(fn, la=la, sb=sb, **kw)))


def jax_tables(fn, arrs, la, sb, **kw):
    L, O = jax_batch(fn, la, sb, **kw)(*arrs)
    return np.asarray(L), np.asarray(O)


def same(got, want) -> bool:
    return all(np.array_equal(np.asarray(g), w) for g, w in zip(got, want))


DATA = make_data(0, G * B - 37)  # the last block ends 37 bytes short


@pytest.mark.parametrize("sb", [1, 2, 3, 256, 4095])
@pytest.mark.parametrize("la", [2, 15, 255])
def test_every_matcher_equals_jax_brute_on_the_grid(la, sb):
    """The four matchers' (L, O) equal JAX's ``find_matches_brute``, at
    every grid point; the batch equals its blocks one at a time."""
    arrs = batch(DATA, la, sb)
    want = jax_tables(jax_match.find_matches_brute, arrs, la, sb)
    assert arrs[3][0] == 0 and arrs[4][-1] < B  # stream start, data end
    for name in XLA:
        fn = match.get_matcher(name)
        got = fn(*tensors(arrs), la=la, sb=sb)
        assert same([t.numpy() for t in got], want), name
        assert got[0].dtype == got[1].dtype == torch.int32
        for g in range(G):
            one = fn(*(t[g] for t in tensors(arrs)), la=la, sb=sb)
            assert same([t.numpy() for t in one],
                        [w[g] for w in want]), (name, g)


@pytest.mark.parametrize("name,la", [("sorted", 15), ("sorted", 34),
                                     ("chunked", 15), ("chunked", 255)])
def test_matchers_equal_the_jax_function_of_the_same_name(name, la):
    sb = 300
    arrs = batch(make_data(1, 700), la, sb)
    want = jax_tables(getattr(jax_match, f"find_matches_{name}"), arrs, la,
                      sb)
    got = match.get_matcher(name)(*tensors(arrs), la=la, sb=sb)
    assert same(got, want)


def test_sorted_at_the_stream_start_and_past_valid_ext():
    """Grams that reach into the zero halo before the stream start or into
    the zero padding past ``valid_ext`` never give a match there: runs of
    zeros at both ends, against JAX's brute."""
    data = bytes(40) + b"abcabcab" * 20 + bytes(29)
    for la, sb in ((15, 300), (255, 100)):
        arrs = batch(data, la, sb, blk=64)
        want = jax_tables(jax_match.find_matches_brute, arrs, la, sb)
        assert same(match.find_matches_sorted(*tensors(arrs), la=la, sb=sb),
                    want)


@pytest.mark.parametrize("n_win", [2, 3])
def test_brute_range_against_jax(n_win):
    la, sb = 15, 300
    arrs = batch(DATA, la, sb)
    dlim = spec.d_limit(sb)
    fn = jax.jit(jax.vmap(functools.partial(
        jax_match.find_matches_brute_range, la=la, sb=sb),
        in_axes=(0, 0, 0, 0, 0, None, None)))
    keys = []
    for d_lo, d_hi in sharded._win_ranges(dlim, n_win):
        L, O = match.find_matches_brute_range(*tensors(arrs), d_lo, d_hi,
                                              la=la, sb=sb)
        assert same((L, O), [np.asarray(t) for t in fn(*arrs, d_lo, d_hi)])
        keys.append(match.combine_key(L, O, dlim))
    full = match.find_matches_brute(*tensors(arrs), la=la, sb=sb)
    both = match.split_key(torch.stack(keys).amax(dim=0), dlim)
    assert same(both, [t.numpy() for t in full])
    # clamped as JAX clamps: below 1, above d_limit, an empty range
    for d_lo, d_hi in ((-5, 40), (250, 9999), (40, 10)):
        got = match.find_matches_brute_range(*tensors(arrs), d_lo, d_hi,
                                             la=la, sb=sb)
        assert same(got, [np.asarray(t) for t in fn(*arrs, d_lo, d_hi)])


@functools.lru_cache(maxsize=None)
def jax_bitplane_range(la, sb, span):
    return jax.jit(jax.vmap(functools.partial(
        jax_bitplane.find_matches_bitplane_range, la=la, sb=sb, span=span),
        in_axes=(0, 0, 0, 0, 0, None, None)))


@pytest.mark.parametrize("n_win", [2, 3])
def test_bitplane_range_against_jax(n_win):
    """Members of 32 distances (sb 60: both splits round up to one span),
    each against JAX's, combined to the unranged bitplane's table."""
    la, sb = 15, 60
    arrs = batch(DATA, la, sb)
    dlim = spec.d_limit(sb)
    span = -(-(-(-dlim // n_win)) // 32) * 32
    fn = jax_bitplane_range(la, sb, span)
    keys = []
    for w in range(n_win):
        d_lo = 1 + w * span
        d_hi = min(dlim + 1, d_lo + span)
        L, O = bitplane.find_matches_bitplane_range(
            *tensors(arrs), d_lo, d_hi, la=la, sb=sb, span=span)
        assert same((L, O), [np.asarray(t) for t in fn(*arrs, d_lo, d_hi)])
        keys.append(match.combine_key(L, O, dlim))
    full = bitplane.find_matches_bitplane(*tensors(arrs), la=la, sb=sb)
    both = match.split_key(torch.stack(keys).amax(dim=0), dlim)
    assert same(both, [t.numpy() for t in full])


def _error(fn, *args, **kw):
    with pytest.raises(ValueError) as e:
        fn(*args, **kw)
    return str(e.value)


def test_refusals_have_the_jax_texts():
    la, sb = 15, 60
    one = [a[0] for a in batch(DATA, la, sb)]
    for d_lo, span in ((2, 32), (1, 30), (33, 48)):
        assert _error(bitplane.find_matches_bitplane_range,
                      *tensors(one), d_lo, 61, la=la, sb=sb, span=span) == \
            _error(jax_bitplane.find_matches_bitplane_range, *one, d_lo, 61,
                   la=la, sb=sb, span=span)
    # a halo that is not d_limit long
    short = [one[0], one[1][1:], *one[2:]]
    for port_fn, jax_fn in (
            (match.find_matches_chunked, jax_match.find_matches_chunked),
            (bitplane.find_matches_bitplane,
             jax_bitplane.find_matches_bitplane)):
        assert _error(port_fn, *tensors(short), la=la, sb=sb) == \
            _error(jax_fn, *short, la=la, sb=sb)


def test_bitplane_covers_blocks_too_small_for_the_jax_one():
    """JAX's bitplane needs more words than lookahead levels (``nw >
    depth``, 128-word lanes); the port covers every block: at la 255 on
    64-byte blocks it equals JAX's brute where JAX's bitplane raises."""
    la, sb = 255, 40
    arrs = batch(DATA[:300], la, sb, blk=64)
    with pytest.raises(ValueError, match="block too small for bitplane"):
        jax_bitplane.find_matches_bitplane(*[a[0] for a in arrs], la=la,
                                           sb=sb)
    want = jax_tables(jax_match.find_matches_brute, arrs, la, sb)
    assert same(bitplane.find_matches_bitplane(*tensors(arrs), la=la, sb=sb),
                want)


HOST_DATA = make_data(2, 1500)


@pytest.mark.parametrize("name", XLA)
def test_host_pipeline_streams_equal_the_jax_package(name, tmp_path):
    p = spec.Params()
    kw = dict(block_size=512, batch_blocks=2)
    want = jax_codec.encode_bytes(HOST_DATA, jax_spec.Params(), matcher=name,
                                  **kw)
    assert codec.encode_bytes(HOST_DATA, p, pipeline="host", matcher=name,
                              device="cpu", **kw) == want
    src, out = tmp_path / "in", tmp_path / "out.lz"
    src.write_bytes(HOST_DATA)
    codec.encode_file(str(src), str(out), p, matcher=name, device="cpu", **kw)
    assert out.read_bytes() == want


def test_fused_walk_and_scan_take_a_matcher_and_merged_refuses_them():
    """The walk pipeline and the scan step (chained by the fused-walk
    tests' helper) take ``sorted``; K5 runs its own sweep and takes no
    matcher."""
    from test_torch_fused_walk import _step_stream
    data = make_data(3, 1800)
    p = spec.Params()
    want = native.encode(data, p)
    assert fused.encode_bytes_fused(data, p, block_size=600, matcher="sorted",
                                    device="cpu") == want
    assert _step_stream(fused.encode_batch_device, data, p, 600,
                        matcher="sorted") == want
    assert codec.encode_bytes(data, p, pipeline="fused", matcher="sorted",
                              block_size=600, device="cpu") == want
    with pytest.raises(TypeError, match="matcher"):
        fused_walk.encode_batch_sweepwalk(
            np.zeros((1, 8), np.uint8), np.zeros((1, 4095), np.uint8),
            np.zeros((1, 14), np.uint8), np.zeros(1, np.int32),
            np.full(1, 8, np.int32), 8, 0, la=15, sb=4095, matcher="sorted",
            device="cpu")


@pytest.mark.parametrize("name", ["bitplane", "brute"])
def test_sharded_2x2_on_the_window_axis(name):
    """The win axis runs the JAX package's ranged form for the name
    (``bitplane_range`` with 32-rounded spans, else ``brute_range``)."""
    data = make_data(4, 2000)
    p = spec.Params(15, 300)
    m = mesh_lib.make_mesh(2, 2, devices=["cpu"] * 4)
    assert sharded.encode_bytes_sharded(
        data, p, mesh=m, block_size=400, batch_blocks=2, matcher=name
    ) == native.encode(data, p)
    arrs = batch(data, p.la, p.sb, blk=400)
    got = sharded.sharded_match_fn(m, p, matcher=name)(*arrs)
    want = match.find_matches_brute(*tensors(arrs), la=p.la, sb=p.sb)
    assert same([t.numpy() for t in got], [t.numpy() for t in want])


def test_two_cpu_ranks_with_chunked(tmp_path):
    data = make_data(5, 3000)
    src, out = tmp_path / "in", tmp_path / "out.lz"
    src.write_bytes(data)
    reports = distributed.launch(
        ["-i", str(src), "-o", str(out), "--block-size", "512",
         "--batch-blocks", "2", "--matcher", "chunked", "--device", "cpu"],
        2, timeout=300)
    assert [r["rank"] for r in reports] == [0, 1]
    assert out.read_bytes() == native.encode(data)


def test_annotate_names_a_region_in_the_trace():
    from torch.profiler import ProfilerActivity, profile

    with profiling.annotate("outside_any_profiler"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.annotate("xla_matcher_region"):
            torch.ones(4).sum()
    assert "xla_matcher_region" in {e.key for e in prof.key_averages()}
    with pytest.raises(KeyError):  # no catch-all: errors go through
        with profiling.annotate("raises"):
            raise KeyError("x")
