"""The port's exact entry-carried sharded step against the JAX package's.

``lz77_tpu_torch.parallel.sharded.make_sharded_exact_step`` on CPU meshes
(its kernels run as their plain PyTorch versions) and
``lz77_tpu.parallel.sharded.make_sharded_exact_step`` on the JAX package's
virtual 8-device CPU mesh (``conftest.py``) take the same numpy batches,
made from a seed.  Tolerance 0: the five outputs are integers, and the
streams their tokens make are bytes.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lz77_tpu import spec as jax_spec
from lz77_tpu.models import codec as jax_codec
from lz77_tpu.parallel import mesh as jax_mesh
from lz77_tpu.parallel import sharded as jax_sharded
from lz77_tpu_torch import bitio, native, spec
from lz77_tpu_torch.models import codec
from lz77_tpu_torch.ops import match, parse_walk
from lz77_tpu_torch.parallel import mesh as mesh_lib
from lz77_tpu_torch.parallel import sharded

from conftest import make_text

torch.set_num_threads(1)

# (n_data, n_win, the JAX step's matcher), as tests/test_parallel.py runs
# the JAX step: its ranged form on a win axis is brute's
JAX_MESHES = [(8, 1, "sorted"), (4, 2, "brute")]


def cpu_mesh(n_data, n_win):
    return mesh_lib.make_mesh(n_data, n_win,
                              devices=["cpu"] * (n_data * n_win))


@functools.lru_cache(maxsize=None)
def jax_step(n_data, n_win, la, sb, matcher):
    """The JAX step, built once for each mesh, width and matcher (one
    compile for each batch shape)."""
    return jax_sharded.make_sharded_exact_step(
        jax_mesh.make_mesh(n_data, n_win), jax_spec.Params(la, sb),
        matcher=matcher)


def assert_same(want, got):
    """The JAX step's five outputs against the port's, tolerance 0."""
    assert len(got) == 5
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    assert got[4].shape == ()


def stream_of(batches, p):
    """The stream the steps' padded rows make: each row's first counts[g]
    tokens, in order."""
    chunks = []
    for off, ln, nxt, counts in batches:
        off, ln, nxt, counts = (t.numpy() for t in (off, ln, nxt, counts))
        chunks += [bitio.tokens_to_bits(off[g, : counts[g]], ln[g, : counts[g]],
                                        nxt[g, : counts[g]], p)
                   for g in range(counts.shape[0]) if counts[g]]
    return bitio.concat_token_bits(chunks, p)


def run_chained(data, p, n_data, n_win, B, G, jax_matcher):
    """Both steps over every batch of ``data``, staged as the JAX package's
    ``_encode_bytes_sharded_xla`` stages it (G rows, the last batch padded
    with empty ones), each from the exit of the batch before; every
    batch's outputs held against each other.  Returns (the port's padded
    rows by batch, the exit entries)."""
    x = np.frombuffer(data, np.uint8)
    n = x.shape[0]
    nblocks = -(-n // B)
    want_step = jax_step(n_data, n_win, p.la, p.sb, jax_matcher)
    step = sharded.make_sharded_exact_step(cpu_mesh(n_data, n_win), p)
    je, e = jnp.int32(0), 0
    batches, exits = [], []
    for g0 in range(0, nblocks, G):
        gn = min(G, nblocks - g0)
        arrs = codec._batch_inputs(x, n, g0, gn, G, B, p.d_limit,
                                   p.len_limit)
        want = want_step(*(jnp.asarray(a) for a in arrs), je)
        got = step(*arrs, e)
        assert_same(want, got)
        je, e = want[4], got[4]
        batches.append(got[:4])
        exits.append(int(e))
    return batches, exits


def one_batch(rng, p, B=512, G=8):
    """Eight consecutive 512-byte blocks of text with their halos and right
    extensions, the last block ending the input (as
    ``test_torch_sharded.py::test_pipeline_step_matches_jax`` builds it)."""
    x = np.frombuffer(make_text(rng, G * B), np.uint8)
    H, R = p.d_limit, p.len_limit
    halos = np.zeros((G, H), np.uint8)
    rights = np.zeros((G, R), np.uint8)
    for b in range(1, G):
        a = min(H, b * B)
        halos[b, H - a:] = x[b * B - a : b * B]
        rights[b - 1] = x[b * B : b * B + R]
    return (x.reshape(G, B).copy(), halos, rights,
            np.array([min(H, b * B) for b in range(G)], np.int32),
            np.array([B + R] * (G - 1) + [B], np.int32))


# ------------------------------------------------- one batch, both steps --

@pytest.mark.parametrize("entry0", [0, 3, 15 + 3, -1])
@pytest.mark.parametrize("n_data,n_win,jax_matcher", JAX_MESHES)
def test_same_batch_matches_jax(n_data, n_win, jax_matcher, entry0):
    """One batch through the JAX step and the port's with the default
    matcher (K1's plain version): all five outputs equal, from entries
    inside and outside [0, la).  At entry 0 the port's step also runs the
    JAX step's own matcher name; at entry -1 it takes tensors, the entry an
    int32 tensor."""
    p = spec.Params(15, 255)
    arrs = one_batch(np.random.default_rng(11), p)
    want = jax_step(n_data, n_win, 15, 255, jax_matcher)(
        *(jnp.asarray(a) for a in arrs), jnp.int32(entry0))
    m = cpu_mesh(n_data, n_win)
    got = sharded.make_sharded_exact_step(m, p)(*arrs, entry0)
    assert_same(want, got)
    assert int(got[3].sum()) > 0
    if entry0 == 0:
        assert_same(want, sharded.make_sharded_exact_step(
            m, p, matcher=jax_matcher)(*arrs, entry0))
    if entry0 == -1:
        assert_same(want, sharded.make_sharded_exact_step(m, p)(
            *(torch.from_numpy(a) for a in arrs),
            torch.tensor(entry0, dtype=torch.int32)))


# ------------------------------------- chained over batches (the JAX cases) --

@pytest.mark.parametrize("n_data,n_win,jax_matcher", JAX_MESHES)
def test_chained_text_gives_the_serial_stream(n_data, n_win, jax_matcher):
    """40,000 B of text at B 2048, G 8 (tests/test_parallel.py's first
    case): every batch equal to the JAX step's, and the stream the rows make
    equal to the JAX host pipeline's and to ``encode_bytes_sharded``'s."""
    data = make_text(np.random.default_rng(21), 40_000)
    p = spec.Params(15, 255)
    batches, _ = run_chained(data, p, n_data, n_win, 2048, 8, jax_matcher)
    s = stream_of(batches, p)
    assert s == jax_codec.encode_bytes(data, jax_spec.Params(15, 255),
                                       block_size=2048, batch_blocks=8,
                                       matcher="sorted")
    assert s == sharded.encode_bytes_sharded(
        data, p, mesh=cpu_mesh(n_data, n_win), block_size=2048,
        batch_blocks=8)
    assert native.decode(s) == data


def test_chained_ragged_and_empty():
    """33,123 B (a short last block, a last batch of one row and seven empty
    ones), and a batch with no valid byte at all (the empty input's case):
    the entry passes through, every row and count 0."""
    data = make_text(np.random.default_rng(22), 33_123)
    p = spec.Params(15, 255)
    batches, _ = run_chained(data, p, 8, 1, 2048, 8, "sorted")
    assert batches[-1][3].tolist() == [int(batches[-1][3][0])] + [0] * 7
    assert stream_of(batches, p) == native.encode(data, p)
    empty = codec._batch_inputs(np.zeros(0, np.uint8), 0, 0, 0, 8, 2048,
                                p.d_limit, p.len_limit)
    want = jax_step(8, 1, 15, 255, "sorted")(
        *(jnp.asarray(a) for a in empty), jnp.int32(5))
    got = sharded.make_sharded_exact_step(cpu_mesh(8, 1), p)(*empty, 5)
    assert_same(want, got)
    assert int(got[4]) == 5 and not got[0].any() and not got[3].any()


def test_chained_runs_carry_the_entry_across_blocks():
    """Runs-heavy data at B 1024 on 4x1 (tests/test_parallel.py's third
    case): tokens overhang block, shard and batch ends, so entries other
    than 0 cross them; every batch equal to the JAX step's."""
    rng = np.random.default_rng(23)
    data = (b"\x00" * 7000 + make_text(rng, 3000)) * 3
    p = spec.Params(15, 255)
    batches, exits = run_chained(data, p, 4, 1, 1024, 8, "sorted")
    assert any(exits[:-1])
    assert stream_of(batches, p) == native.encode(data, p)


def test_la255_sb255():
    """The deepest lookahead on a win axis (brute on the JAX side: its
    sorted matcher at la 255 takes minutes): a shard's tokens reach 254
    bytes into the next one."""
    rng = np.random.default_rng(24)
    data = (make_text(rng, 1500) * 2 + bytes(600)
            + rng.integers(0, 256, 400, dtype=np.uint8).tobytes())
    p = spec.Params(255, 255)
    batches, exits = run_chained(data, p, 4, 2, 1024, 4, "brute")
    assert stream_of(batches, p) == native.encode(data, p)


def test_20_bit_tokens():
    """``Params(8, 500)``: 9 offset bits, 3 length bits (20-bit tokens)."""
    data = make_text(np.random.default_rng(25), 9_000)
    p = spec.Params(8, 500)
    batches, _ = run_chained(data, p, 4, 2, 1024, 4, "brute")
    assert stream_of(batches, p) == native.encode(data, p)


# ---------------------------------------------------------- refusals ----

def test_refusals():
    p = spec.Params(15, 255)
    arrs = list(one_batch(np.random.default_rng(26), p))
    step = sharded.make_sharded_exact_step(cpu_mesh(4, 2), p)
    # a short row followed by a non-empty one: not a valid prefix
    gaps = arrs[:4] + [arrs[4].copy()]
    gaps[4][2] = 100
    with pytest.raises(ValueError, match="valid prefix"):
        step(*gaps, 0)
    # G that does not split over the data axis: the JAX package's text
    # (its match_fn's; its exact step leaves it to shard_map)
    with pytest.raises(ValueError,
                       match="batch_blocks=6 must be a multiple of "
                             "data-axis size 4"):
        step(*(a[:6] for a in arrs), 0)
    with pytest.raises(ValueError, match="evenly divisible"):
        jax_step(4, 2, 15, 255, "brute")(
            *(jnp.asarray(a[:6]) for a in arrs), jnp.int32(0))
    # K4 has no range of distances
    with pytest.raises(ValueError, match="chunk"):
        sharded.make_sharded_exact_step(cpu_mesh(4, 2), p, matcher="chunk")
    # a valid prefix with a short row and empty rows after it runs
    tail = arrs[:4] + [np.array([512] * 5 + [100, 0, 0], np.int32)]
    assert step(*tail, 0)[3][6:].tolist() == [0, 0]


@pytest.mark.parametrize("B,want", [(1 << 20, 4096), (2048, 2048),
                                    (12_000, 4000), (4099, 1), (1, 1)])
def test_exact_sub_block_divides_the_block(B, want):
    assert sharded.exact_sub_block(B) == want


# ------------------------------------------------- K2's sub-block return --

def _serial_walk(lox, entry, vt, sub_block, la):
    """A serial walk of the LOX words' chain: each sub-block's entry (its
    first token start less its own start) and token offset."""
    ln = ((lox.numpy().astype(np.int64) >> 16) & 0xFF)
    starts, p = [], entry
    while p < vt:
        starts.append(p)
        p += int(ln[p]) + 1
    starts = np.array(starts, np.int64)
    M = -(-vt // sub_block)
    entries, offsets = [], []
    for m in range(M):
        base = m * sub_block
        i = int(np.searchsorted(starts, base))
        offsets.append(i)
        entries.append(int(starts[i]) - base if i < len(starts)
                       else p - base)
    return np.array(entries), np.array(offsets), len(starts), p - vt


@pytest.mark.parametrize("la,sub_block,entry,cut", [
    (15, 64, 0, 0), (15, 1000, 3, 679), (255, 300, 200, 17), (2, 7, 1, 0),
    (15, 1, 14, 5)])
def test_walk_parse_pack_returns_its_sub_blocks(la, sub_block, entry, cut):
    """``walk_parse_pack(sub_blocks=True)`` on the CPU (the plain version's
    sub_block form): ``entries`` and ``offsets`` against a serial walk, the
    counts between offsets summing to the count, and the first three
    outputs those of the default return."""
    rng = np.random.default_rng(27)
    x = np.concatenate([np.frombuffer(make_text(rng, 2500), np.uint8),
                        np.zeros(600, np.uint8),
                        rng.integers(0, 4, 900, dtype=np.uint8)])
    p = spec.Params(la, 255)
    B = 1000
    arrs = codec._batch_inputs(x, x.shape[0], 0, 4, 4, B, p.d_limit,
                               p.len_limit)
    L, O = match.match_sweep(*(torch.from_numpy(a) for a in arrs), la=la,
                             sb=255)
    N = 4 * B
    lox = parse_walk.build_lox(L.reshape(N), O.reshape(N),
                               torch.from_numpy(arrs[0]).reshape(N),
                               torch.from_numpy(arrs[2][-1]), la)
    vt = N - cut
    e = torch.tensor([entry], dtype=torch.int32)
    kw = dict(la=la, ob=16, lb=8, sub_block=sub_block)
    tok, cnt, ex, entries, offsets = parse_walk.walk_parse_pack(
        lox, e, vt, sub_blocks=True, **kw)
    want_e, want_o, want_c, want_x = _serial_walk(lox, entry, vt, sub_block,
                                                  la)
    assert entries.dtype == offsets.dtype == torch.int32
    np.testing.assert_array_equal(entries.numpy(), want_e)
    np.testing.assert_array_equal(offsets.numpy(), want_o)
    assert int(cnt) == want_c and int(ex) == want_x
    assert int(torch.diff(offsets, append=cnt).sum()) + int(offsets[0]) \
        == int(cnt)
    t0, c0, x0 = parse_walk.walk_parse_pack(lox, e, vt, **kw)
    assert int(c0) == int(cnt) and int(x0) == int(ex)
    assert torch.equal(t0[: int(c0)], tok[: int(cnt)])
    with pytest.raises(ValueError, match="sub_block"):
        parse_walk.walk_parse_pack_plain(lox, e, vt, la=la, ob=16, lb=8,
                                         sub_blocks=True)
