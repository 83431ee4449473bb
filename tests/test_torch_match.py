"""Port matcher (lz77_tpu_torch.ops.match) against the JAX package's.

The same numpy inputs, made from a seed, go through
``lz77_tpu.ops.match.find_matches_brute`` and the port's ``find_matches``
(on the CPU, so through the kernel's plain PyTorch version).  Tolerance 0:
both tables are integers.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lz77_tpu import spec
from lz77_tpu.ops import match as jax_match
from lz77_tpu_torch import _build
from lz77_tpu_torch.ops import match as torch_match

from conftest import make_text

torch.set_num_threads(1)


def _block_inputs(x: np.ndarray, start: int, B: int, p: spec.Params):
    """block/halo/right/avail/valid_ext of the block at ``start``, numpy."""
    n = x.shape[0]
    H, R = p.d_limit, p.len_limit
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
    return block, halo, right, np.int32(a), np.int32(min(B + R, n - start))


def _both(args, la, sb, find=jax_match.find_matches_brute):
    ref = jax.jit(find, static_argnames=("la", "sb"))(
        *(jnp.asarray(a) for a in args), la=la, sb=sb
    )
    got = torch_match.find_matches(*args, la=la, sb=sb, device="cpu")
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


def _assert_same(ref, got):
    for r, g in zip(ref, got):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, r)


def _data(rng):
    return np.frombuffer(
        make_text(rng, 700) + bytes(rng.integers(0, 4, 300, dtype=np.uint8)),
        np.uint8,
    )


@pytest.mark.parametrize(
    "la,sb",
    [(15, 100), (15, 1025), (4, 7), (17, 33), (255, 255), (15, 64), (2, 3),
     (15, 1)],
)
def test_find_matches_against_brute(la, sb, rng):
    """Block at the stream start: avail = 0 < H, so every distance is gated
    by ``d <= p``.  (15, 64) is a degenerate sb (d_limit = 63); (15, 1) has
    d_limit = 0 and (2, 3) depth 1."""
    p = spec.Params(la=la, sb=sb)
    x = _data(rng)
    _assert_same(*_both(_block_inputs(x, 0, x.shape[0], p), la, sb))


@pytest.mark.parametrize("start,B", [(512, 512), (100, 300), (700, 512)])
def test_find_matches_block_invariance(start, B, rng):
    """Mid-stream blocks: short halo (avail < H at start 100), and a block
    that runs past the end of the data (valid_ext inside the block)."""
    p = spec.Params(la=15, sb=255)
    x = _data(rng)
    _assert_same(*_both(_block_inputs(x, start, B, p), 15, 255))


def test_find_matches_widest_window(rng):
    """la=129, sb=65535 (32-bit tokens): the halo is longer than the data.
    The JAX side runs its chunked matcher (same contract; its brute sweep
    takes 65535 sequential steps here)."""
    p = spec.Params(la=129, sb=65535)
    x = np.concatenate([_data(rng), _data(rng)[:600]])
    _assert_same(*_both(
        _block_inputs(x, 0, x.shape[0], p), 129, 65535,
        find=jax_match.find_matches_chunked,
    ))


def test_find_matches_batch_equals_blocks(rng):
    """A (G, B) batch gives what the G blocks give one by one (the batch
    dimension written out is the JAX package's vmap)."""
    p = spec.Params(la=15, sb=100)
    x = _data(rng)
    B = 256
    per = [_block_inputs(x, g * B, B, p) for g in range(4)]
    batch = [np.stack([b[i] for b in per]) for i in range(5)]
    L, O = torch_match.find_matches(*batch, la=15, sb=100, device="cpu")
    assert L.shape == (4, B) and L.dtype == torch.int32
    for g in range(4):
        ref, _ = _both(per[g], 15, 100)
        np.testing.assert_array_equal(L[g].numpy(), ref[0])
        np.testing.assert_array_equal(O[g].numpy(), ref[1])


def test_find_matches_rejects_wrong_halo():
    with pytest.raises(ValueError, match="halos"):
        torch_match.find_matches(
            np.zeros(8, np.uint8), np.zeros(5, np.uint8),
            np.zeros(14, np.uint8), 0, 8, la=15, sb=100, device="cpu",
        )


# (la, sb, start, B): block starts and lengths at every residue mod 4, so
# every alignment phase of the kernel's word grid appears; starts 0..3 put
# the stream start (avail 0) and dmax in mid-word; blocks that run past the
# end of the data have valid_ext inside the block.
WORD_CASES = [
    (15, 31, 0, 300), (15, 31, 1, 301), (15, 31, 2, 302), (15, 31, 3, 303),
    (2, 3, 0, 97), (2, 3, 5, 98), (2, 31, 6, 99),
    (255, 31, 7, 400), (255, 4096, 401, 399),
    (15, 4096, 700, 257), (15, 4096, 902, 255),
    (15, 65535, 2, 301), (255, 65535, 9, 302),
]


@pytest.mark.parametrize("la,sb,start,B", WORD_CASES)
def test_match_words_plain_against_sweep_and_brute(la, sb, start, B, rng):
    """``match_sweep_words_plain`` (the kernel's four-distances-a-word
    decomposition: phases, edge masks, the filter a step, the exit at the
    cap) gives the sweep's plain version's tables and the JAX package's."""
    p = spec.Params(la=la, sb=sb)
    x = _data(rng)
    args = _block_inputs(x, start, B, p)
    find = (jax_match.find_matches_chunked if sb > 4096
            else jax_match.find_matches_brute)
    ref, _ = _both(args, la, sb, find=find)
    t = [torch.as_tensor(np.asarray(a))[None] for a in args]
    got = torch_match.match_sweep_words_plain(*t, la=la, sb=sb)
    plain = torch_match.match_sweep_plain(*t, la=la, sb=sb)
    for r, g, q in zip(ref, got, plain):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g[0].numpy(), r)
        np.testing.assert_array_equal(g.numpy(), q.numpy())


def test_match_words_plain_batch_of_phases(rng):
    """A batch whose blocks start at every residue mod 4 of the stream,
    with avail from 0 through mid-word to the full halo, on runs (the exit
    at the cap in the first steps) and text."""
    p = spec.Params(la=15, sb=31)
    x = np.concatenate([np.zeros(90, np.uint8), _data(rng)[:400],
                        np.full(70, 7, np.uint8)])
    per = [_block_inputs(x, s, 61, p) for s in (0, 1, 2, 3, 33, 70, 140, 499)]
    batch = [torch.as_tensor(np.stack([b[i] for b in per])) for i in range(5)]
    got = torch_match.match_sweep_words_plain(*batch, la=15, sb=31)
    for g, b in enumerate(per):
        ref, _ = _both(b, 15, 31)
        np.testing.assert_array_equal(got[0][g].numpy(), ref[0])
        np.testing.assert_array_equal(got[1][g].numpy(), ref[1])


def test_sweep_group_matches_the_kernel_source():
    """The plain decomposition's group of word steps is the kernel's."""
    with open(os.path.join(_build.CSRC, "match_common.cuh")) as f:
        src = f.read()
    assert f"constexpr int GROUP = {torch_match.SWEEP_GROUP};" in src
    for name in ("match.cu", "fused_walk.cu", "match_chunk.cu"):
        with open(os.path.join(_build.CSRC, name)) as f:
            assert '#include "match_common.cuh"' in f.read()
