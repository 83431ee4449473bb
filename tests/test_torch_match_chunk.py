"""Port chunk matcher (lz77_tpu_torch.ops.match_chunk, K4) against the JAX
package's matchers.

The same numpy inputs, made from a seed, go through the JAX functions
(``find_matches_brute``; once through the Pallas kernel the port's kernel
replaces, in interpret mode) and the port's ``match_chunk`` on the CPU, so
through the kernel's plain PyTorch version.  Tolerance 0: both tables are
integers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lz77_tpu import spec
from lz77_tpu.ops import match as jax_match
from lz77_tpu.ops import pallas_match
from lz77_tpu_torch.ops import match as torch_match
from lz77_tpu_torch.ops import match_chunk

from conftest import make_text

torch.set_num_threads(1)


def _args(x: np.ndarray, p: spec.Params, avail: int, valid_ext: int):
    return (x, np.zeros(p.d_limit, np.uint8), np.zeros(p.len_limit, np.uint8),
            np.int32(avail), np.int32(valid_ext))


def _port(args, la, sb):
    L, O = torch_match.find_matches(
        *args, la=la, sb=sb, device="cpu", matcher="chunk"
    )
    assert L.dtype == O.dtype == torch.int32
    return L.numpy(), O.numpy()


def _jax(find, args, la, sb, **kw):
    L, O = find(*(jnp.asarray(a) for a in args), la=la, sb=sb, **kw)
    return np.asarray(L), np.asarray(O)


@pytest.mark.parametrize(
    "la,sb", [(15, 4095), (8, 500), (4, 129), (255, 255), (15, 65535),
              (255, 65535), (2, 3)],
)
def test_chunk_matches_brute(la, sb, rng):
    """The parameter sets of the Pallas kernel's own test, plus the deepest
    la and the widest window (beyond the TPU kernel's la <= 128)."""
    p = spec.Params(la=la, sb=sb)
    B = 2048
    x = np.frombuffer(make_text(rng, B), np.uint8)
    args = _args(x, p, 0, B)
    # the JAX brute sweep takes d_limit sequential steps: its chunked
    # matcher (same contract) stands in at the widest window
    find = (jax_match.find_matches_chunked if sb == 65535
            else jax_match.find_matches_brute)
    ref = _jax(jax.jit(find, static_argnames=("la", "sb")), args, la, sb)
    got = _port(args, la, sb)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])


# (sb, avail): position 0 reaches exactly dmax = min(d_limit(sb), avail)
# distances, and the positions after it one more each up to d_limit
DMAX_CASES = {1: (2, 1), 2: (3, 2), 3: (3, 3), 4: (5, 4), 127: (127, 127),
              128: (129, 128), 129: (129, 129), 255: (255, 255),
              256: (257, 256), 257: (257, 257), 4095: (4095, 4095)}
# la: the cap is la - 1 (254 is the longest the format has)
CAP_LAS = {1: 2, 3: 4, 4: 5, 15: 16, 254: 255}


@pytest.mark.parametrize("cap", sorted(CAP_LAS))
@pytest.mark.parametrize("dmax", sorted(DMAX_CASES))
def test_chunk_plain_word_filters_match_brute(dmax, cap, rng):
    """The plain version follows the kernel: four distances a word cut on
    the word grid, first-byte and ``best``-byte filters, the best run kept
    per chunk of 256.  Around every edge of that grouping (distance limits
    below, at and above a word, a lane's two words and a chunk; caps below,
    at and above a word and deeper than the words kept in registers) it
    still gives the brute sweep's tables."""
    sb, avail = DMAX_CASES[dmax]
    la = CAP_LAS[cap]
    p = spec.Params(la=la, sb=sb)
    assert min(p.d_limit, avail) == dmax and p.len_limit == cap
    B = 400
    # few symbols: long runs, many equal-length candidates, ties on distance
    data = rng.integers(0, 3, p.d_limit + B + cap, dtype=np.uint8)
    data[p.d_limit + 150 : p.d_limit + 150 + 2 * cap + 9] = 7   # one long run
    halo = data[: p.d_limit].copy()
    halo[: p.d_limit - avail] = 0
    x = data[p.d_limit : p.d_limit + B]
    right = data[p.d_limit + B :]
    args = (x, halo, right, np.int32(avail), np.int32(B + cap - 3))
    ref = _jax(jax.jit(jax_match.find_matches_brute,
                       static_argnames=("la", "sb")), args, la, sb)
    got = _port(args, la, sb)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[0].max() == cap


def test_chunk_matches_the_pallas_kernel_it_replaces(rng):
    """The TPU kernel itself, in interpret mode, at B=2048 tile=1024."""
    la, sb = 4, 129
    p = spec.Params(la=la, sb=sb)
    x = np.frombuffer(make_text(rng, 2048), np.uint8)
    args = _args(x, p, 0, 2048)
    ref = _jax(pallas_match.find_matches_pallas, args, la, sb, tile=1024,
               interpret=True)
    got = _port(args, la, sb)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])


def test_chunk_with_halo_and_shrinkage(rng):
    p = spec.Params()
    B = 1024
    data = np.frombuffer(make_text(rng, B + p.d_limit), np.uint8)
    halo, x = data[: p.d_limit], data[p.d_limit :]
    valid = B - 100  # partial final block: lookahead shrinkage at the end
    xb = x.copy()
    xb[valid:] = 0
    args = (xb, halo.copy(), np.zeros(p.len_limit, np.uint8),
            np.int32(p.d_limit), np.int32(valid))
    ref = _jax(jax.jit(jax_match.find_matches_brute,
                       static_argnames=("la", "sb")), args, 15, 4095)
    got = _port(args, 15, 4095)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])


def test_chunk_equals_sweep_on_a_batch(rng):
    """K4's plain version against K1's on a (G, B) batch whose B is no
    multiple of anything: mid-stream halos, right extensions, a short tail."""
    from lz77_tpu_torch.models import codec

    p = spec.Params(la=17, sb=300)
    x = np.frombuffer(
        make_text(rng, 2000) + bytes(rng.integers(0, 3, 901, dtype=np.uint8)),
        np.uint8,
    )
    B = 701
    arrs = codec._batch_inputs(x, x.shape[0], 1, 4, 4, B, p.d_limit,
                               p.len_limit)
    t = [torch.from_numpy(a) for a in arrs]
    L4, O4 = match_chunk.match_chunk(*t, la=p.la, sb=p.sb)
    L1, O1 = torch_match.match_sweep(*t, la=p.la, sb=p.sb)
    assert torch.equal(L4, L1) and torch.equal(O4, O1)
    assert L4.shape == (4, B) and int(L4.max()) > 0
    assert match_chunk.match_chunk.launches == 0  # CPU: the plain version


def test_key_round_trip():
    dlim = 4095
    L = torch.tensor([0, 1, 14, 254, 3])
    O = torch.tensor([0, 1, 4095, 77, 2])
    key = torch.where(L > 0, match_chunk.combine_key(L, O, dlim), 0)
    L2, O2 = match_chunk.split_key(key, dlim)
    assert torch.equal(L2, L) and torch.equal(O2, O)
    # a longer match wins; among equal lengths the smaller offset
    assert key[2] > key[4] > key[1] and \
        match_chunk.combine_key(L[4], 1, dlim) > key[4]


def test_chunk_rejects_bad_halo():
    """Like the TPU kernel, the halo must be d_limit long."""
    with pytest.raises(ValueError, match="halos"):
        torch_match.find_matches(
            np.zeros(1024, np.uint8), np.zeros(10, np.uint8),
            np.zeros(14, np.uint8), 0, 1024, la=15, sb=4095, device="cpu",
            matcher="chunk",
        )


@pytest.mark.parametrize(
    "name,want",
    [("sweep", "match_sweep"), ("chunk", "match_chunk"),
     ("pallas_bitplane", "match_sweep"), ("pallas", "match_chunk")],
)
def test_matcher_names_and_aliases(name, want):
    assert torch_match.get_matcher(name).__name__ == want
    assert torch_match.route_matcher(name) in ("sweep", "chunk")


@pytest.mark.parametrize("name", ["brute", "sorted", "chunked", "bitplane",
                                  "nope"])
def test_xla_matcher_names_are_refused(name):
    """The name dates from when the port refused the JAX package's XLA
    matchers: each name now gives its tensor-code function (no kernel, so
    neither K1's nor K4's wrapper), and an unknown name is still refused
    with every name the port has."""
    if name == "nope":
        with pytest.raises(ValueError, match="bitplane.*brute.*chunk.*"
                                             "chunked.*sorted.*sweep"):
            torch_match.get_matcher(name)
        return
    fn = torch_match.get_matcher(name)
    assert fn.__name__ == f"find_matches_{name}"
    assert torch_match.route_matcher(name) == name
    assert fn not in (torch_match.match_sweep, match_chunk.match_chunk)
