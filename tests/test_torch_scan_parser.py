"""Port scan parser and tensor parse/pack ops against the JAX package.

``lz77_tpu_torch.models.fused.encode_batch_device``, ``ops.parse``,
``ops.pack`` and ``models.encoder.encode_block`` are plain tensor functions
with no kernel of their own.  The same numpy inputs, made from a seed, go
through the JAX functions and the port's on the CPU; every output is
compared, tolerance 0 (integers and bytes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lz77_tpu_torch
from lz77_tpu import spec
from lz77_tpu.models import codec as jax_codec
from lz77_tpu.models import encoder as jax_encoder
from lz77_tpu.models import fused as jax_fused
from lz77_tpu.ops import pack as jax_pack
from lz77_tpu.ops import parse as jax_parse
from lz77_tpu_torch import convert
from lz77_tpu_torch.models import encoder as torch_encoder
from lz77_tpu_torch.models import fused as torch_fused
from lz77_tpu_torch.ops import pack as torch_pack
from lz77_tpu_torch.ops import parse as torch_parse

from conftest import make_text

torch.set_num_threads(1)


def _same(got: torch.Tensor, want, dtype=np.int32):
    g = convert.to_numpy(got)
    assert g.dtype == dtype
    np.testing.assert_array_equal(g.reshape(np.shape(want)), np.asarray(want))


@pytest.mark.parametrize(
    "la,sb,B,G,s,entry,cut",
    [(15, 4095, 1024, 3, 256, 0, 0),     # B a multiple of the sub-block
     (15, 4095, 701, 3, 200, 4, 0),      # sub-blocks straddle blocks
     (15, 4095, 701, 2, 256, 14, 333),   # ragged valid_total, deepest entry
     (255, 65535, 900, 2, 128, 200, 0),  # 32-bit tokens, la > sub-block
     (5, 31, 1000, 2, 1, 2, 0)],         # one-byte sub-blocks
)
def test_encode_batch_device_output_by_output(la, sb, B, G, s, entry, cut, rng):
    p = spec.Params(la=la, sb=sb)
    data = make_text(rng, G * B // 2) + b"\x00" * (G * B // 4) + bytes(
        rng.integers(0, 256, G * B, dtype=np.uint8)
    )
    x = np.frombuffer(data, np.uint8)
    n = x.shape[0]
    arrs = jax_codec._batch_inputs(x, n, 1, G, G, B, p.d_limit, p.len_limit)
    vt = G * B - cut
    want = jax_fused.encode_batch_device(
        *(jnp.asarray(a) for a in arrs), jnp.int32(vt), jnp.int32(entry),
        la=la, sb=sb, matcher="chunked", sub_block=s, with_map=True,
        head_w=500,
    )
    got = torch_fused.encode_batch_device(
        *convert.batch_from_numpy(*arrs, vt, entry, device="cpu"),
        la=la, sb=sb, sub_block=s, with_map=True, head_w=500, device="cpu",
    )
    assert len(got) == len(want) == 7
    payload, counts, total, exit_e, bmap, l_head, o_head = got
    assert total.shape == exit_e.shape == (1,)
    _same(payload, want[0], np.uint8)
    _same(counts, want[1])
    _same(total, [int(want[2])])
    _same(exit_e, [int(want[3])])
    for g, w in zip(convert.map_from_numpy(*want[4:], device="cpu"),
                    (bmap, l_head, o_head)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert bmap.shape == (la,) and l_head.shape == (min(500, G * B),)
    assert int(counts.sum()) == int(total)
    # without the map: the first four, unchanged
    four = torch_fused.encode_batch_device(
        *convert.batch_from_numpy(*arrs, vt, entry, device="cpu"),
        la=la, sb=sb, sub_block=s, device="cpu",
    )
    assert len(four) == 4 and all(
        torch.equal(a, b) for a, b in zip(four, got[:4])
    )


def _tables(rng, B, la):
    """A random but legal match-length table (p + L + 1 <= B) and offsets."""
    L = np.minimum(rng.integers(0, la, B), np.maximum(B - 1 - np.arange(B), 0))
    L[rng.random(B) < 0.4] = 0
    O = np.where(L > 0, rng.integers(1, 4096, B), 0)
    return L.astype(np.int32), O.astype(np.int32)


@pytest.mark.parametrize("B,la,valid_len,entry",
                         [(257, 15, 257, 0), (300, 15, 211, 9),
                          (64, 255, 64, 200), (1, 2, 1, 0), (50, 5, 0, 3)])
def test_greedy_parse_and_gather_tokens(B, la, valid_len, entry, rng):
    L, O = _tables(rng, B, la)
    block_ext = rng.integers(0, 256, B + la - 1, dtype=np.uint8)
    starts, count, exit_pos = jax_parse.greedy_parse(
        jnp.asarray(L), jnp.int32(valid_len), jnp.int32(entry), la=la
    )
    Lt, Ot = convert.tables_from_numpy(L, O, "cpu")
    ts, tc, te = torch_parse.greedy_parse(Lt, valid_len, entry, la=la)
    _same(ts, starts)
    assert tc.dtype == te.dtype == torch.int32
    assert (int(tc), int(te)) == (int(count), int(exit_pos))
    # the same with the scalars as tensors
    ts2, tc2, te2 = torch_parse.greedy_parse(
        Lt, torch.tensor(valid_len), torch.tensor([entry])[0], la=la
    )
    assert torch.equal(ts, ts2) and int(tc2) == int(tc) and int(te2) == int(te)

    want = jax_parse.gather_tokens(
        starts, jnp.int32(valid_len), jnp.asarray(L), jnp.asarray(O),
        jnp.asarray(block_ext), la=la,
    )
    got = torch_parse.gather_tokens(
        ts, valid_len, Lt, Ot, torch.from_numpy(block_ext), la=la
    )
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("la,sb", [(15, 4095), (255, 65535), (5, 31),
                                   (8, 500), (2, 3), (17, 4095)])
def test_pack_and_unpack_tokens(la, sb, rng):
    """Byte-aligned widths (24, 32, 16 bits) and general ones (20, 11, 25)."""
    p = spec.Params(la=la, sb=sb)
    T = 37
    off = rng.integers(0, 1 << p.off_bits, T).astype(np.int32)
    ln = rng.integers(0, la, T).astype(np.int32)
    nxt = rng.integers(0, 256, T).astype(np.int32)
    want = jax_pack.pack_tokens_device(
        jnp.asarray(off), jnp.asarray(ln), jnp.asarray(nxt), p
    )
    fields = convert.token_fields_from_numpy(off, ln, nxt, T, device="cpu")[:3]
    tp = lz77_tpu_torch.Params(la, sb)
    got = torch_pack.pack_tokens_device(*fields, tp)
    _same(got, want, np.uint8)
    assert got.shape == (-(-T * p.width // 8),)
    back = torch_pack.unpack_tokens_device(got, T, tp)
    ref = jax_pack.unpack_tokens_device(want, T, p)
    for g, r, f in zip(back, ref, (off, ln, nxt)):
        _same(g, r)
        np.testing.assert_array_equal(convert.to_numpy(g), f)


@pytest.mark.parametrize("start,B,entry", [(0, 600, 0), (500, 400, 6),
                                           (1300, 400, 0)])
def test_encode_block_matches_jax(start, B, entry, rng):
    p = spec.Params(la=15, sb=300)
    x = np.frombuffer(
        make_text(rng, 1000) + b"\x00" * 300 + bytes(
            rng.integers(0, 4, 300, dtype=np.uint8)),
        np.uint8,
    )
    n = x.shape[0]
    gb, gh, gr, ga, gv = jax_codec._batch_inputs(
        x, n, 0, 1, 1, B, p.d_limit, p.len_limit
    ) if start == 0 else _block_at(x, start, B, p)
    args = (gb[0], gh[0], gr[0], ga[0], gv[0])
    want = jax_encoder.encode_block(
        *(jnp.asarray(a) for a in args), jnp.int32(entry), la=p.la, sb=p.sb,
        matcher="chunked",
    )
    got = torch_encoder.encode_block(
        *args, entry, la=p.la, sb=p.sb, device="cpu"
    )
    assert len(got) == 5
    for g, w in zip(got[:3], want[:3]):
        _same(g, w)
    assert (int(got[3]), int(got[4])) == (int(want[3]), int(want[4]))
    assert got[3].dtype == got[4].dtype == torch.int32


def _block_at(x, start, B, p):
    """One block of ``B`` bytes at byte ``start`` in the matcher's
    coordinates, as (1, ...) arrays."""
    n = x.shape[0]
    H, R = p.d_limit, p.len_limit
    gb = np.zeros((1, B), np.uint8)
    seg = x[start : min(start + B, n)]
    gb[0, : seg.shape[0]] = seg
    gh = np.zeros((1, H), np.uint8)
    a = min(H, start)
    gh[0, H - a :] = x[start - a : start]
    gr = np.zeros((1, R), np.uint8)
    rseg = x[start + B : min(start + B + R, n)]
    gr[0, : rseg.shape[0]] = rseg
    return (gb, gh, gr, np.array([a], np.int32),
            np.array([min(B + R, n - start)], np.int32))
