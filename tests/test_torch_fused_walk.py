"""Port merged sweep+walk (lz77_tpu_torch.ops.fused_walk) and the fused
encode's batch steps against the JAX package.

The same numpy batch inputs, made from a seed, go through
``lz77_tpu.models.fused.encode_batch_device`` (the formulation the JAX
package's own tests hold its merged kernel equal to) and the port's
``encode_batch_sweepwalk`` on the CPU (so through the kernel's plain PyTorch
version), chained over batches by the exit entry; each step (K5 and the
scan step) chained into a whole stream (``_step_stream``) gives the JAX
package's, ``native.encode``'s and the walk pipeline's.  Widths that are
no byte multiple go through the token-level wrapper against the numpy
executable spec.  The JAX merged kernel itself runs once, interpreted, in a fresh
process.  Tolerance 0: bytes, counts and entries are integers.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lz77_tpu_torch
from lz77_tpu import spec
from lz77_tpu.models import codec as jax_codec
from lz77_tpu.models import fused as jax_fused
from lz77_tpu.models import spec_np
from lz77_tpu_torch import bitio, convert, native
from lz77_tpu_torch.models import codec as torch_codec
from lz77_tpu_torch.models import fused as torch_fused
from lz77_tpu_torch.ops import fused_walk, parse_walk

from conftest import CORPUS_SMALL, make_text
from test_fused_walk import _RUNNER

torch.set_num_threads(1)


def _chain(data, params, B, G):
    """Both packages batch by batch; returns the entries the port saw."""
    x = np.frombuffer(data, np.uint8)
    n = x.shape[0]
    H, R = params.d_limit, params.len_limit
    nb = params.width // 8
    nblocks = -(-n // B)
    e_jax = jnp.int32(0)
    e_port = torch.zeros(1, dtype=torch.int32)
    entries = []
    for bi in range(-(-nblocks // G)):
        g0 = bi * G
        gn = min(G, nblocks - g0)
        arrs = jax_codec._batch_inputs(x, n, g0, gn, G, B, H, R)
        vt = min(G * B, n - g0 * B)
        entries.append(int(e_port))
        pj, _, tj, e_jax = jax_fused.encode_batch_device(
            *(jnp.asarray(a) for a in arrs), jnp.int32(vt), e_jax,
            la=params.la, sb=params.sb, matcher="chunked", sub_block=256,
        )
        pp, counts, tp, e_port = fused_walk.encode_batch_sweepwalk(
            *convert.batch_from_numpy(*arrs, vt, e_port, device="cpu"),
            la=params.la, sb=params.sb, device="cpu",
        )
        assert tp.shape == (1,) and e_port.shape == (1,)
        assert tp.dtype == e_port.dtype == torch.int32
        assert counts.shape == (G,) and pp.shape == (G * B * nb,)
        assert int(tp) == int(tj)
        assert int(e_port) == int(e_jax)
        k = int(tp) * nb
        assert pp[:k].numpy().tobytes() == np.asarray(pj)[:k].tobytes()
    return entries


def _step_stream(step, data, params, B=None,
                 G=torch_fused.DEFAULT_BATCH_BLOCKS, entries=None, **kw):
    """A batch step (``encode_batch_sweepwalk`` or ``encode_batch_device``)
    over the port's ``codec._batch_inputs`` batches on the CPU, the exit
    entry carried as the device tensor, each batch's ``total * width / 8``
    payload bytes after the header; the pipeline's geometry (``B`` the
    input where None, the last batch its real blocks only).  Returns the
    stream; with ``entries``, appends each batch's entry to it."""
    x = np.frombuffer(data, np.uint8)
    n = x.shape[0]
    B = B or min(torch_fused.DEFAULT_BLOCK_SIZE, max(n, 1))
    nblocks = -(-n // B)
    out = bytearray(bitio.header_bytes(params))
    e = torch.zeros(1, dtype=torch.int32)
    for g0 in range(0, nblocks, G):
        gn = min(G, nblocks - g0)
        arrs = torch_codec._batch_inputs(x, n, g0, gn, gn, B, params.d_limit,
                                         params.len_limit)
        if entries is not None:
            entries.append(int(e))
        payload, _, total, e = step(
            *arrs, min(gn * B, n - g0 * B), e, la=params.la, sb=params.sb,
            device="cpu", **kw)
        out += payload[: int(total) * params.width // 8].numpy().tobytes()
    return bytes(out)


STEPS = {"merged": fused_walk.encode_batch_sweepwalk,
         "scan": torch_fused.encode_batch_device}


@pytest.mark.parametrize("la,sb,n", [(5, 31, 9000), (15, 4095, 5000),
                                     (255, 65535, 2600)])
def test_sweepwalk_matches_scan_parser_chained(la, sb, n, rng):
    """Blocks of 701 bytes (no multiple of any tile), two a batch, a ragged
    last batch; runs make batches start mid-token (nonzero entries)."""
    data = make_text(rng, n // 3) + b"x" * (n // 3) + b"\x00" * (n // 3 + 57)
    entries = _chain(data, spec.Params(la=la, sb=sb), 701, 2)
    assert any(entries)


@pytest.mark.parametrize(
    "la,sb", [(2, 3), (2, 65535), (5, 31), (15, 3), (255, 31), (15, 4095)]
)
def test_sweep_walk_tokens_match_the_spec(la, sb, rng):
    """The token-level wrapper at any width: one batch over the whole input
    equals the serial parse of the numpy spec, token word by token word."""
    p = spec.Params(la=la, sb=sb)
    data = make_text(rng, 900) + b"\x00" * 300 + bytes(
        rng.integers(0, 3, 300, dtype=np.uint8)
    )
    x = np.frombuffer(data, np.uint8)
    n, B = x.shape[0], 701
    G = -(-n // B)
    arrs = jax_codec._batch_inputs(x, n, 0, G, G, B, p.d_limit, p.len_limit)
    *batch, vt, entry = convert.batch_from_numpy(*arrs, n, 0, device="cpu")
    tokens, count, exit_e = fused_walk.sweep_walk(
        *batch, entry, vt, la=la, sb=sb
    )
    off, ln, nxt = spec_np.encode_tokens(data, p)
    want = off | (ln << p.off_bits) | (nxt << (p.off_bits + p.len_bits))
    assert int(count) == want.shape[0] and int(exit_e) == 0
    got = tokens[: int(count)].numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want.astype(np.uint32))
    assert fused_walk.sweep_walk.launches == 0


@pytest.mark.parametrize("step", ["walk", "merged", "scan"])
@pytest.mark.parametrize("name", ["empty", "one", "mixed"])
def test_each_step_gives_the_jax_stream(step, name, rng):
    """The walk through the pipeline, K5 and the scan step chained by
    ``_step_stream``, at the same geometry."""
    data = {
        "empty": b"", "one": b"A",
        "mixed": make_text(np.random.default_rng(7), 3000) + b"ab" * 900
        + bytes(np.random.default_rng(8).integers(0, 256, 700, dtype=np.uint8)),
    }[name]
    if step == "walk":
        out = torch_fused.encode_bytes_fused(
            data, lz77_tpu_torch.Params(), block_size=1500, batch_blocks=2,
            sub_block=200, device="cpu",
        )
    else:
        out = _step_stream(STEPS[step], data, lz77_tpu_torch.Params(), 1500,
                           2, **({"sub_block": 200} if step == "scan" else {}))
    assert out == jax_codec.encode_bytes(
        data, spec.Params(), block_size=2048, batch_blocks=2
    )
    assert out == spec_np.encode(data, spec.Params())
    assert lz77_tpu_torch.decompress(out, device="cpu") == data


# the long run of test_torch_fused.py::test_fused_entry_carry_across_batches
ENTRY_CARRY = (b"x" * 9000 + make_text(np.random.default_rng(0xC57D), 3000)
               + b"y" * 9000)


@pytest.mark.parametrize("case", ["text", "zeros", "entry_carry"])
@pytest.mark.parametrize("step", sorted(STEPS))
def test_steps_chain_to_the_native_stream(step, case, rng):
    """Each step chained batch to batch gives ``native.encode``'s stream and
    the walk pipeline's: CORPUS_SMALL's text and zeros at the defaults, and
    a long run across batches of two 2 KiB blocks (nonzero entries)."""
    p = lz77_tpu_torch.Params()
    if case == "entry_carry":
        data, B, G = ENTRY_CARRY, 2048, 2
    else:
        data, B, G = (CORPUS_SMALL[case](rng), None,
                      torch_fused.DEFAULT_BATCH_BLOCKS)
    entries = []
    out = _step_stream(STEPS[step], data, p, B, G, entries)
    assert out == native.encode(data, p)
    assert out == torch_fused.encode_bytes_fused(
        data, p, block_size=B, batch_blocks=G, device="cpu")
    assert any(entries) == (case == "entry_carry")


def test_unknown_parser_and_auto_raise():
    """The pipeline runs the walk step alone: ``parser`` is an unknown
    keyword there, as any other, whatever its value."""
    for parser in ("walk", "merged", "scan", "auto"):
        with pytest.raises(TypeError, match="parser"):
            torch_fused.encode_bytes_fused(b"x", parser=parser, device="cpu")
        with pytest.raises(TypeError, match="parser"):
            torch_fused.iter_batches_fused(
                np.zeros(3, np.uint8), lz77_tpu_torch.Params(), parser=parser,
                device="cpu",
            )


def test_sweepwalk_short_spans_and_bad_arguments():
    """valid_total 0 passes the (clamped) entry through; an entry past a
    short span emits nothing; malformed arguments raise."""
    la, sb = 15, 4095
    z = lambda *s, dt=torch.uint8: torch.zeros(*s, dtype=dt)
    batch = (z(1, 8), z(1, 4095), z(1, 14), z(1, dt=torch.int32),
             torch.full((1,), 8, dtype=torch.int32))
    for vt, entry, want_cnt, want_exit in ((0, 5, 0, 5), (0, 99, 0, 14),
                                           (3, 5, 0, 2), (8, 2, 1, 0)):
        _, cnt, ex = fused_walk.sweep_walk(
            *batch, torch.tensor([entry], dtype=torch.int32), vt, la=la, sb=sb
        )
        assert (int(cnt), int(ex)) == (want_cnt, want_exit)
    e = z(1, dt=torch.int32)
    with pytest.raises(ValueError, match="valid_total"):
        fused_walk.sweep_walk(*batch, e, 9, la=la, sb=sb)
    with pytest.raises(ValueError, match="entry"):
        fused_walk.sweep_walk(*batch, e.to(torch.int64), 8, la=la, sb=sb)
    with pytest.raises(ValueError, match="halos"):
        fused_walk.sweep_walk(batch[0], z(1, 100), *batch[2:], e, 8,
                              la=la, sb=sb)
    with pytest.raises(ValueError, match="byte-aligned"):
        fused_walk.encode_batch_sweepwalk(
            np.zeros((1, 8), np.uint8), np.zeros((1, 4095), np.uint8),
            np.zeros((1, 16), np.uint8), np.zeros(1, np.int32),
            np.zeros(1, np.int32), 8, 0, la=17, sb=4095, device="cpu",
        )


def test_merged_route_matches_the_pallas_kernel_interpreted(tmp_path, rng):
    """Once against the TPU kernel itself: interpreted, in a fresh process
    (XLA on the CPU does not survive this compile late in a long one)."""
    data = make_text(rng, 9000) + b"\x00" * 2500 + bytes(
        rng.integers(0, 256, 1000, dtype=np.uint8)
    )
    ip, op = tmp_path / "in.bin", tmp_path / "out.lz"
    ip.write_bytes(data)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-c", _RUNNER, str(ip), "5", "31", "8192", "2", repo,
         str(op)],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=repo),
    )
    assert r.returncode == 0, r.stderr[-1500:]
    out = _step_stream(fused_walk.encode_batch_sweepwalk, data,
                       lz77_tpu_torch.Params(5, 31), 8192, 2)
    assert out == op.read_bytes()


def _batch(data, p, g0, G, B):
    x = np.frombuffer(data, np.uint8)
    n = x.shape[0]
    arrs = jax_codec._batch_inputs(x, n, g0, G, G, B, p.d_limit, p.len_limit)
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs], \
        min(G * B, n - g0 * B)


# (la, sb, B, G, entry, cut): blocks shorter than la (tiles jumped over
# whole), blocks that are no multiple of any tile, a ragged valid_total
# (cut bytes off the span) with a nonzero entry
TILE_CASES = {
    "short_blocks": (255, 255, 100, 5, 200, 0),
    "ragged": (15, 31, 701, 2, 5, 333),
    "la2": (2, 3, 33, 9, 1, 7),
}


@pytest.mark.parametrize("tile", [1, 7, 512, 4096])
@pytest.mark.parametrize("case", sorted(TILE_CASES))
def test_sweep_walk_tiles_plain_equals_plain(case, tile, rng):
    """The kernel's decomposition (tiles, maps by entry offset, the chain
    from the batch entry, emit) gives the plain version's tokens, count and
    exit at any tile size."""
    la, sb, B, G, entry, cut = TILE_CASES[case]
    p = spec.Params(la=la, sb=sb)
    data = make_text(rng, 700) + b"\x00" * 400 + bytes(
        rng.integers(0, 3, 300, dtype=np.uint8))
    t, vt = _batch(data, p, 0, G, B)
    vt -= cut
    e = torch.tensor([entry], dtype=torch.int32)
    want = fused_walk.sweep_walk_plain(*t, e, vt, la=la, sb=sb)
    got = fused_walk.sweep_walk_tiles_plain(*t, e, vt, la=la, sb=sb,
                                            tile=tile)
    c = int(want[1])
    assert c > 0 and [int(got[1]), int(got[2])] == [c, int(want[2])]
    assert torch.equal(got[0][:c], want[0][:c])


@pytest.mark.parametrize("tile", [7, 4096])
def test_sweep_walk_tiles_plain_chained_against_jax(tile, rng):
    """Batch by batch, chained by the exit entry, the decomposition gives
    the JAX package's ``encode_batch_device`` payload, count and entry."""
    params = spec.Params(la=5, sb=31)
    data = make_text(rng, 1500) + b"y" * 700 + b"\x00" * 401
    x = np.frombuffer(data, np.uint8)
    n, B, G = x.shape[0], 301, 2
    nb = params.width // 8
    e_jax = jnp.int32(0)
    e_port = torch.zeros(1, dtype=torch.int32)
    entries = []
    for g0 in range(0, -(-n // B), G):
        gn = min(G, -(-n // B) - g0)
        arrs = jax_codec._batch_inputs(x, n, g0, gn, G, B, params.d_limit,
                                       params.len_limit)
        vt = min(G * B, n - g0 * B)
        entries.append(int(e_port))
        pj, _, tj, e_jax = jax_fused.encode_batch_device(
            *(jnp.asarray(a) for a in arrs), jnp.int32(vt), e_jax,
            la=5, sb=31, matcher="chunked", sub_block=256,
        )
        tok, cnt, e_port = fused_walk.sweep_walk_tiles_plain(
            *(torch.from_numpy(np.ascontiguousarray(a)) for a in arrs),
            e_port, vt, la=5, sb=31, tile=tile,
        )
        assert int(cnt) == int(tj) and int(e_port) == int(e_jax)
        k = int(cnt) * nb
        got = parse_walk.token_bytes(tok, nb)[:k].numpy().tobytes()
        assert got == np.asarray(pj)[:k].tobytes()
    assert any(entries)
