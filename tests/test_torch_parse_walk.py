"""Port walk parse + pack (lz77_tpu_torch.ops.parse_walk) against the JAX
package's fused step.

The same numpy batch inputs go through ``lz77_tpu.models.fused``'s
``encode_batch_device`` (its plain scan parser) and, with that package's own
match tables carried across by ``convert``, through the port's ``build_lox``
+ ``walk_parse_pack`` (on the CPU, so the kernel's plain PyTorch version),
over several batches chained by the exit entry.  Tolerance 0: token bytes,
count and exit entry are integers.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lz77_tpu import spec
from lz77_tpu.models import codec as jax_codec
from lz77_tpu.models import fused as jax_fused
from lz77_tpu.ops import match as jax_match
from lz77_tpu_torch import convert
from lz77_tpu_torch.ops import parse_walk

from conftest import make_text

torch.set_num_threads(1)


def _port_batch(gb, gh, gr, ga, gv, vt, entry, params, sub_block=None):
    """Port side of one batch: JAX match tables -> LOX -> walk -> bytes.
    With ``sub_block`` the plain version's kernel decomposition (maps, their
    scan, the emit walks) must give the same tokens, count and exit."""
    find = functools.partial(
        jax_match.find_matches_chunked, la=params.la, sb=params.sb
    )
    L, O = jax.jit(jax.vmap(find))(*(jnp.asarray(a) for a in (gb, gh, gr, ga, gv)))
    lox = convert.lox_from_numpy(
        np.asarray(L), np.asarray(O), gb, gr[-1], params.la, device="cpu"
    )
    assert lox.dtype == torch.int32 and lox.shape == (gb.size + params.la,)
    tokens, count, exit_e = parse_walk.walk_parse_pack(
        lox, entry, vt, la=params.la, ob=params.off_bits, lb=params.len_bits
    )
    assert count.shape == (1,) and exit_e.shape == (1,)
    if sub_block is not None:
        tk, ck, ek = parse_walk.walk_parse_pack_plain(
            lox, entry, vt, la=params.la, ob=params.off_bits,
            lb=params.len_bits, sub_block=sub_block)
        assert torch.equal(tk, tokens)
        assert torch.equal(ck, count) and torch.equal(ek, exit_e)
    nb = params.width // 8
    t = int(count)
    payload = tokens[:t].view(torch.uint8).reshape(t, 4)[:, :nb]
    return payload.numpy().tobytes(), t, exit_e


def _chain(data, params, B, G, jax_step, sub_block=None):
    x = np.frombuffer(data, np.uint8)
    n = x.shape[0]
    H, R = params.d_limit, params.len_limit
    nb = params.width // 8
    nblocks = -(-n // B)
    e_jax = jnp.int32(0)
    e_port = torch.zeros(1, dtype=torch.int32)
    nonzero_entries = 0
    for bi in range(-(-nblocks // G)):
        g0 = bi * G
        gn = min(G, nblocks - g0)
        gb, gh, gr, ga, gv = jax_codec._batch_inputs(x, n, g0, gn, G, B, H, R)
        vt = min(G * B, n - g0 * B)
        nonzero_entries += int(e_port) != 0
        pj, _, tj, e_jax = jax_step(
            *(jnp.asarray(a) for a in (gb, gh, gr, ga, gv)), jnp.int32(vt),
            e_jax, la=params.la, sb=params.sb, matcher="chunked",
        )
        pp, tp, e_port = _port_batch(gb, gh, gr, ga, gv, vt, e_port, params,
                                     sub_block)
        assert tp == int(tj)
        assert int(e_port) == int(e_jax)
        assert pp == np.asarray(pj)[: tp * nb].tobytes()
    return nonzero_entries


def test_walk_matches_scan_parser_chained(rng):
    """The geometry of the JAX package's own walk-vs-scan test: text then a
    run, three blocks a batch, a ragged last batch."""
    data = make_text(rng, 40000) + b"\x00" * 5000
    step = functools.partial(jax_fused.encode_batch_device, sub_block=1024)
    _chain(data, spec.Params(), 8192, 3, step)


def test_walk_carries_nonzero_entries(rng):
    """Long runs across batch boundaries: tokens overhang, so batches are
    entered mid-token and the exit entry must ride along."""
    data = b"x" * 9000 + make_text(rng, 3000) + b"y" * 9000
    step = functools.partial(jax_fused.encode_batch_device, sub_block=256)
    assert _chain(data, spec.Params(), 2048, 2, step) > 0


@pytest.mark.parametrize("la,sb", [(255, 255), (129, 65535), (16, 4095)])
def test_walk_deep_la_and_wide_tokens(la, sb, rng):
    """la beyond the TPU walk's 128, and 32-bit token words (sign bit set)."""
    data = make_text(rng, 5000) + b"\x00" * 3000 + bytes(
        rng.integers(128, 256, 500, dtype=np.uint8)
    )
    step = functools.partial(jax_fused.encode_batch_device, sub_block=512)
    _chain(data, spec.Params(la=la, sb=sb), 2048, 2, step)


@pytest.mark.parametrize("sub_block", [1, 7, 4096])
@pytest.mark.parametrize("la,sb", [(2, 65), (15, 4095), (255, 255)])
def test_walk_decomposition_follows_the_kernel(la, sb, sub_block):
    """The plain version's kernel decomposition at sub-blocks of one byte,
    of seven (shorter than la at la 15 and 255) and of 4,096 (two a
    span), against the orbit form and the JAX package's scan parser on the
    same LOX, batch after batch, entered mid-token by the exit entry."""
    rng = np.random.default_rng(0)  # this input enters a batch mid-token
    data = (make_text(rng, 6000) + b"z" * 2500 + make_text(rng, 1500)
            + b"\x00" * 2049 + bytes(rng.integers(0, 256, 300,
                                                   dtype=np.uint8))
            + make_text(rng, 4000) + b"xy" * 2000 + b"w" * 3001)
    step = functools.partial(jax_fused.encode_batch_device, sub_block=512)
    entered = _chain(data, spec.Params(la=la, sb=sb), 4096, 2, step,
                     sub_block=sub_block)
    assert entered > 0


def test_walk_scan_crosses_chunks_and_groups():
    """More maps than one chunk of the kernel's scan holds, and a last
    chunk that ends mid-group: the scan's carry from chunk to chunk."""
    la = 15
    C = parse_walk.SCAN_ENTRIES // la
    M = 2 * C + parse_walk.SCAN_GROUP + 5
    rng = np.random.default_rng(7)
    L = rng.integers(0, la, M).astype(np.int32)
    L[rng.random(M) < 0.5] = 0
    lox = convert.lox_from_numpy(L, L * 3, rng.integers(0, 256, M),
                                 np.zeros(la - 1), la, "cpu")
    for entry in (0, 9):
        e = torch.tensor([entry], dtype=torch.int32)
        want = parse_walk.walk_parse_pack_plain(lox, e, M, la=la, ob=12, lb=4)
        got = parse_walk.walk_parse_pack_plain(lox, e, M, la=la, ob=12, lb=4,
                                               sub_block=1)
        assert all(torch.equal(a, b) for a, b in zip(want, got))


def test_walk_matches_pallas_walk_interpreted(rng):
    """One small case against the TPU walk kernel itself, interpreted."""
    data = make_text(rng, 6000) + b"\x00" * 2000
    step = functools.partial(
        jax_fused.encode_batch_walk, sub_block=1024, interpret=True
    )
    _chain(data, spec.Params(), 8192, 1, step)


def test_walk_empty_and_short_spans():
    """valid_total 0 passes the entry through; an entry past a short span
    emits nothing and leaves entry - valid_total."""
    la = 15
    L = np.zeros(8, np.int32)
    lox = convert.lox_from_numpy(L, L, np.arange(8), np.zeros(14), la, "cpu")
    for vt, entry, want_cnt, want_exit in ((0, 5, 0, 5), (3, 5, 0, 2),
                                           (8, 2, 6, 0)):
        _, cnt, ex = parse_walk.walk_parse_pack(
            lox, torch.tensor([entry], dtype=torch.int32), vt,
            la=la, ob=12, lb=4,
        )
        assert (int(cnt), int(ex)) == (want_cnt, want_exit)


def test_walk_rejects_bad_arguments():
    lox = torch.zeros(20, dtype=torch.int32)
    e = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="valid_total"):
        parse_walk.walk_parse_pack(lox, e, 6, la=15, ob=12, lb=4)
    with pytest.raises(ValueError, match="entry"):
        parse_walk.walk_parse_pack(lox, e.to(torch.int64), 5, la=15, ob=12, lb=4)
    with pytest.raises(ValueError, match="la"):
        parse_walk.walk_parse_pack(lox, e, 5, la=256, ob=12, lb=4)


def test_scan_constants_match_the_kernel_source():
    """The plain decomposition's chunk and group are the kernel's."""
    import os

    from lz77_tpu_torch import _build

    with open(os.path.join(_build.CSRC, "parse_walk.cu")) as f:
        src = f.read()
    assert f"GROUP = {parse_walk.SCAN_GROUP};" in src
    assert f"SCAN_ENTRIES = {parse_walk.SCAN_ENTRIES};" in src
