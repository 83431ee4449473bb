"""Port sharded pipeline (lz77_tpu_torch.parallel) against the JAX package's.

The JAX package runs on its virtual 8-device CPU mesh (``conftest.py``);
the port's meshes list the CPU device 8 times (members may share a device),
so its kernels run as their plain PyTorch versions.  The same numpy inputs,
made from a seed, go through both.  Tolerance 0: tables, counts and streams
are integers and bytes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lz77_tpu import spec as jax_spec
from lz77_tpu.models import codec as jax_codec
from lz77_tpu.ops import match as jax_match
from lz77_tpu.parallel import mesh as jax_mesh
from lz77_tpu.parallel import sharded as jax_sharded
from lz77_tpu_torch import bitio, cli, native, spec
from lz77_tpu_torch.models import codec
from lz77_tpu_torch.ops import match
from lz77_tpu_torch.parallel import mesh as mesh_lib
from lz77_tpu_torch.parallel import sharded
from lz77_tpu_torch.utils import faults

from conftest import make_text

torch.set_num_threads(1)

MESHES = [(8, 1), (4, 2), (2, 4)]


def cpu_mesh(n_data, n_win):
    return mesh_lib.make_mesh(n_data, n_win, devices=["cpu"] * (n_data * n_win))


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


@pytest.fixture(scope="module")
def payload(rng):
    return (make_text(rng, 3_000) + b"\x00" * 700
            + rng.integers(0, 256, 500, dtype=np.uint8).tobytes()
            + b"ab" * 300 + make_text(rng, 900))


def _batch(data, p, B, G):
    x = np.frombuffer(data, np.uint8)
    return codec._batch_inputs(x, x.shape[0], 0, G, G, B, p.d_limit,
                               p.len_limit)


def _shards(n, B, G, n_data):
    """Shards with valid bytes, as the JAX package counts them: each batch
    of G blocks cut into n_data spans of G / n_data blocks."""
    span = (G // n_data) * B
    return sum(1 for g0 in range(0, n, G * B) for i in range(n_data)
               if g0 + i * span < n)


# ---------------------------------------------------------------- mesh ----

@pytest.mark.parametrize("n_data,n_win", [(None, 1), (8, 1), (4, 2), (2, 4),
                                          (None, 2), (1, 1)])
def test_make_mesh_shapes_match_jax(n_data, n_win):
    m = mesh_lib.make_mesh(n_data, n_win, devices=["cpu"] * 8)
    ref = jax_mesh.make_mesh(n_data, n_win)
    assert m.shape == dict(ref.shape)
    assert m.devices.shape == ref.devices.shape
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    assert m.shape[mesh_lib.DATA_AXIS] == ref.shape[jax_mesh.DATA_AXIS]
    assert m.shape[mesh_lib.WIN_AXIS] == ref.shape[jax_mesh.WIN_AXIS]


@pytest.mark.parametrize("n_data,n_win", [(3, 3), (16, 2), (9, 1)])
def test_make_mesh_error_text_is_the_jax_text(n_data, n_win):
    with pytest.raises(ValueError) as got:
        mesh_lib.make_mesh(n_data, n_win, devices=["cpu"] * 8)
    with pytest.raises(ValueError) as ref:
        jax_mesh.make_mesh(n_data, n_win)
    assert str(got.value) == str(ref.value)


def test_default_mesh_and_sharded_entry_points_raise_without_a_card():
    _no_card()
    for call in (mesh_lib.make_mesh,
                 lambda: sharded.encode_bytes_sharded(b"abc"),
                 lambda: mesh_lib.make_mesh(devices=["cuda"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# -------------------------------------------------------- ranged match ----

@pytest.mark.parametrize("la", [2, 15, 255])
@pytest.mark.parametrize("sb", [15, 255])
def test_ranged_plain_matches_find_matches_brute_range(la, sb, payload):
    """Both plain versions of K1 over [d_lo, d_hi) against the JAX
    package's ranged brute matcher: the stream start (avail 0, then below
    d_limit), zeros, random bytes, ranges at every residue mod 4, empty and
    clipped ranges."""
    p = spec.Params(la, sb)
    dlim = p.d_limit
    # text, zeros, random bytes and a period-2 run in four blocks
    data = payload[:400] + payload[3000:3300] + payload[3700:4000] \
        + payload[4200:4404]
    arrs = _batch(data, p, 301, 4)
    t = [torch.from_numpy(a) for a in arrs]
    ranges = [(1, None), (1, 2), (2, 5), (3, 7), (4, dlim // 2 + 1),
              (5, dlim + 1), (dlim // 2, dlim + 1), (dlim, dlim + 1),
              (dlim + 1, dlim + 1), (7, 3), (0, 9), (6, 10_000)]
    # one compile: the range's bounds are traced, as in the JAX pipeline
    ref = jax.jit(jax.vmap(
        lambda b, h, r, a, v, lo, hi: jax_match.find_matches_brute_range(
            b, h, r, a, v, lo, hi, la=la, sb=sb),
        in_axes=(0, 0, 0, 0, 0, None, None)))
    for d_lo, d_hi in ranges:
        hi = dlim + 1 if d_hi is None else d_hi
        Lj, Oj = (np.asarray(a) for a in ref(*arrs, jnp.int32(d_lo),
                                              jnp.int32(hi)))
        for plain in (match.match_sweep_plain, match.match_sweep_words_plain):
            L, O = plain(*t, la=la, sb=sb, d_lo=d_lo, d_hi=d_hi)
            np.testing.assert_array_equal(L.numpy(), Lj, err_msg=str(d_lo))
            np.testing.assert_array_equal(O.numpy(), Oj, err_msg=str(d_lo))
        # the wrapper on CPU tensors is the plain sweep
        L, O = match.match_sweep(*t, la=la, sb=sb, d_lo=d_lo, d_hi=d_hi)
        np.testing.assert_array_equal(L.numpy(), Lj)
        np.testing.assert_array_equal(O.numpy(), Oj)
    assert match.match_sweep.launches == 0


def test_combine_and_split_key_match_jax(rng):
    for sb in (15, 4095, 65535):
        dlim = spec.d_limit(sb)
        L = rng.integers(0, 255, 500).astype(np.int32)
        O = np.where(L > 0, rng.integers(1, dlim + 1, 500), 0).astype(np.int32)
        key = match.combine_key(torch.from_numpy(L), torch.from_numpy(O),
                                dlim)
        ref = np.asarray(jax_match.combine_key(jnp.asarray(L), jnp.asarray(O),
                                               dlim))
        assert key.dtype == torch.int32
        np.testing.assert_array_equal(key.numpy(), ref)
        assert int(key.max()) < 1 << 24
        Ls, Os = match.split_key(key, dlim)
        np.testing.assert_array_equal(Ls.numpy(), L)
        np.testing.assert_array_equal(Os.numpy(), O)


# ------------------------------------------------------- sharded_match_fn --

@pytest.mark.parametrize("n_data,n_win", [(8, 1), (4, 2)])
def test_sharded_match_fn_tables_match_jax(n_data, n_win, payload):
    p = spec.Params(15, 255)
    arrs = _batch(payload, p, 700, 8)
    got = sharded.sharded_match_fn(cpu_mesh(n_data, n_win), p)(*arrs)
    ref = jax_sharded.sharded_match_fn(
        jax_mesh.make_mesh(n_data, n_win), jax_spec.Params(15, 255),
        matcher="brute")(*arrs)
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32 and g.device == torch.device("cpu")
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # a short batch (the host pipeline's last): ceil(5 / n_data) rows a
    # shard, trailing shards empty; the tables are the unsharded ones
    short = [a[:5] for a in arrs]
    got = sharded.sharded_match_fn(cpu_mesh(n_data, n_win), p)(*short)
    want = match.match_sweep_plain(*(torch.from_numpy(a) for a in short),
                                   la=15, sb=255)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n_data,n_win", [(8, 1), (4, 2)])
def test_host_pipeline_with_sharded_match_fn_matches_jax(n_data, n_win,
                                                         payload):
    p = spec.Params(15, 255)
    jp = jax_spec.Params(15, 255)
    m = cpu_mesh(n_data, n_win)
    mf = sharded.sharded_match_fn(m, p)
    got = codec.encode_bytes(payload, p, pipeline="host", block_size=512,
                             batch_blocks=8, match_fn=mf, device="cpu")
    jm = jax_mesh.make_mesh(n_data, n_win)
    ref = jax_codec.encode_bytes(
        payload, jp, block_size=512, batch_blocks=8,
        match_fn=jax_sharded.sharded_match_fn(jm, jp, matcher="brute"))
    assert got == ref == native.encode(payload, p)
    # a batch that the data axis does not divide: the JAX text
    with pytest.raises(ValueError) as port:
        codec.encode_bytes(payload, p, pipeline="host", block_size=512,
                           batch_blocks=6, match_fn=mf, device="cpu")
    with pytest.raises(ValueError) as jax_err:
        jax_codec.encode_bytes(
            payload, jp, block_size=512, batch_blocks=6,
            match_fn=jax_sharded.sharded_match_fn(jm, jp, matcher="brute"))
    if n_data == 4:
        assert str(port.value) == str(jax_err.value)
    else:
        assert "must be a multiple of data-axis size 8" in str(port.value)


# --------------------------------------------------- encode_bytes_sharded --

@pytest.mark.parametrize("la,sb", [(15, 15), (8, 60), (255, 255)],
                         ids=["aligned", "unaligned_width17", "la255"])
@pytest.mark.parametrize("n_data,n_win", MESHES)
def test_encode_bytes_sharded_matches_jax(n_data, n_win, la, sb, payload):
    """Several ragged batches (batch_blocks = 2 x n_data, a short last
    batch, a last block cut short); byte-aligned widths from K2's token
    bytes, 17-bit tokens through the phase-carrying native pack."""
    p = spec.Params(la, sb)
    B, G = 302, 2 * n_data
    st = codec.EncodeStats()
    got = sharded.encode_bytes_sharded(payload, p, mesh=cpu_mesh(n_data, n_win),
                                       block_size=B, batch_blocks=G, stats=st)
    ref = jax_codec.encode_bytes(payload, jax_spec.Params(la, sb),
                                 block_size=B, batch_blocks=G)
    assert got == ref
    assert (p.width % 8 == 0) == (sb != 60)
    assert st.tokens == spec.token_count(len(got) - spec.HEADER_BYTES,
                                         p.width)
    assert st.shards == _shards(len(payload), B, G, n_data)
    assert st.resyncs == st.resync_head_tokens == st.resync_bulk == 0
    assert st.blocks == -(-len(payload) // B)
    assert st.h2d_bytes > 0 and st.d2h_bytes > 0


@pytest.mark.parametrize("n_data,n_win", [(8, 1), (4, 2)])
def test_encode_bytes_sharded_defaults_match_jax(n_data, n_win, payload):
    """The reference defaults (la 15, sb 4095) on 2 KiB, the default
    batch (n_data blocks) and the default block (the input, one block)."""
    data = payload[:2048]
    m = cpu_mesh(n_data, n_win)
    ref = jax_codec.encode_bytes(data, jax_spec.Params(), block_size=256)
    assert sharded.encode_bytes_sharded(data, mesh=m, block_size=256) == ref
    st = codec.EncodeStats()
    assert sharded.encode_bytes_sharded(data, mesh=m, stats=st) == ref
    assert st.blocks == 1 and st.shards == 1


def test_empty_input(payload):
    for n_data, n_win in MESHES:
        for p in (spec.Params(), spec.Params(8, 60)):
            st = codec.EncodeStats()
            got = sharded.encode_bytes_sharded(
                b"", p, mesh=cpu_mesh(n_data, n_win), stats=st)
            assert got == jax_codec.encode_bytes(
                b"", jax_spec.Params(p.la, p.sb))
            assert st.output_bytes == spec.HEADER_BYTES and st.shards == 0


def test_batch_not_divided_by_the_data_axis_raises_the_jax_text(payload):
    p = spec.Params(15, 15)
    with pytest.raises(ValueError) as got:
        sharded.encode_bytes_sharded(payload, p, mesh=cpu_mesh(4, 2),
                                     block_size=512, batch_blocks=6)
    with pytest.raises(ValueError) as ref:
        jax_sharded.encode_bytes_sharded(
            payload, jax_spec.Params(15, 15), mesh=jax_mesh.make_mesh(4, 2),
            block_size=512, batch_blocks=6, interpret=True)
    assert str(got.value) == str(ref.value)
    x = np.frombuffer(payload, np.uint8)
    with pytest.raises(ValueError) as got:
        next(sharded.iter_batches_sharded(x, p, mesh=cpu_mesh(4, 2),
                                          block_size=512, batch_blocks=6))
    assert str(got.value) == str(ref.value)
    with pytest.raises(ValueError, match="byte-aligned"):
        next(sharded.iter_batches_sharded(x, spec.Params(8, 60),
                                          mesh=cpu_mesh(4, 2),
                                          block_size=512, batch_blocks=8))


def test_one_case_against_the_jax_sharded_pipeline(rng):
    """JAX's own sharded walk pipeline (its walk kernel interpreted): the
    same stream and the same shard count; it resyncs where the port's
    chained walks have nothing to resync."""
    data = b"\x00" * 3000 + make_text(rng, 1500) + b"\x01" * 1500
    p = spec.Params(15, 15)
    jst = jax_codec.EncodeStats()
    ref = jax_sharded.encode_bytes_sharded(
        data, jax_spec.Params(15, 15), mesh=jax_mesh.make_mesh(n_data=2),
        block_size=512, batch_blocks=4, interpret=True, stats=jst)
    st = codec.EncodeStats()
    got = sharded.encode_bytes_sharded(data, p, mesh=cpu_mesh(2, 1),
                                       block_size=512, batch_blocks=4,
                                       stats=st)
    assert got == ref
    assert st.shards == jst.shards == _shards(len(data), 512, 4, 2)
    assert jst.resyncs >= 1 and st.resyncs == 0


def test_iter_batches_sharded_resumes_mid_stream(payload):
    """Resuming at a batch with the recorded entry gives the tail of the
    uninterrupted run, batch for batch; e_in / e_out chain."""
    p = spec.Params(15, 15)
    x = np.frombuffer(payload, np.uint8)
    kw = dict(mesh=cpu_mesh(4, 2), block_size=400, batch_blocks=4)
    full = list(sharded.iter_batches_sharded(x, p, **kw))
    assert len(full) == -(-len(payload) // 1600)
    for a, b in zip(full, full[1:]):
        assert a[2] == b[1]
    tail = list(sharded.iter_batches_sharded(
        x, p, start_batch=2, entry=full[1][2], **kw))
    assert tail == full[2:]
    assert b"".join(b[4] for b in full) == native.encode(payload, p)[4:]


# ------------------------------------------------------------- the file ----

def test_encode_file_sharded_with_manifest_fault_and_resume(tmp_path,
                                                            payload):
    p = spec.Params(15, 15)
    ip, op, mp = (str(tmp_path / n) for n in ("in", "out.lz", "m.json"))
    with open(ip, "wb") as f:
        f.write(payload)
    want = jax_codec.encode_bytes(payload, jax_spec.Params(15, 15),
                                  block_size=1024)
    kw = dict(pipeline="sharded", mesh=cpu_mesh(4, 2), block_size=256,
              batch_blocks=8, manifest_path=mp)
    with pytest.raises(RuntimeError, match="injected fault"):
        codec.encode_file(ip, op, p, fault_injector=faults.FaultInjector(
            {1: 1}), **kw)
    import json

    with open(mp) as f:
        man = json.load(f)
    assert len(man["blocks"]) == 1 and man["pipeline"] == "sharded"
    st = codec.EncodeStats()
    codec.encode_file(ip, op, p, resume=True, stats=st, **kw)
    with open(op, "rb") as f:
        assert f.read() == want
    assert st.shards == _shards(len(payload), 256, 8, 4) - 4
    # without a manifest, and through compress_file
    import lz77_tpu_torch

    lz77_tpu_torch.compress_file(ip, op, 15, 15, pipeline="sharded",
                                 mesh=cpu_mesh(2, 4), block_size=512)
    with open(op, "rb") as f:
        assert f.read() == want
    codec.encode_file(ip, op, p, pipeline="sharded", device="cpu")
    with open(op, "rb") as f:
        assert f.read() == want


def test_encode_file_sharded_rejections(tmp_path, payload):
    ip, op = str(tmp_path / "in"), str(tmp_path / "out")
    with open(ip, "wb") as f:
        f.write(payload[:1000])
    with pytest.raises(ValueError, match="byte-aligned") as port:
        codec.encode_file(ip, op, spec.Params(8, 60), pipeline="sharded",
                          device="cpu")
    with pytest.raises(ValueError, match="byte-aligned") as ref:
        jax_codec.encode_file(ip, op, jax_spec.Params(8, 60),
                              pipeline="sharded")
    assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError, match="batch_blocks=6 must be a multiple of data-axis size 4"):
        codec.encode_file(ip, op, spec.Params(), pipeline="sharded",
                          mesh=cpu_mesh(4, 2), batch_blocks=6)
    with pytest.raises(TypeError, match="mesh"):
        codec.encode_file(ip, op, spec.Params(), pipeline="fused",
                          mesh=cpu_mesh(4, 2), device="cpu")


# --------------------------------------------------- decided differences --

def test_single_controller_mesh_members_may_share_a_device(payload):
    """A mesh is a grid of devices one process drives; a device may repeat
    (the JAX mesh needs as many devices as members)."""
    m = mesh_lib.make_mesh(4, 2, devices=["cpu"] * 8)
    assert len({str(d) for d in m.devices.flat}) == 1
    with pytest.raises(ValueError, match="needs 8 devices, have 1"):
        mesh_lib.make_mesh(8, 1, devices=["cpu"])
    p = spec.Params(15, 255)
    assert (sharded.encode_bytes_sharded(payload, p, mesh=m, block_size=512)
            == sharded.encode_bytes_sharded(payload, p, device="cpu",
                                            block_size=512))
    with pytest.raises(TypeError, match="mesh or a device"):
        sharded.encode_bytes_sharded(payload, p, mesh=m, device="cpu")


@pytest.mark.parametrize("case", ["never_merge_runs", "zeros_past_window"])
def test_exact_shard_chaining_on_the_jax_resync_cases(case, rng):
    """JAX's resync cases (tests/test_parallel.py): runs whose chains from
    different entries never merge, and zeros past its resync window.  Every
    shard here walks from its true entry: the same stream, no resync, no
    re-walk, and the fetch is the token bytes and the counts alone."""
    p = spec.Params(15, 15)
    if case == "never_merge_runs":
        data = b"\x00" * 20_000 + make_text(rng, 4_000) + b"\x01" * 9_000
        mesh, B, G = cpu_mesh(4, 1), 1024, 8
    else:
        data = make_text(rng, 5_000) + b"\x00" * 75_000
        mesh, B, G = cpu_mesh(2, 1), 32768, 2
    st = codec.EncodeStats()
    got = sharded.encode_bytes_sharded(data, p, mesh=mesh, block_size=B,
                                       batch_blocks=G, stats=st)
    assert got == jax_codec.encode_bytes(data, jax_spec.Params(15, 15),
                                         block_size=B, batch_blocks=G)
    assert st.resyncs == st.resync_head_tokens == st.resync_bulk == 0
    assert st.shards == _shards(len(data), B, G, mesh.shape["data"])
    batches = -(-len(data) // (B * G))
    assert st.d2h_bytes == (st.tokens * p.width // 8
                            + 4 * (st.shards + batches))


def test_la_above_128_on_the_sharded_file_pipeline(tmp_path, payload):
    """The JAX file path refuses la > 128 (its walk kernel's limit); the
    port's K2 covers la 2..255."""
    ip, op = str(tmp_path / "in"), str(tmp_path / "out")
    with open(ip, "wb") as f:
        f.write(payload)
    with pytest.raises(ValueError, match="la <= 128"):
        jax_codec.encode_file(ip, op, jax_spec.Params(200, 255),
                              pipeline="sharded")
    codec.encode_file(ip, op, spec.Params(200, 255), pipeline="sharded",
                      mesh=cpu_mesh(4, 2), block_size=700)
    with open(op, "rb") as f:
        assert f.read() == jax_codec.encode_bytes(
            payload, jax_spec.Params(200, 255), block_size=700)


def test_host_devices_name_members_on_the_device_flag(tmp_path):
    """--host-devices N gives the mesh N members on --device (cpu when the
    flag is absent, as the JAX flag implies --platform cpu); with --device
    cuda they sit on the card, so without one the run is an error."""
    args = cli.build_parser().parse_args(
        ["--host-devices", "8", "--mesh", "4x2", "--device", "cpu"])
    kw = {}
    cli._sharded_kwargs(args, kw)
    m = kw["mesh"]
    assert m.shape == {"data": 4, "win": 2} and kw["batch_blocks"] == 8
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    ip = tmp_path / "in"
    ip.write_bytes(b"members on the device flag " * 30)
    _no_card()
    rc = cli.main(["-c", "-i", str(ip), "-o", str(tmp_path / "o"),
                   "--pipeline", "sharded", "--device", "cuda",
                   "--host-devices", "8", "--mesh", "4x2"])
    assert rc == 1 and not (tmp_path / "o").exists()


def test_window_split_is_not_rounded_to_32(payload):
    """The JAX package rounds a member's span up to 32 for its bit-plane
    sweep; here per = ceil(d_limit / n_win), and any split gives the same
    combined tables."""
    assert sharded._win_ranges(4094, 3) == [(1, 1366), (1366, 2731),
                                           (2731, 4095)]
    assert sharded._win_ranges(254, 4) == [(1, 65), (65, 129), (129, 193),
                                          (193, 255)]
    p = spec.Params(15, 255)
    arrs = _batch(payload, p, 700, 4)
    want = match.match_sweep_plain(*(torch.from_numpy(a) for a in arrs),
                                   la=15, sb=255)
    for n_win in (1, 3, 5, 7):
        got = sharded.sharded_match_fn(cpu_mesh(1, n_win), p)(*arrs)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_chunk_matcher_runs_only_without_a_win_axis(payload):
    p = spec.Params(15, 255)
    with pytest.raises(ValueError, match="sweep"):
        sharded.sharded_match_fn(cpu_mesh(4, 2), p, matcher="chunk")
    with pytest.raises(ValueError, match="sweep"):
        sharded.encode_bytes_sharded(payload, p, mesh=cpu_mesh(4, 2),
                                     matcher="chunk")
    with pytest.raises(ValueError, match="unknown matcher"):
        sharded.sharded_match_fn(cpu_mesh(8, 1), p, matcher="nope")
    got = sharded.encode_bytes_sharded(payload, p, mesh=cpu_mesh(8, 1),
                                       matcher="chunk", block_size=600)
    assert got == native.encode(payload, p)
    # the JAX package's XLA matchers run on both axes (on the win axis as
    # their ranged forms)
    for name in ("brute", "sorted", "chunked", "bitplane"):
        for shape in ((8, 1), (2, 2)):
            assert sharded.encode_bytes_sharded(
                payload, p, mesh=cpu_mesh(*shape), matcher=name,
                block_size=600) == native.encode(payload, p), (name, shape)


def test_the_pipeline_step_is_not_ported_and_encode_bytes_has_no_sharded():
    """The name dates from before ``make_sharded_pipeline_step`` (the JAX
    package's block-aligned entry-0 dry-run step) was ported; it pins the
    step now: it makes a step as the JAX one does, whose batch must split
    over the data axis (the JAX text), and which no pipeline runs.
    ``codec.encode_bytes`` keeps its two pipelines: ``encode_bytes_sharded``
    is the bytes entry point."""
    assert hasattr(jax_sharded, "make_sharded_pipeline_step")
    step = sharded.make_sharded_pipeline_step(cpu_mesh(4, 2), spec.Params())
    assert callable(step)
    z = torch.zeros
    with pytest.raises(ValueError, match="multiple of data-axis size 4"):
        step(z((6, 8), dtype=torch.uint8), z((6, 4095), dtype=torch.uint8),
             z((6, 14), dtype=torch.uint8), z(6, dtype=torch.int32),
             torch.full((6,), 8, dtype=torch.int32))
    with pytest.raises(ValueError, match="sweep"):
        sharded.make_sharded_pipeline_step(cpu_mesh(4, 2), spec.Params(),
                                           matcher="chunk")
    with pytest.raises(ValueError, match="unknown pipeline"):
        codec.encode_bytes(b"abc", pipeline="sharded", device="cpu")
    with pytest.raises(TypeError, match="match_fn"):
        codec.encode_bytes(b"abc", pipeline="fused", device="cpu",
                           match_fn=sharded.sharded_match_fn(
                               cpu_mesh(1, 1), spec.Params()))


@pytest.mark.parametrize("n_data,n_win", [(8, 1), (4, 2)])
def test_pipeline_step_matches_jax(n_data, n_win, rng):
    """The block-aligned step's (off, len, next, counts) against the JAX
    package's step on the same batch (``tests/test_parallel.py``'s), with
    tolerance 0; the stream its tokens make decodes to the input."""
    data = make_text(rng, 8 * 512)
    p = spec.Params(15, 255)
    B, G = 512, 8
    x = np.frombuffer(data, np.uint8)
    H, R = p.d_limit, p.len_limit
    halos = np.zeros((G, H), np.uint8)
    rights = np.zeros((G, R), np.uint8)
    for b in range(1, G):
        halos[b] = x[b * B - H : b * B]
        rights[b - 1] = x[b * B : b * B + R]
    arrs = (x.reshape(G, B).copy(), halos, rights,
            np.array([0] + [H] * (G - 1), np.int32),
            np.array([B + R] * (G - 1) + [B], np.int32))
    want = jax_sharded.make_sharded_pipeline_step(
        jax_mesh.make_mesh(n_data, n_win), jax_spec.Params(15, 255)
    )(*(jnp.asarray(a) for a in arrs))
    got = sharded.make_sharded_pipeline_step(cpu_mesh(n_data, n_win), p)(
        *(torch.from_numpy(a) for a in arrs))
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    off, ln, nxt, counts = (t.numpy() for t in got)
    stream = bitio.concat_token_bits(
        [bitio.tokens_to_bits(off[i, : counts[i]], ln[i, : counts[i]],
                              nxt[i, : counts[i]], p) for i in range(G)], p)
    assert native.decode(stream) == data


def test_walk_step_passes_the_entry_through_shards_without_bytes(payload):
    """The step on a batch padded as the JAX package pads it (G rows, the
    trailing ones past valid_total): those shards launch nothing and pass
    their entry through; the rest give the unpadded batch's words."""
    p = spec.Params(15, 15)
    x = np.frombuffer(payload, np.uint8)
    B, n = 512, 3 * 512 + 100
    step = sharded.make_sharded_walk_step(cpu_mesh(4, 2), p)
    padded = codec._batch_inputs(x[:n], n, 0, 4, 8, B, p.d_limit, p.len_limit)
    real = codec._batch_inputs(x[:n], n, 0, 4, 4, B, p.d_limit, p.len_limit)
    entry = torch.tensor([3], dtype=torch.int32)
    w1, c1, e1 = step(*padded, n, entry, shard_rows=2)
    w2, c2, e2 = step(*real, n, entry, shard_rows=2)
    assert c1[2] is None and c1[3] is None and c2[2] is None
    assert e1[2] is e1[1] and e1[3] is e1[1]
    for d in (0, 1):
        c = int(c2[d])
        assert int(c1[d]) == c and torch.equal(w1[d][:c], w2[d][:c])
    assert int(e1[-1]) == int(e2[-1])
    # from entry 0 the shards' tokens are the serial stream's payload
    w, c, _ = step(*padded, n, torch.zeros(1, dtype=torch.int32),
                   shard_rows=2)
    got = b"".join(wd[: int(cd)].numpy().view(np.uint8).reshape(-1, 4)[:, :2]
                   .tobytes() for wd, cd in zip(w, c) if cd is not None)
    assert got == jax_codec.encode_bytes(payload[:n], jax_spec.Params(15, 15),
                                         block_size=B)[4:]


def test_a_failed_batch_is_retried_from_the_previous_exit(payload,
                                                          monkeypatch):
    """A walk that fails midway through a batch (after some of its shards
    walked) is retried whole: the retry starts again from the previous
    batch's exit tensor, and the stream is the serial one."""
    from lz77_tpu_torch.ops import parse_walk

    real, calls = parse_walk.walk_parse_pack, []

    def flaky(*a, **k):
        calls.append(1)
        if len(calls) == 6:  # batch 1's second shard
            raise RuntimeError("injected walk failure")
        return real(*a, **k)

    monkeypatch.setattr(parse_walk, "walk_parse_pack", flaky)
    p = spec.Params(15, 15)
    st = codec.EncodeStats()
    got = sharded.encode_bytes_sharded(payload, p, mesh=cpu_mesh(4, 1),
                                       block_size=512, batch_blocks=4,
                                       stats=st)
    assert st.retries == 1
    assert got == jax_codec.encode_bytes(payload, jax_spec.Params(15, 15),
                                         block_size=512)
