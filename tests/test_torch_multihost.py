"""Port multi-process encode (lz77_tpu_torch.parallel.distributed) against
the JAX package's single-process encoder.

Real multi-process runs: 2 and 4 local ranks of ``python -m
lz77_tpu_torch.parallel.distributed`` on a Gloo group, each on the CPU
(``--device cpu``: the kernels' plain versions), started by
``distributed.launch``.  The cases are the JAX package's
``tests/test_multihost.py``: the in-memory ordered collection, the shared-
file ordered writes (byte-aligned and 21-bit tokens), a retried fault, the
fused route, and runs of zeros that carry the entry across every boundary
and never resync.  Every stream is held with tolerance 0 against the JAX
package's ``lz77_tpu.models.codec.encode_bytes`` of the same bytes and
decoded back.  A timeout is a failure, not a skip.

The JAX file's scaling measurement is not here: it waits for a quiet host,
and ranks that share a busy CPU measure the load.  ``chip_smoke.py`` and
``experiments.multihost_bigrun`` measure the rates on the card.
"""

import concurrent.futures
import functools
import json
import os

import numpy as np
import pytest
import torch

from lz77_tpu import spec as jax_spec
from lz77_tpu.models import codec as jax_codec
from lz77_tpu.parallel import distributed as jax_dist
import lz77_tpu_torch as lt
from lz77_tpu_torch import native, spec
from lz77_tpu_torch.experiments import bigrun_r5, multihost_bigrun
from lz77_tpu_torch.models import codec
from lz77_tpu_torch.parallel import distributed
from lz77_tpu_torch.utils import faults

from conftest import make_text

torch.set_num_threads(1)

TIMEOUT = 240  # seconds a run of ranks may take; longer fails


@pytest.fixture(scope="module")
def payload_data():
    return make_text(np.random.default_rng(0xC57D), 24000)


@pytest.fixture(scope="module")
def runs_data():
    """Runs of zeros across every rank boundary (the JAX entry-carry case)."""
    rng = np.random.default_rng(5)
    return (b"\x00" * 9000 + make_text(rng, 5000)) * 4


@functools.lru_cache(maxsize=None)
def jax_single(data, la, sb, block_size, batch_blocks):
    """The JAX package's single-process stream (cached: cases share it)."""
    return jax_codec.encode_bytes(
        data, jax_spec.Params(la=la, sb=sb), block_size=block_size,
        batch_blocks=batch_blocks)


def run_ranks(tmp_path, data, nproc, *, mode="bytes", la=15, sb=255,
              block_size=1024, batch_blocks=2, extra=()):
    """(stream, rank reports) of ``nproc`` local ranks on ``data``, the
    stream held against the JAX package's (computed while the ranks run)
    and decoded back."""
    src = tmp_path / f"in_{nproc}_{mode}.bin"
    out = tmp_path / f"out_{nproc}_{mode}.lz"
    src.write_bytes(data)
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        want = ex.submit(jax_single, data, la, sb, block_size, batch_blocks)
        reports = distributed.launch(
            ["-i", str(src), "-o", str(out), "-l", str(la), "-s", str(sb),
             "--block-size", str(block_size), "--batch-blocks",
             str(batch_blocks), "--mode", mode, "--device", "cpu", *extra],
            nproc, timeout=TIMEOUT)
        want = want.result()
    assert [r["rank"] for r in reports] == list(range(nproc))
    assert all(r["nproc"] == nproc for r in reports)
    stream = out.read_bytes()
    assert stream == want
    assert lt.decompress(stream, device="cpu") == data
    return stream, reports


# ------------------------------------------------- the JAX file's cases ---

@pytest.mark.parametrize("nproc", [2, 4])
def test_multihost_bytes_identical_stream(nproc, tmp_path, payload_data):
    """20-bit tokens: the host route, each rank's words packed at its bit
    phase and OR-merged by rank 0."""
    stream, reports = run_ranks(tmp_path, payload_data, nproc)
    # every rank counts the stream's tokens
    T = spec.token_count(len(stream) - spec.HEADER_BYTES, 20)
    assert [r["tokens"] for r in reports] == [T] * nproc


@pytest.mark.parametrize("la,sb", [(15, 255), (15, 300)])
def test_multihost_file_parallel_pwrite(tmp_path, payload_data, la, sb):
    """Shared-file ordered writes at 4 ranks; sb=300 gives 21-bit tokens,
    so rank boundaries fall mid-byte: the partial-byte merge."""
    run_ranks(tmp_path, payload_data, 4, mode="file", la=la, sb=sb)
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".partial")]


def test_multihost_fault_retry(tmp_path, payload_data):
    """An injected fault on batch 0 is retried by the rank that holds it;
    the stream is still byte-identical."""
    _, reports = run_ranks(tmp_path, payload_data, 2,
                           extra=("--fail-batches", "0:1"))
    assert [r["retries"] for r in reports] == [1, 0]


@pytest.mark.parametrize("nproc", [2, 4])
def test_multihost_fused_pipeline_identical_stream(nproc, tmp_path,
                                                   payload_data):
    """Byte-aligned widths take the fused route: device-packed payload and
    exact (la,) range maps from one speculative pass."""
    run_ranks(tmp_path, payload_data, nproc, sb=4095, block_size=8192)


def test_multihost_fused_head_window_splice(tmp_path, payload_data):
    """A rank entered mid-token whose chains meet inside the head window
    (ranges of two blocks, a window of one; 16-bit tokens): the splice
    path, no re-run."""
    data = payload_data[:8000]
    _, reports = run_ranks(tmp_path, data, 4, sb=15)
    spliced = [r for r in reports if r["resyncs"] and not r["resync_bulk"]]
    assert spliced


@pytest.mark.parametrize("mode,batch_blocks", [("bytes", 4), ("file", 7)])
def test_multihost_fused_entry_carry_and_runs(mode, batch_blocks, tmp_path,
                                              runs_data):
    """Runs of zeros put a nonzero entry on every rank boundary, and the
    chains from entry 0 and the true entry never meet: the exact re-run
    path, in bytes mode over two batches a rank (the entry riding from
    batch to batch); file mode goes through the ordered writes too, its
    range one batch (streams do not depend on the batch size)."""
    _, reports = run_ranks(tmp_path, runs_data, 4, mode=mode, sb=4095,
                           block_size=2048, batch_blocks=batch_blocks)
    assert sum(r["resync_bulk"] for r in reports) >= 1


# ---------------------------------------------------- in-process cases ---

def test_block_range_and_global_bit_offsets_match_jax():
    for nb in (0, 1, 5, 8, 13, 40):
        for nproc in (1, 2, 3, 4, 7):
            got = [distributed.block_range(nb, nproc, r) for r in range(nproc)]
            assert got == [jax_dist.block_range(nb, nproc, r)
                           for r in range(nproc)]
            assert got[0][0] == 0 and got[-1][1] == nb
    counts = np.random.default_rng(3).integers(0, 900, 17)
    for width in (16, 20, 21, 24, 32):
        np.testing.assert_array_equal(
            distributed.global_bit_offsets(counts, width),
            jax_dist.global_bit_offsets(counts, width))


@pytest.mark.parametrize("la,sb", [(15, 255), (15, 4095)])
def test_world_of_one_solo_and_forced(la, sb, payload_data):
    """No group: one process, rank 0; the solo fast path (the
    single-process encoder) and ``force=True`` (the distributed code) give
    the JAX stream, and the forced run reports its work."""
    data = payload_data[:3000]
    assert distributed.process_count() == 1
    assert distributed.process_index() == 0
    want = jax_single(data, la, sb, 1024, 2)
    p = spec.Params(la, sb)
    kw = dict(block_size=1024, batch_blocks=2, device="cpu")
    assert distributed.encode_bytes_multihost(data, p, **kw) == want
    work, st = [], codec.EncodeStats()
    assert distributed.encode_bytes_multihost(
        data, p, force=True, work_seconds=work, stats=st, **kw) == want
    assert set(work[0]) == {"wall", "cpu", "collectives"}
    assert st.tokens and st.output_bytes == len(want)
    assert distributed.encode_bytes_multihost(
        b"", p, force=True, **kw) == jax_single(b"", la, sb, 1024, 2)


def test_solo_path_with_a_fault_injector_keeps_the_distributed_code(
        payload_data):
    """A fault injector counts batch starts (blocks) in the distributed
    code, so a world of one with one keeps it: the fault is retried."""
    data = payload_data[:6000]
    inj = faults.FaultInjector({2: 1})
    st = codec.EncodeStats()
    got = distributed.encode_bytes_multihost(
        data, spec.Params(15, 255), block_size=1024, batch_blocks=2,
        fault_injector=inj, stats=st, device="cpu")
    assert got == jax_single(data, 15, 255, 1024, 2)
    assert inj.calls.count(2) == 2 and st.retries == 1


def test_range_encoder_errors_are_the_jax_texts():
    for params, pipeline in ((spec.Params(15, 255), "fused"),
                             (spec.Params(15, 4095), "bogus")):
        jp = jax_spec.Params(params.la, params.sb)
        with pytest.raises(ValueError) as want:
            jax_dist._range_encoder(jp, pipeline)
        with pytest.raises(ValueError) as got:
            distributed._range_encoder(params, pipeline)
        assert str(got.value) == str(want.value)
    assert (distributed._range_encoder(spec.Params(15, 255), "auto")
            is distributed._encode_range)
    assert (distributed._range_encoder(spec.Params(15, 4095), "auto")
            is distributed._encode_range_fused)


def test_chunk_is_refused_on_the_fused_route(payload_data, tmp_path):
    """The name dates from when the fused route ran K1 only: matcher
    ``chunk`` runs there now (``encode_batch_device`` takes any matcher),
    alone and in the distributed code, bytes and files, and ``auto`` picks
    the route by width alone."""
    p = spec.Params(15, 4095)
    data = payload_data[:3000]
    want = jax_single(data, 15, 4095, 1024, 2)
    for pipeline in ("fused", "auto"):
        for force in (False, True):
            assert distributed.encode_bytes_multihost(
                data, p, matcher="chunk", force=force, pipeline=pipeline,
                block_size=1024, device="cpu") == want
    src = tmp_path / "in"
    src.write_bytes(data)
    distributed.encode_file_multihost(str(src), str(tmp_path / "o"), p,
                                      matcher="chunk", block_size=1024,
                                      device="cpu")
    assert (tmp_path / "o").read_bytes() == want
    # the host route takes it
    got = distributed.encode_bytes_multihost(
        data, p, matcher="chunk", pipeline="host",
        force=True, block_size=1024, device="cpu")
    assert got == want


def test_xla_matcher_names_are_refused(payload_data):
    """The name dates from when the port refused the JAX package's XLA
    matchers: they run on both routes now (the JAX module's default,
    ``chunked``, among them); an unknown name is refused."""
    data = payload_data[:1500]
    want = jax_single(data, 15, 4095, 512, 2)
    for name in ("chunked", "bitplane", "brute", "sorted"):
        for pipeline in ("fused", "host"):
            assert distributed.encode_bytes_multihost(
                data, matcher=name, pipeline=pipeline, force=True,
                block_size=512, device="cpu") == want, (name, pipeline)
    with pytest.raises(ValueError, match="unknown matcher"):
        distributed.encode_bytes_multihost(data, matcher="nope",
                                           device="cpu")


@pytest.mark.parametrize("la,sb", [(15, 300), (15, 15)])
def test_file_scratch_is_gone_after_success_and_after_an_error(
        la, sb, tmp_path, payload_data):
    """The per-rank scratch file beside the output goes on success and on
    error (a fault that outlasts the retries)."""
    data = payload_data[:8000]
    src, out = tmp_path / "in", tmp_path / "out.lz"
    src.write_bytes(data)
    p = spec.Params(la, sb)
    st = codec.EncodeStats()
    distributed.encode_file_multihost(str(src), str(out), p, block_size=2048,
                                      batch_blocks=2, stats=st,
                                      device="cpu")
    assert out.read_bytes() == jax_single(data, la, sb, 2048, 2)
    assert st.output_bytes == out.stat().st_size
    assert sorted(os.listdir(tmp_path)) == ["in", "out.lz"]
    with pytest.raises(RuntimeError, match="injected fault"):
        distributed.encode_file_multihost(
            str(src), str(tmp_path / "bad.lz"), p, block_size=2048,
            batch_blocks=2, retries=1, device="cpu",
            fault_injector=faults.FaultInjector({2: 5}))
    assert sorted(os.listdir(tmp_path)) == ["in", "out.lz"]


def test_lay_out_splits_chunks_at_any_bit_phase():
    """The copy into place a chunk at a time (here a few tokens a chunk)
    lays down the bits one pack of all tokens does, from every start
    phase, with the shared first and last bytes left to the merge."""
    p = spec.Params(15, 300)  # 21-bit tokens
    rng = np.random.default_rng(9)
    T = 301
    off = rng.integers(0, 300, T)
    ln = rng.integers(0, 15, T)
    nxt = rng.integers(0, 256, T)
    spool = distributed._Spool(np.uint32, 1)
    spool.write(distributed._token_words(off, ln, nxt, p))
    r = distributed._Range(np.zeros(1, np.int64), spool)
    for start_bit in (32, 33, 39, 45, 1000):
        want, bits = native.pack_tokens_phase(off, ln, nxt, p,
                                                 start_bit % 8)
        base = start_bit // 8
        got = np.zeros(want.shape[0], np.uint8)

        def put(pos, b):
            got[pos - base : pos - base + b.shape[0]] = b

        partial = distributed._lay_out(_Chunked(r, 7), p, start_bit, put)
        for pos, val in partial:
            assert got[pos - base] == 0
            got[pos - base] = val
        np.testing.assert_array_equal(got, want)
        assert [pos for pos, _ in partial] == (
            ([base] if start_bit % 8 else [])
            + ([(start_bit + bits) // 8] if (start_bit + bits) % 8 else []))


class _Chunked:
    """A range whose payload comes a few tokens a chunk."""

    def __init__(self, rng, tokens):
        self.rng, self.k = rng, tokens

    def chunks(self):
        return self.rng.chunks(self.k)


# ------------------------------------------------ the experiment drivers ---

def test_multihost_bigrun_tiny(tmp_path, capsys):
    """The driver at 0.001 GiB on 1 and 2 CPU ranks: every phase ok (the
    oracle's only without C sources, and then null)."""
    assert multihost_bigrun.main(["0.001", "1", "2", str(tmp_path),
                                  "--device", "cpu"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    by = {ln["phase"]: ln for ln in lines}
    assert by["corpus"]["bytes"] == int(0.001 * (1 << 30))
    assert by["identity-2proc"]["ok"] and by["self-decode"]["ok"]
    assert by["oracle-decode"]["ok"] in (True, None)
    two = by["multihost-2proc"]
    assert len(two["per_host"]) == 2 and "scaling_efficiency_vs_1proc" in two
    assert all({"wall", "peak_rss_mb", "launches"} <= set(r)
               for r in two["per_host"])
    stream = (tmp_path / "out_1.lz").read_bytes()
    data = (tmp_path / "big.bin").read_bytes()
    assert stream == native.encode(data, spec.Params(15, 15))


def test_bigrun_r5_tiny(tmp_path, capsys):
    assert bigrun_r5.main(["0.001", str(tmp_path), "--device", "cpu"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    by = {ln["phase"]: ln for ln in lines}
    for tag in ("native-decode", "cli-decode", "cli-decode-device"):
        assert by[f"{tag}-verify"]["ok"], tag
    assert by["cli-decode"]["decode_backend"] == "native-streamed"
    assert by["cli-decode-device"]["decode_backend"] == "device-walk-streamed"
    assert by["native-encode"]["peak_rss_mb"] > 0
    assert by["oracle-decode"]["ok"] in (True, None)
    data = (tmp_path / "big.bin").read_bytes()
    assert (tmp_path / "big.lz").read_bytes() == native.encode(data)
