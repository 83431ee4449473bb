"""``encode.overlap_share.files`` against hand-worked runs, and, on the card,
the fused encode's transfer path it reads: batches uploaded while the batch
before still runs, page-locked buffers reused from call to call, and the
stream of the pageable route.

    python -m pytest codec_bench/tests/test_bench_overlap.py -m card
"""

from types import SimpleNamespace

import numpy as np
import pytest

from codec_bench import pool, registry, runner

NAME = "encode.overlap_share.files"


def _run(*stats):
    calls = [runner.Call("compress", i, 0.0, 0.0, 1, 1, s)
             for i, s in enumerate(stats)]
    calls.insert(1, runner.Call("decompress", 9, 0.0, 0.0, 1, 1, None))
    return SimpleNamespace(
        calls_of=lambda op: [c for c in calls if c.op == op])


def _read(run):
    return registry.reader(NAME).read(run)


def test_reads_the_program_counter():
    # 7 batches (6 after a first) and 5 of them hidden, 1 batch, 3 batches
    # (2 after a first) and 2 hidden: 7 of 8
    run = _run(SimpleNamespace(batches=7, batches_overlapped=5),
               SimpleNamespace(batches=1, batches_overlapped=0),
               SimpleNamespace(batches=3, batches_overlapped=2))
    assert _read(run) == pytest.approx(100 * 7 / 8)


def test_none_without_the_counter_or_a_second_batch():
    assert _read(_run(SimpleNamespace(batches=4, batches_overlapped=3),
                      SimpleNamespace(phases=None))) is None
    assert _read(_run(SimpleNamespace(batches=1, batches_overlapped=0),
                      SimpleNamespace(batches=1, batches_overlapped=0))) \
        is None
    assert _read(_run()) is None


def _pageable_stream(x: np.ndarray, dev) -> bytes:
    """The default geometry's stream from ``codec._batch_inputs``' rows,
    each uploaded from pageable memory, the payloads joined."""
    import torch

    import lz77_tpu_torch
    from lz77_tpu_torch import bitio
    from lz77_tpu_torch.models import codec, fused

    p = lz77_tpu_torch.Params()
    B, G = fused.DEFAULT_BLOCK_SIZE, fused.DEFAULT_BATCH_BLOCKS
    n = x.shape[0]
    nblocks = -(-n // B)
    entry = torch.zeros(1, dtype=torch.int32, device=dev)
    parts = [bitio.header_bytes(p)]
    for g0 in range(0, nblocks, G):
        gn = min(G, nblocks - g0)
        rows = [torch.from_numpy(a).to(dev) for a in codec._batch_inputs(
            x, n, g0, gn, gn, B, p.d_limit, p.len_limit)]
        payload, _, total, entry = fused.encode_batch_walk(
            *rows, min(gn * B, n - g0 * B), entry, la=p.la, sb=p.sb,
            device=dev)
        nbytes = int(total) * (p.width // 8)
        parts.append(payload[:nbytes].cpu().numpy().tobytes())
    return b"".join(parts)


@pytest.mark.card
def test_fused_encode_overlaps_and_reuses_its_buffers(cuda_card):
    """Five 8 MiB batches of the records class (``nci``'s: K1 takes longer
    than the host's work on a batch, whose payload is small): at least
    three of the four after the first are uploaded while the one before
    still runs; a second call allocates no page-locked buffer; the stream
    is the pageable route's."""
    import torch

    import lz77_tpu_torch
    from lz77_tpu_torch.models import codec
    from lz77_tpu_torch.utils import transfer

    data = pool.make_file("records", 40 << 20, 2**31 + 41, 3)
    x = np.frombuffer(data, np.uint8)
    dev = torch.device(cuda_card)
    out = lz77_tpu_torch.compress(data, device=cuda_card)
    allocated = transfer.allocations(dev)
    st = codec.EncodeStats()
    assert lz77_tpu_torch.compress(data, stats=st, device=cuda_card) == out
    assert transfer.allocations(dev) == allocated
    assert st.batches == 5 and st.batches_overlapped >= 3, st
    assert out == _pageable_stream(x, dev)
