"""Device-resident fused encode: match -> LOX -> walk parse + pack per batch.

Replaces the reference's serial token loop (lz77.c:89-136) AND its bit
writer (lz77.c:246-251, bitio.c:203-236) with one device computation per
batch; the host only uploads raw bytes and fetches the packed payload prefix
and two scalars.  Token widths must be byte multiples (the default 12+4+8 =
24 bits is).

A batch is G consecutive blocks, one contiguous span of the input.  Per
batch: the match sweep gives (L, O) for every position (``ops.match``);
``build_lox`` fuses them with the bytes into one word per position; the
walk kernel (``ops.parse_walk``) follows the greedy chain from the entry
the previous batch left and writes packed token words, their count and the
next entry; the words are cut to ``width/8`` bytes each.  Streams are
byte-identical to the numpy executable spec and the native host encoder.

The batch inputs keep the JAX package's contract — (G, B) blocks, each with
its own halo and right extension — so the two packages are compared like
with like.  Shapes cost nothing to change in eager PyTorch, so the last
batch carries only its real blocks, a block is no longer than the input,
and the host fetches the exact payload prefix.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import bitio, spec
from .. import device as device_lib
from ..ops import match as match_ops
from ..ops import parse_walk
from ..utils import faults as faults_lib
from ..utils import metrics as metrics_lib

# Batch geometry: 8 blocks of 1 MiB.  An 8 MiB span gives the match kernel
# 16 Ki thread blocks and the walk 2 Ki sub-blocks — enough to fill the
# card — while its tables (L, O, LOX, tokens: 16 B per input byte) stay
# near 130 MB.  Both stay arguments.
DEFAULT_BLOCK_SIZE = 1 << 20
DEFAULT_BATCH_BLOCKS = 8


def encode_batch_walk(
    blocks,       # (G, B) uint8
    halos,        # (G, H) uint8
    rights,       # (G, R) uint8
    avails,       # (G,) int32
    valid_exts,   # (G,) int32
    valid_total: int,   # valid bytes in the batch span
    entry0,       # (1,) int32 tensor (or int): parse entry into the batch
    *,
    la: int,
    sb: int,
    sub_block: int = parse_walk.DEFAULT_SUB_BLOCK,
    device: str | torch.device | None = None,
):
    """One fused device step over a batch of consecutive blocks.

    Returns (payload, counts, total_tokens, exit_entry): payload is
    (G*B*nb,) uint8 whose first ``total_tokens * nb`` bytes are the packed
    tokens; counts is a (G,) zero placeholder (the walk does not split its
    count by block); total_tokens and exit_entry are (1,) int32 tensors
    that stay on the device, so the next batch can take ``exit_entry`` as
    its ``entry0`` without a host round trip.
    """
    params = spec.Params(la=la, sb=sb)
    if params.width % 8 != 0:
        raise ValueError("fused pipeline requires byte-aligned token width")
    dev = device_lib.resolve(device)
    nb = params.width // 8

    def prep(a, dtype):
        return torch.as_tensor(a).to(device=dev, dtype=dtype).contiguous()

    blocks = prep(blocks, torch.uint8)
    rights = prep(rights, torch.uint8)
    entry0 = prep(entry0, torch.int32).reshape(1)
    G, B = blocks.shape
    N = G * B
    L, O = match_ops.match_sweep(
        blocks, prep(halos, torch.uint8), rights, prep(avails, torch.int32),
        prep(valid_exts, torch.int32), la=la, sb=sb,
    )
    lox = parse_walk.build_lox(
        L.reshape(N), O.reshape(N), blocks.reshape(N), rights[G - 1], la
    )
    tokens, total, exit_e = parse_walk.walk_parse_pack(
        lox, entry0, int(valid_total),
        la=la, ob=params.off_bits, lb=params.len_bits, sub_block=sub_block,
    )
    # little-endian bytes of each word, the low nb of them
    payload = tokens.view(torch.uint8).reshape(N, 4)[:, :nb].reshape(N * nb)
    return payload, torch.zeros(G, dtype=torch.int32, device=dev), total, exit_e


def _resolve_fused_config(
    params: spec.Params,
    n: int,
    block_size: int | None,
    sub_block: int | None,
):
    """Shared knob resolution: (block_size, sub_block) for an n-byte input."""
    if params.width % 8 != 0:
        raise ValueError("fused pipeline requires byte-aligned token width")
    if block_size is None:
        block_size = min(DEFAULT_BLOCK_SIZE, max(n, 1))
    if sub_block is None:
        sub_block = parse_walk.DEFAULT_SUB_BLOCK
    if block_size < 1 or sub_block < 1:
        raise ValueError("block_size and sub_block must be positive")
    return block_size, sub_block


def iter_batches_fused(
    x: np.ndarray,
    params: spec.Params,
    *,
    block_size: int | None = None,
    batch_blocks: int = DEFAULT_BATCH_BLOCKS,
    sub_block: int | None = None,
    start_batch: int = 0,
    entry: int = 0,
    phases=None,
    stats=None,
    retries: int = 2,
    device: str | torch.device | None = None,
):
    """Yield (batch_index, e_in, e_out, token_count, payload_bytes) per batch.

    The fused device pipeline as a resumable iterator.  ``start_batch`` /
    ``entry`` resume mid-stream; payloads are byte-aligned token bytes (no
    header).  Two-deep software pipeline: batch k+1 is submitted before
    batch k is fetched, and the parse entry rides from batch to batch as a
    device tensor, so nothing on the dependency chain waits for the host.
    Launches are asynchronous: while the host stages and fetches, the one
    CUDA stream keeps working through what was submitted.
    """
    from . import codec as codec_model  # lazy: avoid import cycle

    dev = device_lib.resolve(device)
    n = x.shape[0]
    block_size, sub_block = _resolve_fused_config(
        params, n, block_size, sub_block
    )
    nb_bytes = params.width // 8
    B, G = block_size, batch_blocks
    H, R = params.d_limit, params.len_limit
    nblocks = -(-n // B)
    num_batches = -(-nblocks // G)
    if phases is None and stats is not None:
        phases = stats.phases
    ph = phases if phases is not None else metrics_lib.PhaseTimes()

    def submit(bi: int, entry_dev):
        g0 = bi * G
        gn = min(G, nblocks - g0)
        gb, gh, gr, ga, gv = codec_model._batch_inputs(
            x, n, g0, gn, gn, B, H, R
        )
        vt = min(gn * B, n - g0 * B)
        if stats is not None:
            stats.h2d_bytes += sum(a.nbytes for a in (gb, gh, gr, ga, gv))
        payload, _, total, exit_entry = encode_batch_walk(
            gb, gh, gr, ga, gv, vt, entry_dev,
            la=params.la, sb=params.sb, sub_block=sub_block, device=dev,
        )
        return bi, payload, total, exit_entry

    def fetch(handle, e_in: int):
        bi, payload, total, exit_entry = handle
        with metrics_lib.StopwatchPhase(ph, "match"):
            tot, ex = torch.cat([total, exit_entry]).tolist()
            nbytes = tot * nb_bytes
            buf = payload[:nbytes].cpu().numpy().tobytes() if nbytes else b""
            if stats is not None:
                stats.d2h_bytes += nbytes + 8
        return bi, e_in, ex, tot, buf

    def count_retry():
        if stats is not None:
            stats.retries += 1

    entry_dev = torch.tensor([entry], dtype=torch.int32, device=dev)
    e_in = int(entry)
    pending = None
    for bi in range(start_batch, num_batches):
        with metrics_lib.StopwatchPhase(ph, "io"):
            # Failed device batches retry (SURVEY.md §5): batches are
            # independent up to the entry, which submit reads from the
            # previous batch's still-live device tensor.
            nxt = faults_lib.with_retries(
                submit, bi, entry_dev, retries=retries, on_retry=count_retry
            )
            entry_dev = nxt[3]
        if pending is not None:
            out = faults_lib.with_retries(
                fetch, pending, e_in, retries=retries, on_retry=count_retry
            )
            e_in = out[2]
            yield out
        pending = nxt
    if pending is not None:
        yield faults_lib.with_retries(
            fetch, pending, e_in, retries=retries, on_retry=count_retry
        )


def encode_bytes_fused(
    data: bytes,
    params: spec.Params | None = None,
    *,
    block_size: int | None = None,
    batch_blocks: int = DEFAULT_BATCH_BLOCKS,
    sub_block: int | None = None,
    stats=None,
    device: str | torch.device | None = None,
) -> bytes:
    """Compress via the fused device pipeline (byte-aligned widths only)."""
    from . import codec as codec_model  # lazy: avoid import cycle

    params = params or spec.Params()
    dev = device_lib.resolve(device)
    x = np.frombuffer(data, dtype=np.uint8)
    n = x.shape[0]
    block_size, sub_block = _resolve_fused_config(
        params, n, block_size, sub_block
    )
    st = stats if stats is not None else codec_model.EncodeStats()
    st.input_bytes = n

    if n == 0:
        st.output_bytes = spec.HEADER_BYTES
        return bitio.header_bytes(params)

    parts: list[bytes] = [bitio.header_bytes(params)]
    total_tokens = 0
    with metrics_lib.StopwatchPhase(st.phases, "total"):
        for _, _, _, tok, payload in iter_batches_fused(
            x, params, block_size=block_size, batch_blocks=batch_blocks,
            sub_block=sub_block, stats=st, device=dev,
        ):
            total_tokens += tok
            if payload:
                parts.append(payload)
        st.tokens = total_tokens
        st.blocks = -(-n // block_size)
        stream = b"".join(parts)
        st.output_bytes = len(stream)
    return stream
