"""Merged sweep + walk: match, greedy parse and token pack in one kernel.

The fused encode's walk route runs two kernels per batch: the match sweep
writes (L, O) tables to device memory (8 B per input byte), ``build_lox``
reads them and writes one word per byte, and the walk reads those words
again.  The merged route does all three in one kernel, so the match tables
never leave the chip: raw bytes and a parse entry go in, the exact serial
token words, their count and the exit entry come out.

Contract (the JAX package's ``ops.fused_walk``, without its geometry
gate): a batch of G consecutive blocks in the matcher's coordinates
(``ops.match``), the span's valid bytes ``valid_total`` and the entry the
previous batch left.  The walk starts at ``entry`` in [0, la), emits a
token at every chain position ``p < valid_total`` and leaves
``exit = p - valid_total``.  A token's ``next`` byte is the byte at
``p + len`` of the flat span and, past the span, of the last block's right
extension — what ``parse_walk.build_lox`` hands the walk kernel — so the
result equals match sweep + walk on any input, also one whose right
extensions are not the next block's head.

Kernel note — ``csrc/fused_walk.cu::sweepwalk_kernel`` replaces the TPU
kernel ``lz77_tpu/ops/fused_walk.py::_kernel``.  That kernel is a one-block
software pipeline (sweep block g while walking block g-1) because a
TensorCore runs one program at a time and the walk can ride in the sweep's
spare scalar slots; its bit planes, plane-strided addressing, slot counts
and geometry limits serve that machine.  On Hopper thread blocks run in
parallel, so the kernel is the match sweep (``match.cu``) with the parallel
walk (``parse_walk.cu``) folded into each tile: a tile sweeps its 512
positions into shared memory, walks them once per possible entry offset,
takes its true entry and token offset from the tile before it through a
64-bit word in device memory, passes the state on, and packs its tokens.
Tiles are numbered by an atomic ticket so a tile only ever waits for one
that is already running.  Like the sweep it is bound by operations (up to
``d_limit`` first-byte compares per position) and moves about 1 B per input
byte in and 4 B per token out; the hand-off is a serial chain over the
batch's tiles, one device-memory round trip each.  It covers la 2..255 and
sb 1..65535 like the two kernels it merges.
"""

from __future__ import annotations

import torch

from .. import _build, spec
from .. import device as device_lib
from . import match as match_ops
from . import parse_walk

# Positions per thread block of ``sweepwalk_kernel`` (``TILE`` in the source).
TILE = 512
# The merged kernel is not the fused pipeline's default route: ``parser=
# "merged"`` asks for it by name.
MERGED_DEFAULT = False


def _check(blocks, entry, valid_total, la):
    N = blocks.numel()
    if not 2 <= la <= 255:
        raise ValueError(f"merged kernel supports la in [2, 255], got {la}")
    if entry.dtype != torch.int32 or entry.shape != (1,) \
            or entry.device != blocks.device:
        raise ValueError("entry must be a (1,) int32 tensor on blocks' device")
    if not 0 <= valid_total <= N:
        raise ValueError(f"valid_total {valid_total} outside [0, {N}]")
    if N >= (1 << 31) - 256:
        raise ValueError("span too long for 32-bit positions")


def sweep_walk_plain(
    blocks: torch.Tensor,
    halos: torch.Tensor,
    rights: torch.Tensor,
    avails: torch.Tensor,
    valid_exts: torch.Tensor,
    entry: torch.Tensor,
    valid_total: int,
    *,
    la: int,
    sb: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the sweep's plain version, the LOX build and
    the walk's plain version in a row.  Token slots past the count are 0."""
    G, B = blocks.shape
    N = G * B
    p = spec.Params(la=la, sb=sb)
    if N == 0 or p.d_limit == 0:
        L = O = torch.zeros(N, dtype=torch.int32, device=blocks.device)
    else:
        L, O = match_ops.match_sweep_plain(
            blocks, halos, rights, avails, valid_exts, la=la, sb=sb
        )
    tail = rights[G - 1] if G else rights.reshape(-1)
    lox = parse_walk.build_lox(
        L.reshape(N), O.reshape(N), blocks.reshape(N), tail, la
    )
    return parse_walk.walk_parse_pack_plain(
        lox, entry, valid_total, la=la, ob=p.off_bits, lb=p.len_bits
    )


def sweep_walk(
    blocks: torch.Tensor,      # (G, B) uint8
    halos: torch.Tensor,       # (G, d_limit) uint8
    rights: torch.Tensor,      # (G, la-1) uint8
    avails: torch.Tensor,      # (G,) int32
    valid_exts: torch.Tensor,  # (G,) int32
    entry: torch.Tensor,       # (1,) int32: parse entry into the span
    valid_total: int,          # valid bytes in the span, 0..G*B
    *,
    la: int,
    sb: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5 wrapper: raw batch -> (tokens, count, exit_entry).

    ``tokens`` is (G*B,) int32; its first ``count`` words are the packed
    tokens ``off | len<<off_bits | next<<(off_bits+len_bits)`` of the exact
    serial parse (the rest is unspecified).  ``count`` and ``exit_entry``
    are (1,) int32 tensors on the inputs' device.  CUDA tensors launch
    ``sweepwalk_kernel`` (or raise); CPU tensors run
    :func:`sweep_walk_plain`.  ``sweep_walk.launches`` counts launches.
    """
    p = spec.Params(la=la, sb=sb)
    G, B = blocks.shape
    N = G * B
    match_ops.check_batch(
        blocks, halos, rights, avails, valid_exts, p.d_limit, p.len_limit
    )
    _check(blocks, entry, valid_total, la)
    if not blocks.is_cuda:
        return sweep_walk_plain(
            blocks, halos, rights, avails, valid_exts, entry, valid_total,
            la=la, sb=sb,
        )
    dev = blocks.device
    tokens = torch.empty(N, dtype=torch.int32, device=dev)
    if valid_total == 0:  # nothing to walk: the entry passes through
        return (tokens, torch.zeros(1, dtype=torch.int32, device=dev),
                entry.clamp(0, la - 1))
    # tiles never straddle blocks; only those that start before valid_total
    full, rem = divmod(valid_total, B)
    n_tiles = full * -(-B // TILE) + -(-rem // TILE)
    lib = _build.kernels()
    sync = torch.zeros(n_tiles + 1, dtype=torch.int64, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    exit_e = torch.empty(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.lz77_sweepwalk(
            blocks.data_ptr(), halos.data_ptr(), rights.data_ptr(),
            avails.data_ptr(), valid_exts.data_ptr(), entry.data_ptr(),
            sync.data_ptr(), tokens.data_ptr(), count.data_ptr(),
            exit_e.data_ptr(), G, B, p.d_limit, p.len_limit, la, valid_total,
            n_tiles, p.off_bits, p.len_bits,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "sweepwalk_kernel")
    sweep_walk.launches += 1
    return tokens, count, exit_e


sweep_walk.launches = 0


def encode_batch_sweepwalk(
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
    device: str | torch.device | None = None,
):
    """One merged-kernel device step; same contract as
    ``models.fused.encode_batch_walk``.

    Returns (payload, counts, total_tokens, exit_entry): payload is
    (G*B*nb,) uint8 whose first ``total_tokens * nb`` bytes are the packed
    tokens; counts is a (G,) zero placeholder; total_tokens and exit_entry
    are (1,) int32 tensors that stay on the device, so batches chain without
    a host round trip.
    """
    params = spec.Params(la=la, sb=sb)
    if params.width % 8 != 0:
        raise ValueError("fused pipeline requires byte-aligned token width")
    dev = device_lib.resolve(device)

    def prep(a, dtype):
        return torch.as_tensor(a).to(device=dev, dtype=dtype).contiguous()

    blocks = prep(blocks, torch.uint8)
    tokens, total, exit_e = sweep_walk(
        blocks, prep(halos, torch.uint8), prep(rights, torch.uint8),
        prep(avails, torch.int32), prep(valid_exts, torch.int32),
        prep(entry0, torch.int32).reshape(1), int(valid_total), la=la, sb=sb,
    )
    payload = parse_walk.token_bytes(tokens, params.width // 8)
    counts = torch.zeros(blocks.shape[0], dtype=torch.int32, device=dev)
    return payload, counts, total, exit_e
