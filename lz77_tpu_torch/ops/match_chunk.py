"""Exact longest-match finder, distance-chunk form: plain version and kernel.

Same contract as ``ops.match`` (see ``find_matches`` there): for every
position the true longest match L and the smallest distance O achieving it,
over a (G, B) batch of blocks with halo and right extension.  What differs
is the decomposition.  ``match_sweep`` gives a position to one thread that
walks the distances in order; here the *distances* are split: a chunk of
consecutive distances is tried at once, every distance gives its capped run
length, and the winner is a max over the order-preserving key

    key = L * (d_limit + 2) + (d_limit + 1 - d)      (0 when L == 0)

so a longer run wins and, among equal runs, the smaller distance.

Kernel note — ``csrc/match_chunk.cu::match_chunk_kernel`` replaces the TPU
kernel ``lz77_tpu/ops/pallas_match.py::_kernel``.  That kernel holds a tile
in vector memory, tries 128 distances per step as static lane rotations,
gets run lengths by log2(la) doubling steps and keeps the best key per
position.  On Hopper a warp shares one position and its 32 lanes take 32
consecutive distances: a lane finds its run four bytes at a time (two
shared-memory words funnel-shifted into the unaligned source word, XOR,
find-first-set), the lanes keep their best key and one warp max picks the
winner; the chunk loop stops once some lane has reached the position's cap.
It is bound by operations (up to ``d_limit`` compares per position against
~1 B read and 8 B written), like the sweep, and covers la 2..255,
sb 1..65535 and any B: the TPU kernel's ``la <= 128`` and tile-multiple
limits are gone.  The halo must be ``d_limit`` long, as there.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build, spec
from . import match as match_ops


def combine_key(L: torch.Tensor, O, dlim: int) -> torch.Tensor:
    """Order-preserving scalar key: max L wins, then smallest O."""
    return L * (dlim + 2) + (dlim + 1 - O)


def split_key(key: torch.Tensor, dlim: int):
    L = key // (dlim + 2)
    O = (dlim + 1) - key % (dlim + 2)
    return L, torch.where(L > 0, O, 0)


def match_chunk_plain(
    blocks: torch.Tensor,
    halos: torch.Tensor,
    rights: torch.Tensor,
    avails: torch.Tensor,
    valid_exts: torch.Tensor,
    *,
    la: int,
    sb: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the key formulation in tensors.

    Per distance: run lengths by doubling, the key where the distance is
    allowed (``runs > 0``, ``d <= p + avail``), a running ``maximum`` over
    keys; (L, O) are split out of the best key at the end.
    """
    G, B = blocks.shape
    H = halos.shape[1]
    depth = spec.len_limit(la)
    dlim = spec.d_limit(sb)
    dev = blocks.device
    ext = 1
    while ext < depth:
        ext <<= 1
    pos = torch.arange(B, dtype=torch.int32, device=dev)[None, :]
    cap = torch.clamp(valid_exts[:, None] - pos - 1, max=depth)
    reach = pos + avails[:, None]
    buf = torch.cat(
        [halos, blocks, rights,
         torch.zeros((G, ext), dtype=torch.uint8, device=dev)], dim=1,
    )
    X = buf[:, H : H + B + ext]
    best = torch.zeros((G, B), dtype=torch.int32, device=dev)
    dmax = min(dlim, int(reach.max())) if G * B else 0
    for d in range(1, dmax + 1):
        rl = (X == buf[:, H - d : H - d + B + ext]).to(torch.int16)
        m = 1
        while m < depth:
            rl = rl + torch.where(rl == m, F.pad(rl[:, m:], (0, m)), 0)
            m <<= 1
        runs = torch.minimum(rl[:, :B].to(torch.int32), cap)
        ok = (runs > 0) & (reach >= d)
        best = torch.maximum(best, torch.where(ok, combine_key(runs, d, dlim), 0))
    return split_key(best, dlim)


def match_chunk(
    blocks: torch.Tensor,      # (G, B) uint8
    halos: torch.Tensor,       # (G, d_limit) uint8
    rights: torch.Tensor,      # (G, la-1) uint8
    avails: torch.Tensor,      # (G,) int32
    valid_exts: torch.Tensor,  # (G,) int32
    *,
    la: int,
    sb: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K4 wrapper: (L, O) int32 (G, B) tables for a batch of blocks.

    CUDA tensors launch ``match_chunk_kernel`` (or raise); CPU tensors run
    :func:`match_chunk_plain`.  ``match_chunk.launches`` counts launches.
    """
    depth = spec.len_limit(la)
    dlim = spec.d_limit(sb)
    G, B = blocks.shape
    match_ops.check_batch(blocks, halos, rights, avails, valid_exts, dlim,
                          depth)
    if dlim == 0 or depth == 0 or G * B == 0:
        z = torch.zeros((G, B), dtype=torch.int32, device=blocks.device)
        return z, z.clone()
    if not blocks.is_cuda:
        return match_chunk_plain(
            blocks, halos, rights, avails, valid_exts, la=la, sb=sb
        )
    lib = _build.kernels()
    L = torch.empty((G, B), dtype=torch.int32, device=blocks.device)
    O = torch.empty((G, B), dtype=torch.int32, device=blocks.device)
    with torch.cuda.device(blocks.device):
        err = lib.lz77_match_chunk(
            blocks.data_ptr(), halos.data_ptr(), rights.data_ptr(),
            avails.data_ptr(), valid_exts.data_ptr(),
            L.data_ptr(), O.data_ptr(), G, B, dlim, depth,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "match_chunk_kernel")
    match_chunk.launches += 1
    return L, O


match_chunk.launches = 0
