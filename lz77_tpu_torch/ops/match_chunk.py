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
position.  On Hopper a warp shares one position and a chunk is 256
consecutive distances, eight to a lane: the sources of four consecutive
distances start at four consecutive bytes, one aligned word of the window,
so one shared-memory load XORed with the position's first byte repeated
four times has a zero byte for every distance whose first byte matches.  A
distance can only beat the best run so far if it also matches at index
``best``, so the word ``best`` bytes further on is XORed with ``x[best]``
the same way, the two are ORed and one zero-byte test marks the distances
that pass both filters; ``best`` is the warp's, renewed by one ballot and,
when some lane improved, one warp max after each chunk.  Only a distance
the test marks measures its run (four bytes at a time against the
position's own bytes, which are read once into registers).  The chunk loop
stops once the best run has reached the position's cap.  The kernel is
bound by operations (up to ``d_limit`` compares per position against ~1 B
read and 8 B written), like the sweep, which is why it filters a word at a
time; it covers la 2..255, sb 1..65535 and any B: the TPU kernel's
``la <= 128`` and tile-multiple limits are gone.  The halo must be
``d_limit`` long, as there.  The kernel's key is ``L << 16 | (65535 - d)``,
the same order without a division.
"""

from __future__ import annotations

import torch

from .. import _build, spec
from . import match as match_ops


def combine_key(L: torch.Tensor, O, dlim: int) -> torch.Tensor:
    """Order-preserving scalar key: max L wins, then smallest O."""
    return L * (dlim + 2) + (dlim + 1 - O)


def split_key(key: torch.Tensor, dlim: int):
    L = key // (dlim + 2)
    O = (dlim + 1) - key % (dlim + 2)
    return L, torch.where(L > 0, O, 0)


CHUNK = 256  # distances a warp tries per step: 32 lanes x two 4-byte words


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
    """Plain PyTorch version: the kernel's decomposition in tensors.

    Distances are visited ascending, one tensor pass each.  A position's
    chunks are those of the kernel: its window is cut on the word grid, so
    with ``a = (d_limit + p) mod 4`` chunk ``c`` holds the distances
    ``a + 256c - 3 .. a + 256c + 252``.  Within a chunk only a distance
    that passes both filters (first byte equal, and the byte at index
    ``best`` equal to ``x[best]``, ``best`` being the best run *before* the
    chunk) gives its capped run length (by doubling) and its key; the
    chunk's largest key is folded into the best one at the chunk's end, and
    a position whose best run has reached its cap takes no further chunk.
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
    pos64 = pos.to(torch.int64).expand(G, B)
    phase = 3 - (dlim + pos) % 4  # d + phase is 0 mod CHUNK at a chunk's start
    best = torch.zeros((G, B), dtype=torch.int32, device=dev)   # key
    chunk_best = torch.zeros_like(best)
    dmax = min(dlim, int(reach.max())) if G * B else 0
    for d in range(1, dmax + 1):
        best = torch.where((d + phase) % CHUNK == 0,
                           torch.maximum(best, chunk_best), best)
        best_l = (best // (dlim + 2)).to(torch.int64)
        Y = buf[:, H - d : H - d + B + ext]
        passed = (
            (X[:, :B] == Y[:, :B])
            & (X.gather(1, pos64 + best_l) == Y.gather(1, pos64 + best_l))
            & (best_l < cap) & (reach >= d)
        )
        runs = match_ops.capped_runs(X, Y, depth, cap)
        chunk_best = torch.maximum(
            chunk_best, torch.where(passed, combine_key(runs, d, dlim), 0))
    return split_key(torch.maximum(best, chunk_best), dlim)


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
