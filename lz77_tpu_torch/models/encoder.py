"""Block encoder pipeline (device side): the match phase of the host-parse
pipeline, and the full single-block pipeline.

* :func:`match_blocks` — exact match tables for a batch of independent
  blocks.  Blocks depend only on raw input bytes (halo + right extension),
  so this phase is embarrassingly parallel across blocks and batches.  The
  file-level codec pairs it with a global host-side parse that chains entry
  offsets, reproducing the exact serial parse (and therefore the
  size <= reference guarantee).

* :func:`match_blocks_compact` — the same with transfer-minimal outputs, and
  :func:`gather_offsets` / :func:`unpack_lengths`, its two readers.

* :func:`encode_block` — one block through match -> parse -> gather as
  tensor functions; used by tests and where a per-block parse (entry=0) is
  acceptable.

The batch dimension is written out (the kernels take (G, B) batches), where
the JAX package maps a one-block function over the batch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import match as match_ops
from ..ops import parse as parse_ops


def match_blocks(
    blocks: torch.Tensor,
    halos: torch.Tensor,
    rights: torch.Tensor,
    avails: torch.Tensor,
    valid_exts: torch.Tensor,
    *,
    la: int,
    sb: int,
    matcher: str = match_ops.DEFAULT_MATCHER,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(G, B) blocks -> (G, B) int32 match tables (L, O)."""
    find = match_ops.get_matcher(matcher)
    return find(blocks, halos, rights, avails, valid_exts, la=la, sb=sb)


def match_blocks_compact(
    blocks: torch.Tensor,
    halos: torch.Tensor,
    rights: torch.Tensor,
    avails: torch.Tensor,
    valid_exts: torch.Tensor,
    *,
    la: int,
    sb: int,
    matcher: str = match_ops.DEFAULT_MATCHER,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Match phase with transfer-minimal outputs.

    Returns (packed_L, O16): packed_L is the per-position match length,
    nibble-packed two-per-byte when la <= 16 (length <= 15 fits 4 bits) or
    one byte per position otherwise — the only array the host needs to run
    the exact global parse; O16 holds the offsets in 16 bits and is meant to
    *stay on the device* until :func:`gather_offsets` picks out the few
    entries at token starts.  PyTorch has no arithmetic on uint16, so O16 is
    an int16 tensor carrying the uint16 bit pattern; ``gather_offsets``
    gives the values back as 0..65535.
    """
    L, O = match_blocks(
        blocks, halos, rights, avails, valid_exts, la=la, sb=sb,
        matcher=matcher,
    )
    Lb = L.to(torch.uint8)
    if la <= 16:
        packed = Lb[:, 0::2] | (Lb[:, 1::2] << 4)
    else:
        packed = Lb
    return packed, O.to(torch.int16)


def gather_offsets(O16: torch.Tensor, flat_idx: torch.Tensor) -> torch.Tensor:
    """Pick offsets (int32, 0..65535) at flat token-start indices of a
    (G, B) table; ``flat_idx`` is an integer tensor beside ``O16``."""
    return O16.reshape(-1)[flat_idx.long()].to(torch.int32) & 0xFFFF


def unpack_lengths(packed: np.ndarray, B: int, la: int) -> np.ndarray:
    """Host-side inverse of the nibble packing in match_blocks_compact."""
    if la <= 16:
        L = np.empty(B, np.uint8)
        L[0::2] = packed & 0x0F
        L[1::2] = packed >> 4
        return L
    return packed


def encode_block(
    block,
    halo,
    right,
    avail,
    valid_ext,
    entry=0,
    *,
    la: int,
    sb: int,
    matcher: str = match_ops.DEFAULT_MATCHER,
    device: str | torch.device | None = None,
):
    """One block -> (off, len, next, count, exit_pos), padded to block size.

    The arguments are those of ``ops.match.find_matches`` for a single block
    plus the parse entry; the fields are (B,) int32 tensors, ``count`` and
    ``exit_pos`` 0-d int32 tensors.
    """
    L, O = match_ops.find_matches(
        block, halo, right, avail, valid_ext, la=la, sb=sb, device=device,
        matcher=matcher,
    )
    dev = L.device
    B = L.shape[0]
    vl = torch.clamp(torch.as_tensor(valid_ext).to(dev), max=B)
    starts, count, exit_pos = parse_ops.greedy_parse(L, vl, entry, la=la)
    block_ext = torch.cat([
        torch.as_tensor(block).to(device=dev, dtype=torch.uint8),
        torch.as_tensor(right).to(device=dev, dtype=torch.uint8),
    ])
    off, ln, nxt = parse_ops.gather_tokens(starts, vl, L, O, block_ext, la=la)
    return off, ln, nxt, count, exit_pos
