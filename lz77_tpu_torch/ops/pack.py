"""Device-side token bit-packing (the on-device half of the bit I/O layer).

The reference writes one bit per loop iteration (bitio.c:213-236).  Tokens
are fixed-width, so packing is an affine layout transform: for byte-aligned
widths (the default 24-bit token) each token is exactly width/8 bytes; for
general widths the (T, width) bit matrix regrouped into octets is a single
reshape + weighted sum.  Both are branch-free tensor functions with no
kernel; the host equivalents live in ``lz77_tpu_torch.bitio`` and the
native library.
"""

from __future__ import annotations

import torch

from .. import spec


def pack_tokens_device(
    off: torch.Tensor,
    ln: torch.Tensor,
    nxt: torch.Tensor,
    params: spec.Params,
) -> torch.Tensor:
    """(T,) token fields -> packed payload bytes.

    Returns a uint8 tensor of ceil(T*width/8) bytes (zero bit padding at the
    tail for non-byte-aligned widths; the caller tracks the true bit count
    as T*width when concatenating blocks).
    """
    T = off.shape[0]
    W = params.width
    bo, bl = params.off_bits, params.len_bits
    dev = off.device
    v = (
        off.to(torch.int64)
        | (ln.to(torch.int64) << bo)
        | (nxt.to(torch.int64) << (bo + bl))
    )
    if W % 8 == 0:
        nb = W // 8
        shifts = torch.arange(nb, dtype=torch.int64, device=dev) * 8
        return ((v[:, None] >> shifts[None, :]) & 0xFF).to(
            torch.uint8
        ).reshape(T * nb)
    # General width: bit matrix -> octets.
    bit_idx = torch.arange(W, dtype=torch.int64, device=dev)
    flat = ((v[:, None] >> bit_idx[None, :]) & 1).reshape(-1)
    pad = (-flat.shape[0]) % 8
    flat = torch.cat([flat, torch.zeros(pad, dtype=torch.int64, device=dev)])
    weights = 1 << torch.arange(8, dtype=torch.int64, device=dev)
    return (flat.reshape(-1, 8) * weights[None, :]).sum(dim=1).to(torch.uint8)


def unpack_tokens_device(
    payload: torch.Tensor, T: int, params: spec.Params
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Packed payload bytes -> (off, len, next) int32 for T tokens (affine)."""
    W = params.width
    bo, bl = params.off_bits, params.len_bits
    dev = payload.device
    if W % 8 == 0:
        nb = W // 8
        mat = payload[: T * nb].reshape(T, nb).to(torch.int64)
        shifts = torch.arange(nb, dtype=torch.int64, device=dev) * 8
        v = (mat << shifts[None, :]).sum(dim=1)
    else:
        bit = torch.arange(8, dtype=torch.int64, device=dev)
        bits = ((payload.to(torch.int64)[:, None] >> bit[None, :]) & 1)
        bits = bits.reshape(-1)[: T * W].reshape(T, W)  # LSB first
        weights = 1 << torch.arange(W, dtype=torch.int64, device=dev)
        v = (bits * weights[None, :]).sum(dim=1)
    off = v & ((1 << bo) - 1)
    ln = (v >> bo) & ((1 << bl) - 1)
    nxt = (v >> (bo + bl)) & 0xFF
    return off.to(torch.int32), ln.to(torch.int32), nxt.to(torch.int32)
