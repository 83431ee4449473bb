"""Chunked tensor decoder (the ``device-chunked`` decode backend).

Token streams have no block markers (the format is self-describing only via
its 32-bit header), so decode is chunked over *tokens*: each chunk resolves
fully in parallel on the device (``ops.decode``), and chunks advance serially
carrying only the last H decoded bytes — the only true dependency, identical
in role to the reference decoder's recycled window (lz77.c:172-175).  Plain
tensor code with no kernel; the walk-decode kernel behind ``backend=
"device"`` is the fast decoder.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import bitio
from .. import device as device_lib
from ..ops import decode as decode_ops

DEFAULT_CHUNK_TOKENS = 1 << 15


def _decode_chunk(off, ln, nxt, count, prev_tail, *, la):
    """One token chunk -> (bytes, length, next tail) — tail stays on device.

    The H-byte tail (the reference decoder's recycled window,
    lz77.c:172-175) is cut on the device, at an offset that is itself a
    device value, so consecutive chunks chain without a host round trip in
    the dependency path; the host only fetches each chunk's output bytes.
    """
    out, out_len = decode_ops.decode_tokens(
        off, ln, nxt, count, prev_tail, la=la
    )
    H = prev_tail.shape[0]
    if H == 0:
        return out, out_len, prev_tail
    ext = torch.cat([prev_tail, out])
    # a corrupt length can put out_len past the chunk's buffer: the start
    # is clamped as jax.lax.dynamic_slice clamps it, on the device
    start = torch.clamp(out_len, max=out.shape[0])
    new_tail = ext[start + torch.arange(H, device=out.device)]
    return out, out_len, new_tail


def decode_stream(
    data: bytes,
    chunk_tokens: int = DEFAULT_CHUNK_TOKENS,
    *,
    device: str | torch.device | None = None,
) -> bytes:
    """Decompress a complete stream (ours or the C encoder's)."""
    dev = device_lib.resolve(device)
    params, off, ln, nxt = bitio.parse_stream(data)
    T = off.shape[0]
    if T == 0:
        return b""
    # Tail must cover the largest representable offset, not just sb: foreign
    # headers may advertise any 16-bit sb and we mirror the C decoder's
    # tolerance of whatever the field can hold.
    H = (1 << params.off_bits) - 1
    CT = min(chunk_tokens, 1 << max(0, (T - 1).bit_length()))

    handles: list[tuple] = []
    tail = torch.zeros(H, dtype=torch.uint8, device=dev)
    for c0 in range(0, T, CT):
        n = min(CT, T - c0)
        fields = np.zeros((3, CT), np.int32)
        fields[0, :n] = off[c0 : c0 + n]
        fields[1, :n] = ln[c0 : c0 + n]
        fields[2, :n] = nxt[c0 : c0 + n]
        o, l, x = torch.from_numpy(fields).to(dev)
        out, out_len, tail = _decode_chunk(o, l, x, n, tail, la=params.la)
        handles.append((out, out_len))
    return b"".join(
        out[: int(out_len)].cpu().numpy().tobytes() for out, out_len in handles
    )
