"""Bytes-level codec: stats records, encode and decode entry points.

Encode goes through the fused device pipeline (``models.fused``).  Decode
picks a backend by name: ``device`` (the walk-decode kernel,
``ops.decode_walk``), ``host`` (vectorized numpy) or ``native`` (the C++
host decoder).  Nothing here falls back from one backend to another: a
backend that cannot run raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import bitio, spec
from ..utils import metrics as metrics_lib
from . import fused

DEFAULT_BLOCK_SIZE = fused.DEFAULT_BLOCK_SIZE
DEFAULT_BATCH_BLOCKS = fused.DEFAULT_BATCH_BLOCKS


@dataclasses.dataclass
class EncodeStats:
    """Per-run observability record (the reference has none — SURVEY.md §5)."""

    input_bytes: int = 0
    output_bytes: int = 0
    tokens: int = 0
    blocks: int = 0
    retries: int = 0
    # Host<->device transfer accounting: bytes staged to the device and
    # bytes fetched back.  The per-input-byte traffic ratio is the number
    # that explains end-to-end throughput once the kernels are fast.
    h2d_bytes: int = 0
    d2h_bytes: int = 0
    phases: metrics_lib.PhaseTimes = dataclasses.field(
        default_factory=metrics_lib.PhaseTimes
    )

    @property
    def ratio(self) -> float:
        return self.output_bytes / self.input_bytes if self.input_bytes else 0.0


@dataclasses.dataclass
class DecodeStats:
    """Decode observability: which backend ran, and the byte counts."""

    requested: str = ""
    backend: str = ""
    input_bytes: int = 0
    output_bytes: int = 0


def _batch_inputs(x: np.ndarray, n: int, g0: int, gn: int, G: int, B: int,
                  H: int, R: int):
    """Blocks g0..g0+gn of ``x`` as (G, B) rows with halo and right extension."""
    gb = np.zeros((G, B), np.uint8)
    gh = np.zeros((G, H), np.uint8)
    gr = np.zeros((G, R), np.uint8)
    ga = np.zeros(G, np.int32)
    gv = np.zeros(G, np.int32)
    for i in range(gn):
        gs = (g0 + i) * B
        seg = x[gs : min(gs + B, n)]
        gb[i, : seg.shape[0]] = seg
        a = min(H, gs)
        if a > 0:
            gh[i, H - a :] = x[gs - a : gs]
        rseg = x[gs + B : min(gs + B + R, n)]
        gr[i, : rseg.shape[0]] = rseg
        ga[i] = a
        gv[i] = min(B + R, n - gs)
    return gb, gh, gr, ga, gv


def encode_bytes(
    data: bytes,
    params: spec.Params | None = None,
    *,
    block_size: int | None = None,
    batch_blocks: int = DEFAULT_BATCH_BLOCKS,
    sub_block: int | None = None,
    stats: EncodeStats | None = None,
    device: str | torch.device | None = None,
) -> bytes:
    """Compress ``data`` into a complete reference-format stream."""
    return fused.encode_bytes_fused(
        data, params, block_size=block_size, batch_blocks=batch_blocks,
        sub_block=sub_block, stats=stats, device=device,
    )


def decode_bytes(
    data: bytes,
    backend: str = "device",
    *,
    stats: DecodeStats | None = None,
    device: str | torch.device | None = None,
) -> bytes:
    """Decompress a complete reference-format stream.

    ``backend``: "device" (walk-decode kernel on ``device``), "host"
    (numpy pointer doubling) or "native" (C++ host decoder).  The backend
    that ran is recorded in ``stats.backend``.
    """
    st = stats if stats is not None else DecodeStats()
    st.requested = backend
    st.input_bytes = len(data)
    if backend == "device":
        from ..ops import decode_walk

        params, off, ln, nxt = bitio.parse_stream(data)
        out = decode_walk.decode_tokens_walk(
            off, ln, nxt, off_bits=params.off_bits, device=device
        )
        st.backend = "device-walk"
    elif backend == "host":
        from . import host_decode

        out = host_decode.decode(data)
        st.backend = "host"
    elif backend == "native":
        from .. import native as native_lib

        out = native_lib.decode(data)
        st.backend = "native"
    else:
        raise ValueError(
            f"unknown decode backend {backend!r}; "
            "available: device, host, native"
        )
    st.output_bytes = len(out)
    return out
