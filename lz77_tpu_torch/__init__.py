"""lz77_tpu_torch — the LZ77 codec framework on PyTorch and CUDA (Hopper).

The port of ``lz77_tpu`` (JAX/Pallas, TPU), package beside package: same
stream format (the C reference codec cstdvd/lz77's), same contracts at the
public functions, plain tensor code in PyTorch and the device kernels
written by hand in CUDA C++ (``csrc/``, built at first use).  It imports
``torch`` and ``numpy``, never ``jax`` and nothing of ``lz77_tpu``.

Layering:

* ``spec`` / ``bitio``  — format contract + host bitstream codec
* ``ops``               — match sweep and match chunk, walk parse + pack,
                          walk decode (parallel and packed-word): each a
                          contract, a plain PyTorch version and a kernel
* ``models``            — fused and host-parse encode pipelines, bytes- and
                          file-level codec (manifest/resume, streamed device
                          decode), the numpy spec model and host decoder
* ``utils``             — metrics, retries + fault injection, manifest,
                          profiling
* ``native``            — ctypes binding of the C++ host codec (oracle,
                          host parse/pack helpers, streamed file codec)
* ``cli``               — the reference-compatible command line
* ``corpus`` / ``conformance`` / ``dump`` — the conformance corpus, the
                          per-file conformance runner, the stream inspector
* ``experiments``       — the co-issue probe (four kernels of its own)
* ``device`` / ``_build`` — the device rule; kernel build and load
* ``convert``           — the JAX package's values -> this package's tensors

Entry points run on the GPU and raise when there is none; ``device="cpu"``
runs the kernels' plain PyTorch versions on the host.
"""

from . import spec
from .spec import Params

__version__ = "0.1.0"


def compress(
    data: bytes,
    la: int = spec.DEFAULT_LA_SIZE,
    sb: int = spec.DEFAULT_SB_SIZE,
    *,
    backend: str = "device",
    device=None,
    **kwargs,
) -> bytes:
    """One-call encode to a complete reference-format stream.

    ``backend``: "device" (a device pipeline on ``device``; kwargs:
    pipeline — "fused" by default, or "host" for any token width —
    block_size, batch_blocks, sub_block, matcher, stats), "native" (C++
    host encoder) or "numpy" (executable spec).  All emit byte-identical
    streams.
    """
    params = Params(la=la, sb=sb)
    if backend == "device":
        from .models import codec

        return codec.encode_bytes(data, params, device=device, **kwargs)
    if backend == "native":
        from . import native as _native

        return _native.encode(data, params, **kwargs)
    if backend == "numpy":
        from .models import spec_np

        return spec_np.encode(data, params)
    raise ValueError(
        f"unknown encode backend {backend!r}; available: device, native, numpy"
    )


def decompress(data: bytes, *, backend: str = "device", device=None) -> bytes:
    """One-call decode of a reference-format stream (self-describing)."""
    from .models import codec

    return codec.decode_bytes(data, backend=backend, device=device)


def compress_file(
    in_path: str,
    out_path: str,
    la: int = spec.DEFAULT_LA_SIZE,
    sb: int = spec.DEFAULT_SB_SIZE,
    *,
    pipeline: str = "host",
    device=None,
    **kwargs,
) -> None:
    """File-to-file encode in bounded memory (memmap input, streamed output).

    ``pipeline``: "host" (device match + host parse, any token width) or
    "fused" (device-resident match+parse+pack); kwargs pass through to
    ``models.codec.encode_file`` (``manifest_path``/``resume`` for
    checkpointing, ``block_size``, ``matcher``, ...).
    """
    from .models import codec

    codec.encode_file(
        in_path, out_path, Params(la=la, sb=sb), pipeline=pipeline,
        device=device, **kwargs,
    )


def decompress_file(in_path: str, out_path: str, *, backend: str = "device",
                    device=None, **kwargs) -> int:
    """File-to-file decode at bounded host memory (any stream size); returns
    the decoded byte count.  ``backend``: "device" (the walk-decode kernel,
    chained stage by stage), "native" (the C++ streamed decoder, the
    reference's capability, lz77.c:148-197) or "host"."""
    from .models import codec

    return codec.decode_file(
        in_path, out_path, backend=backend, device=device, **kwargs
    )


__all__ = [
    "spec", "Params", "compress", "decompress", "compress_file",
    "decompress_file", "__version__",
]
