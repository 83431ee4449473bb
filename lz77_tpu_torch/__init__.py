"""lz77_tpu_torch — the LZ77 codec framework on PyTorch and CUDA (Hopper).

The port of ``lz77_tpu`` (JAX/Pallas, TPU), package beside package: same
stream format (the C reference codec cstdvd/lz77's), same contracts at the
public functions, plain tensor code in PyTorch and the device kernels
written by hand in CUDA C++ (``csrc/``, built at first use).  It imports
``torch`` and ``numpy``, never ``jax`` and nothing of ``lz77_tpu``.

Layering:

* ``spec`` / ``bitio``  — format contract + host bitstream codec
* ``ops``               — match sweep, walk parse + pack, walk decode: each
                          a contract, a plain PyTorch version and a kernel
* ``models``            — fused encode pipeline, bytes-level codec, the
                          numpy spec model and host decoder
* ``utils``             — metrics, retries
* ``native``            — ctypes binding of the C++ host codec (oracle)
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

    ``backend``: "device" (the fused device pipeline on ``device``; kwargs:
    block_size, batch_blocks, sub_block, stats), "native" (C++ host
    encoder) or "numpy" (executable spec).  All emit byte-identical streams.
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


__all__ = ["spec", "Params", "compress", "decompress", "__version__"]
