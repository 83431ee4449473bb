"""ctypes binding of the native host codec (``native/lz77host.cpp``).

Own copy of the part of the JAX package's binding that this package uses:
whole-buffer ``encode`` and ``decode``.  Both packages bind the same C++
source, which emits streams byte-identical to the device path (same exact
longest match, smallest offset), so it is the fast independent oracle at
sizes where the numpy spec model is far too slow, and the
``backend="native"`` codec.  The library is built on demand under this
package's own build directory and name, so the two packages never race on
one file.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from . import _build, spec

_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "native", "lz77host.cpp",
)
_lock = threading.Lock()
_lib = None


def load() -> ctypes.CDLL:
    """Load (building if needed) the native library; raises if unavailable."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_build.build_host_library(_SRC, "lz77host_torch"))
        for name, argtypes in {
            "lz77_encode": [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int64,
            ],
            "lz77_encode_mt": [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
            ],
            "lz77_decode": [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int64,
            ],
            "lz77_decode_bound": [ctypes.c_void_p, ctypes.c_int64],
            "lz77_encode_bound": [ctypes.c_int64, ctypes.c_int, ctypes.c_int],
        }.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int64
        _lib = lib
        return lib


def encode(
    data: bytes,
    params: spec.Params | None = None,
    *,
    threads: int | None = None,
    block_size: int = 0,
) -> bytes:
    """Exact canonical encode; ``threads`` > 1 runs the block-parallel
    speculative-parse encoder (byte-identical stream, see lz77host.cpp)."""
    params = params or spec.Params()
    lib = load()
    n = len(data)
    cap = lib.lz77_encode_bound(n, params.la, params.sb)
    if cap < 0:
        raise ValueError("invalid parameters")
    src = np.frombuffer(data, np.uint8) if n else np.zeros(1, np.uint8)
    out = np.zeros(cap, np.uint8)
    if threads is None:
        threads = os.cpu_count() or 1
    if threads > 1:
        size = lib.lz77_encode_mt(
            src.ctypes.data, n, params.la, params.sb, out.ctypes.data, cap,
            threads, block_size,
        )
    else:
        size = lib.lz77_encode(
            src.ctypes.data, n, params.la, params.sb, out.ctypes.data, cap
        )
    if size < 0:
        raise RuntimeError(f"native encode failed: {size}")
    return out[:size].tobytes()


def decode(stream: bytes) -> bytes:
    lib = load()
    n = len(stream)
    src = np.frombuffer(stream, np.uint8) if n else np.zeros(1, np.uint8)
    cap = lib.lz77_decode_bound(src.ctypes.data, n)
    if cap < 0:
        raise ValueError(f"corrupt or truncated stream: {cap}")
    out = np.zeros(max(cap, 1), np.uint8)
    size = lib.lz77_decode(src.ctypes.data, n, out.ctypes.data, cap)
    if size < 0:
        raise RuntimeError(f"native decode failed: {size}")
    return out[:size].tobytes()
