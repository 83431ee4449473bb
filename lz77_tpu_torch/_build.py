"""Build and load the CUDA kernels (``csrc/*.cu``) and host C++ libraries.

The kernels are compiled at first use by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface and bound with ``ctypes``: no
PyTorch header is included, so a build takes seconds.  Each source is
compiled by its own ``nvcc`` process, all started together, and the objects
are linked once.  Libraries are named after a hash of every file under
``csrc/`` (headers too) and the flags, so a stale one is never loaded, and are moved into place atomically,
so concurrent processes may race to build without harm.

Nothing here runs at import: a machine without ``nvcc`` can import every
module of the package, and only a launch on a CUDA tensor reaches the build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_PKG)
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_ROOT, "build", "lz77_tpu_torch")

KERNEL_SOURCES = ("match.cu", "match_chunk.cu", "parse_walk.cu",
                  "decode_walk.cu", "decode_walk_packed.cu", "fused_walk.cu",
                  "coissue.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# C interface of csrc/*.cu: every pointer and the stream is a c_void_p (a
# bare Python int would be cut to 32 bits).  Each returns cudaGetLastError().
_KERNEL_ARGTYPES = {
    # blocks, halos, rights, avails, valid_exts, L, O, G, B, dlim, depth,
    # d_lo, d_hi, stream
    "lz77_match": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # blocks, halos, rights, avails, valid_exts, L, O, G, B, dlim, depth, stream
    "lz77_match_chunk": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # lox, entry, exit_map, cnt_map, entries, offsets, tokens, count, exit,
    # valid_total, sub_block, la, ob, lb, stream
    "lz77_walk_parse_pack": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _P],
    # tokens, T, out, out_cap, out_words, win, wp, count, sums, sync,
    # off_bits, d_limit, len_limit, tile_words, stream
    "lz77_walk_decode": [_P, _I, _P, _L, _L, _P, _I, _P, _P, _P,
                         _I, _I, _I, _I, _P],
    # tokens, T, out, out_cap_words, count, sums, sync, off_bits, tile_words,
    # stream
    "lz77_walk_decode_packed": [_P, _I, _P, _L, _P, _P, _P, _I, _I, _P],
    # blocks, halos, rights, avails, valid_exts, entry, sync, tokens, count,
    # exit, G, B, dlim, depth, la, valid_total, tile, n_tiles, ob, lb, stream
    "lz77_sweepwalk": [_P] * 10 + [_I] * 10 + [_P],
    # the co-issue probe: init, out, nv, stream; seed, out, steps, stream;
    # seed, init, out, out2, nv, steps, stream (F and Q)
    "lz77_coissue_v": [_P, _P, _I, _P],
    "lz77_coissue_s": [_P, _P, _L, _P],
    "lz77_coissue_f": [_P, _P, _P, _P, _I, _L, _P],
    "lz77_coissue_q": [_P, _P, _P, _P, _I, _L, _P],
}

_lock = threading.Lock()
_kernels = None


def _tag(paths, flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:12]


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built from source at first "
            "use and need the CUDA toolkit"
        )
    return path


def _run_all(cmds, logs) -> None:
    """Start every command at once, wait for all, raise on any failure."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for c in cmds
    ]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out, log in zip(cmds, procs, outs, logs):
        with open(log, "w") as f:
            f.write(out)
        if proc.returncode != 0:
            raise RuntimeError(
                f"kernel build failed ({' '.join(cmd)}):\n{out}"
            )


def kernel_tag() -> str:
    """Hash of the flags and of every file under ``csrc/``, headers
    included: a source may include any of them, so a change to any one
    must name a new library."""
    return _tag(
        [os.path.join(CSRC, f) for f in sorted(os.listdir(CSRC))], NVCC_FLAGS
    )


def build_kernels() -> str:
    """Compile ``csrc/*.cu`` if needed; return the shared library's path."""
    srcs = [os.path.join(CSRC, s) for s in KERNEL_SOURCES]
    tag = kernel_tag()
    lib = os.path.join(BUILD_DIR, f"liblz77_kernels_{tag}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    cc = nvcc()
    stem = os.path.join(BUILD_DIR, f"{tag}_{os.getpid()}")
    objs = [f"{stem}_{os.path.splitext(s)[0]}.o" for s in KERNEL_SOURCES]
    _run_all(
        [[cc, *NVCC_FLAGS, "-c", src, "-o", obj]
         for src, obj in zip(srcs, objs)],
        # the logs keep ptxas' register / shared-memory report per kernel
        [os.path.join(BUILD_DIR, f"{os.path.splitext(s)[0]}.log")
         for s in KERNEL_SOURCES],
    )
    tmp = f"{stem}.so"
    _run_all(
        [[cc, "-shared", "-Xcompiler", "-fPIC", "-o", tmp, *objs]],
        [os.path.join(BUILD_DIR, "link.log")],
    )
    os.replace(tmp, lib)
    for o in objs:
        os.unlink(o)
    return lib


def kernels() -> ctypes.CDLL:
    """The loaded kernel library (built on first call; raises on failure)."""
    global _kernels
    with _lock:
        if _kernels is None:
            lib = ctypes.CDLL(build_kernels())
            for name, argtypes in _KERNEL_ARGTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _kernels = lib
        return _kernels


def check(err: int, what: str) -> None:
    """Raise if a kernel launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def build_host_library(src: str, name: str) -> str:
    """Compile one host C++ source into a shared library; return its path.

    Uses ``g++``; a machine that has the CUDA toolkit but no ``g++`` on the
    path compiles the same source as host code through ``nvcc -x c++``.
    """
    return _build_host([src], f"lib{name}", ".so", shared=True)


def build_host_program(srcs: list[str], name: str) -> str:
    """Compile host C++ sources into an executable; return its path."""
    return _build_host(srcs, name, "", shared=False)


def _build_host(srcs: list[str], stem: str, suffix: str, *,
                shared: bool) -> str:
    """``BUILD_DIR/{stem}_{tag}{suffix}``, named after a hash of the
    sources, built at most once and moved into place atomically."""
    tag = _tag(srcs, ())
    out = os.path.join(BUILD_DIR, f"{stem}_{tag}{suffix}")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = os.path.join(BUILD_DIR, f"{stem}_{tag}_{os.getpid()}{suffix}")
    gxx = shutil.which("g++")
    if gxx:
        cmd = [gxx, "-O3", "-pthread",
               *(("-shared", "-fPIC") if shared else ()), "-o", tmp, *srcs]
    else:
        cmd = [nvcc(), "-x", "c++", "-O3", "-Xcompiler",
               "-fPIC,-pthread" if shared else "-pthread",
               *(("-shared",) if shared else ()), "-o", tmp, *srcs]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"host build failed ({' '.join(cmd)}):\n{res.stderr}"
        )
    os.replace(tmp, out)
    return out
