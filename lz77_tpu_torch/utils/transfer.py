"""Host <-> card transfers of the fused encode: page-locked buffers reused
from call to call, a copy stream beside the compute stream, and a ``bytes``
object written in place.

A CUDA device keeps a pool of :class:`Transfer` sets.  A call borrows one
(:func:`borrow`) and gives it back when it ends, so calls made in turn reuse
one set, and calls made at the same time each have their own.  A set holds
a copy stream, two page-locked staging buffers (each with the event of the
last copy that read it), one page-locked fetch buffer and two page-locked
scalars; its buffers grow to the largest batch seen and are never freed.

:class:`BytesBuilder` builds a compress call's stream: a new ``bytes``
object as large as the stream can be, filled front to back as each batch
lands (a batch that starts inside a byte OR-ed into it) and cut to its
length at the end, with the C API's own means of
building a bytes object (``PyBytes_FromStringAndSize(NULL, n)``,
``_PyBytes_Resize``).  Each byte of the stream is copied once on the host.
"""

from __future__ import annotations

import contextlib
import ctypes

import numpy as np
import torch

# CPython's C API, as fresh function objects (``ctypes.pythonapi``'s shared
# ones keep the argument types another user may have set)
_new_bytes = ctypes.pythonapi["PyBytes_FromStringAndSize"]
_new_bytes.argtypes = (ctypes.c_void_p, ctypes.c_ssize_t)
_new_bytes.restype = ctypes.c_void_p
_bytes_data = ctypes.pythonapi["PyBytes_AsString"]
_bytes_data.argtypes = (ctypes.c_void_p,)
_bytes_data.restype = ctypes.c_void_p
_resize_bytes = ctypes.pythonapi["_PyBytes_Resize"]
_resize_bytes.argtypes = (ctypes.POINTER(ctypes.c_void_p), ctypes.c_ssize_t)
_resize_bytes.restype = ctypes.c_int
_decref = ctypes.pythonapi["Py_DecRef"]
_decref.argtypes = (ctypes.c_void_p,)
_decref.restype = None
_memory_view = ctypes.pythonapi["PyMemoryView_FromMemory"]
_memory_view.argtypes = (ctypes.c_void_p, ctypes.c_ssize_t, ctypes.c_int)
_memory_view.restype = ctypes.py_object
_PYBUF_WRITE = 0x200


class BytesBuilder:
    """A new ``bytes`` object of at most ``capacity`` bytes, written front
    to back with :meth:`write`; :meth:`finish` cuts it to what was written
    and returns it.  Until then the object is referenced by nothing but the
    builder, as ``_PyBytes_Resize`` requires, and its pages are touched only
    as they are written.  :meth:`close` frees an unfinished one."""

    def __init__(self, capacity: int):
        self._obj = ctypes.c_void_p(_new_bytes(None, capacity))
        self._arr = np.frombuffer(_memory_view(
            _bytes_data(self._obj), capacity, _PYBUF_WRITE), np.uint8)
        self.size = 0

    def write(self, data, seam: bool = False) -> None:
        """Append ``data`` (any buffer of bytes); with ``seam``, its first
        byte is OR-ed into the last byte written (a bit-packed payload that
        starts inside that byte, its bits below the phase zero) and the
        rest appended."""
        src = np.frombuffer(data, np.uint8)
        if seam and src.shape[0]:
            if not self.size:
                raise ValueError("BytesBuilder: a seam before any byte")
            self._arr[self.size - 1] |= src[0]
            src = src[1:]
        n = src.shape[0]
        if self.size + n > self._arr.shape[0]:
            raise ValueError("BytesBuilder: write past its capacity")
        self._arr[self.size:self.size + n] = src
        self.size += n

    def finish(self) -> bytes:
        self._arr = None  # the resize may move the object
        _resize_bytes(ctypes.byref(self._obj), self.size)
        out = ctypes.cast(self._obj, ctypes.py_object).value
        _decref(self._obj)  # ``out`` holds the one reference now
        self._obj = None
        return out

    def close(self) -> None:
        if self._obj is not None:
            self._arr = None
            if self._obj.value:
                _decref(self._obj)
            self._obj = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


_GRAIN = 1 << 20


def _pinned(nbytes: int) -> torch.Tensor:
    """A page-locked uint8 buffer of at least ``nbytes``, in whole MiB, so
    a set grows a few times and then stays."""
    return torch.empty(max(1, -(-nbytes // _GRAIN)) * _GRAIN,
                       dtype=torch.uint8, pin_memory=True)


class Transfer:
    """One call's transfer set on a CUDA device (see the module's text)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.compute = None  # the stream the kernels run on, set by borrow
        self._staging = [None, None]
        self._staged = [torch.cuda.Event(), torch.cuda.Event()]
        self._fetch = None
        self._scalars = torch.empty(8, dtype=torch.int32, pin_memory=True)
        self._fetched = torch.cuda.Event()
        # page-locked buffers this set has allocated
        self.allocations = 1

    def staging(self, slot: int, nbytes: int) -> np.ndarray:
        """The first ``nbytes`` of staging buffer ``slot`` (0 or 1), to be
        filled on the host, once the copy that last read it has ended."""
        self._staged[slot].synchronize()
        buf = self._staging[slot]
        if buf is None or buf.numel() < nbytes:
            buf = self._staging[slot] = _pinned(nbytes)
            self.allocations += 1
        return buf.numpy()[:nbytes]

    @contextlib.contextmanager
    def _on_copy_stream(self):
        # not ``torch.cuda.stream``, which looks up the current stream at
        # each entry: the call's compute stream is known (``borrow``), and
        # the lookups are a visible share of a small block's call
        torch.cuda.set_stream(self.stream)
        try:
            yield
        finally:
            torch.cuda.set_stream(self.compute)

    def upload(self, slot: int, nbytes: int) -> torch.Tensor:
        """Copy the first ``nbytes`` of staging buffer ``slot`` into a new
        device tensor on the copy stream, without blocking the host; the
        compute stream waits for the copy before its next kernel."""
        with self._on_copy_stream():
            dst = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
            dst.copy_(self._staging[slot][:nbytes], non_blocking=True)
            self._staged[slot].record(self.stream)
        self.compute.wait_event(self._staged[slot])
        # the compute stream reads it: its memory waits for that work too
        dst.record_stream(self.compute)
        return dst

    def done(self) -> torch.cuda.Event:
        """An event on the compute stream after what it has been given."""
        ev = torch.cuda.Event()
        ev.record(self.compute)
        return ev

    def _copy_out(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        # the host waits for the copy here, so ``src`` (the compute
        # stream's) cannot be freed while the copy stream still reads it
        with self._on_copy_stream():
            dst.copy_(src, non_blocking=True)
            self._fetched.record(self.stream)
        self._fetched.synchronize()

    def scalars(self, pair: torch.Tensor, done: torch.cuda.Event):
        """The int32 values of ``pair`` (on the device, at most 8), copied
        on the copy stream once ``done`` has passed: the host waits for that
        batch, not for what the compute stream took after it."""
        self.stream.wait_event(done)
        out = self._scalars[: pair.numel()]
        self._copy_out(out, pair)
        return out.tolist()

    def fetch(self, src: torch.Tensor, nbytes: int) -> memoryview:
        """The first ``nbytes`` of ``src`` (uint8 on the device, ready:
        after :meth:`scalars` of its batch), copied on the copy stream into
        the fetch buffer: a read-only view, valid until the set's next
        fetch."""
        if self._fetch is None or self._fetch.numel() < nbytes:
            self._fetch = _pinned(nbytes)
            self.allocations += 1
        if nbytes:
            self._copy_out(self._fetch[:nbytes], src[:nbytes])
        return memoryview(self._fetch.numpy()[:nbytes]).toreadonly()


_POOLS: dict[torch.device, list[Transfer]] = {}


def _indexed(device: torch.device) -> torch.device:
    return torch.device("cuda", torch.cuda.current_device()
                        if device.index is None else device.index)


@contextlib.contextmanager
def borrow(device: torch.device):
    """A transfer set of the CUDA ``device``, from its pool, for one call
    whose kernels run on the device's current stream; given back when the
    call ends."""
    dev = _indexed(device)
    pool = _POOLS.setdefault(dev, [])
    t = pool.pop() if pool else Transfer(dev)
    t.compute = torch.cuda.current_stream(dev)
    try:
        yield t
    finally:
        pool.append(t)


def allocations(device: torch.device) -> int:
    """Page-locked buffers the pool of the CUDA ``device`` has allocated."""
    return sum(t.allocations for t in _POOLS.get(_indexed(device), ()))
