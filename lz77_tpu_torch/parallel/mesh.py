"""Device mesh construction.

The workload's parallel axes (SURVEY.md §2.2), as in the JAX package's
``parallel.mesh``:

* ``data`` — independent input blocks (the DP axis; the only axis the
  reference's semantics admit, since blocks share no state beyond raw input
  bytes).
* ``win`` — the search-window/distance axis inside a block: each member
  searches a range of distances and the partial tables meet in a max.

A mesh here is a grid of ``torch.device``s that one process drives, not a
process group: the sharded pipeline launches each member's work on its
device in turn and lets the CUDA streams overlap.  A device may appear more
than once, so a 4x2 mesh runs on one card, or on the CPU in the tests.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as device_lib

DATA_AXIS = "data"
WIN_AXIS = "win"


class Mesh:
    """An (n_data, n_win) grid of devices with the JAX mesh's axis names.

    ``shape[DATA_AXIS]`` and ``shape[WIN_AXIS]`` read as on a JAX mesh;
    ``devices`` is the (n_data, n_win) object array of ``torch.device``.
    """

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.axis_names = (DATA_AXIS, WIN_AXIS)
        n_data, n_win = devices.shape
        self.shape = {DATA_AXIS: n_data, WIN_AXIS: n_win}

    def __repr__(self) -> str:
        return (f"Mesh({self.shape[DATA_AXIS]}x{self.shape[WIN_AXIS]}, "
                f"{sorted({str(d) for d in self.devices.flat})})")


def _member(d) -> torch.device:
    """``d`` through the device rule; a CUDA device gets its index, so that
    members on one card compare equal."""
    dev = device_lib.resolve(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(
    n_data: int | None = None,
    n_win: int = 1,
    devices=None,
) -> Mesh:
    """Build a (data, win) mesh over ``devices``.

    ``devices=None`` is every visible CUDA device (raises without a card:
    the CPU runs only for a caller that lists CPU devices).  A device may be
    listed more than once.  ``n_data=None`` is ``len(devices) // n_win``.
    """
    if devices is None:
        device_lib.resolve("cuda")
        devices = range(torch.cuda.device_count())
        devices = [torch.device("cuda", i) for i in devices]
    devices = [_member(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_win
    need = n_data * n_win
    if need > len(devices):
        raise ValueError(
            f"mesh {n_data}x{n_win} needs {need} devices, have {len(devices)}"
        )
    if n_data < 1 or n_win < 1:
        raise ValueError(f"mesh {n_data}x{n_win} has an empty axis")
    arr = np.empty(need, dtype=object)
    arr[:] = devices[:need]
    return Mesh(arr.reshape(n_data, n_win))
