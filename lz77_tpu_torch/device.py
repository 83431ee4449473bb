"""The package's one device rule.

Every entry point takes ``device=`` and resolves it here.  The default is
the GPU, and there is no quiet way down to the CPU: without a card the
default raises, and the CPU runs only for a caller that names it (the CPU
tests do, to drive the kernels' plain PyTorch versions).
"""

from __future__ import annotations

import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); anything else as given.

    Asking for ``cuda`` on a machine without one raises as well, so no
    caller ever continues on a device it did not ask for.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lz77_tpu_torch runs on a CUDA device and none is available; "
            'pass device="cpu" to run the plain PyTorch versions on the host'
        )
    return dev
