"""Run metrics (the reference codec has none — SURVEY.md §5).

Per-phase wall-clock timings of one encode.  Own copy of the part of the JAX
package's ``utils.metrics`` that the encode pipelines use.
"""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class PhaseTimes:
    """Wall-clock per pipeline phase, seconds.

    Semantics (two-deep submit/fetch pipeline, models/fused.py and
    models/codec.py::iter_block_bits):

    * ``io``    — input staging + device dispatch (the ``submit`` half).
    * ``match`` — time blocked on device results: device compute not hidden
      by the pipeline overlap, plus device-to-host transfer.  This is a
      completion fetch, so match+io bounds the true device-side cost.
    * ``parse``/``pack`` — host-side parse walk and token packing (host
      pipeline only).
    * ``resync`` — the sharded pipeline's host resync stage; kept so run
      reports carry the JAX package's keys, 0 on every pipeline here.
    * ``total`` — end-to-end wall time of the encode; the other phases sum
      to ~total (small gaps are loop/bookkeeping overhead).
    """

    match: float = 0.0
    parse: float = 0.0
    pack: float = 0.0
    io: float = 0.0
    resync: float = 0.0
    total: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class StopwatchPhase:
    """Context manager accumulating wall time into a PhaseTimes field."""

    def __init__(self, phases: PhaseTimes, field: str):
        self.phases = phases
        self.field = field

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        setattr(self.phases, self.field, getattr(self.phases, self.field) + dt)
        return False
