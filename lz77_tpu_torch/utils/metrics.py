"""Run metrics (the reference codec has none — SURVEY.md §5).

Per-phase wall-clock timings of one encode, a structured run report and
scaling efficiency, JSON-serializable.  Own copy of the JAX package's
``utils.metrics``.
"""

from __future__ import annotations

import dataclasses
import json
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


@dataclasses.dataclass
class RunReport:
    mode: str = ""
    input_bytes: int = 0
    output_bytes: int = 0
    tokens: int = 0
    blocks: int = 0
    seconds: float = 0.0
    phases: PhaseTimes = dataclasses.field(default_factory=PhaseTimes)
    device: str = ""
    backend: str = ""

    @property
    def ratio(self) -> float:
        return self.output_bytes / self.input_bytes if self.input_bytes else 0.0

    @property
    def mb_per_s(self) -> float:
        return self.input_bytes / self.seconds / 1e6 if self.seconds else 0.0

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["phases"] = self.phases.as_dict()
        d["ratio"] = round(self.ratio, 6)
        d["mb_per_s"] = round(self.mb_per_s, 3)
        return json.dumps(d)


def scaling_efficiency(
    throughput_n: float, throughput_1: float, n: int
) -> float:
    """Fraction of ideal linear scaling achieved going 1 -> n workers."""
    if throughput_1 <= 0 or n <= 0:
        return 0.0
    return throughput_n / (throughput_1 * n)


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
