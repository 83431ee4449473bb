"""Failure handling: per-batch retry + fault injection (SURVEY.md §5).

The reference silently truncates on mid-stream I/O errors (lz77.c:79-82,
124-127; bitio.c:87-88).  Batches are independent up to a scalar entry
carry, so a failed device batch is simply retried; a fault injector lets
tests and the smoke script exercise the retry and resume paths
deterministically.
"""

from __future__ import annotations

import logging
import time

log = logging.getLogger("lz77_tpu_torch")


class FaultInjector:
    """Deterministic fault source: fail batch indices n times."""

    def __init__(self, fail_batches: dict[int, int] | None = None):
        # {batch_index: number_of_times_to_fail}
        self.fail_batches = dict(fail_batches or {})
        self.calls: list[int] = []

    def check(self, batch_index: int) -> None:
        self.calls.append(batch_index)
        remaining = self.fail_batches.get(batch_index, 0)
        if remaining > 0:
            self.fail_batches[batch_index] = remaining - 1
            raise RuntimeError(
                f"injected fault on batch {batch_index} "
                f"({remaining - 1} more)"
            )


def with_retries(fn, *args, retries: int = 2, backoff_s: float = 0.0,
                 on_retry=None):
    """Run ``fn(*args)``, retrying up to ``retries`` times on exception.

    ``on_retry`` (if given) is called once per retry — the observability
    hook EncodeStats.retries counts through.
    """
    attempt = 0
    while True:
        try:
            return fn(*args)
        except Exception as e:  # noqa: BLE001 — retry any batch failure
            attempt += 1
            if attempt > retries:
                raise
            log.warning("batch failed (%s); retry %d/%d", e, attempt, retries)
            if on_retry is not None:
                on_retry()
            if backoff_s:
                time.sleep(backoff_s * attempt)
