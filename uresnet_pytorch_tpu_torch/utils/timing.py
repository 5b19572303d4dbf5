"""Wall-clock timers for the per-step tio/tforward/tbackward/tsave columns
the CLI logs. Port of `uresnet_pytorch_tpu/utils/timing.py`."""

from __future__ import annotations

import time


class StopWatch:
    """Named lap timer: ``start('io') ... t = stop('io')``; cumulative totals
    retrievable via ``time('io')``."""

    def __init__(self):
        self._t0 = {}
        self._total = {}
        self._last = {}

    def start(self, key: str) -> None:
        self._t0[key] = time.perf_counter()

    def stop(self, key: str) -> float:
        dt = time.perf_counter() - self._t0[key]
        self._last[key] = dt
        self._total[key] = self._total.get(key, 0.0) + dt
        return dt

    def time(self, key: str) -> float:
        return self._total.get(key, 0.0)

    def last(self, key: str) -> float:
        return self._last.get(key, 0.0)
