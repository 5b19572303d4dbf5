"""Timers, spans and counters.

`StopWatch` gives the CLI's per-step tio/tforward/tsave columns (port of
`uresnet_pytorch_tpu/utils/timing.py`).

`span(name)` marks a part of the program on the `torch.profiler` timeline,
as `uresnet.<name>`, while a profiler records, and costs one flag check
otherwise. Kineto puts the spans on the timeline that the device's
activity is on, so a trace (the CLI's `profile_dir`, the benchmark's
`--trace 1` window) shows which part of the program each kernel and each
idle gap belongs to. A span entered while autograd's engine runs
backward is the recompute of `torch.utils.checkpoint`, and is named
`uresnet.recompute.<name>`.

`count(name, values)` adds per-level counts to an accumulator; the
program counts only while `tracing()`, so that no profiler means no
launch. Tensors stay on their device (no host fetch), ints on the host.
`counters()` reads them once, after the traced window.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.autograd.profiler as _profiler

PREFIX = "uresnet."
_NULL = contextlib.nullcontext()
_COUNTS: Dict[str, object] = {}


class StopWatch:
    """Named lap timer: ``start('io') ... t = stop('io')``."""

    def __init__(self):
        self._t0 = {}

    def start(self, key: str) -> None:
        self._t0[key] = time.perf_counter()

    def stop(self, key: str) -> float:
        return time.perf_counter() - self._t0[key]


def tracing() -> bool:
    """True while a torch profiler records."""
    return _profiler._is_profiler_enabled


def span(name: str, index: Optional[int] = None):
    """A `uresnet.<name>` range on the profiler's timeline, carrying
    `index` (a step's number) as its args; a shared null context while no
    profiler records."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    if torch._C._current_graph_task_id() != -1:
        name = "recompute." + name
    return torch.profiler.record_function(
        PREFIX + name, None if index is None else str(index))


def count(name: str, values) -> None:
    """Add `values` (one count per level: a tensor, added on its device,
    or ints) to the counter `name`."""
    if not torch.is_tensor(values):
        values = np.asarray(values, np.int64)
    acc = _COUNTS.get(name)
    _COUNTS[name] = values if acc is None else acc + values


def counters() -> Dict[str, List[int]]:
    """Every counter's per-level totals (fetches the device's)."""
    return {k: [int(x) for x in (v.tolist() if torch.is_tensor(v) else v)]
            for k, v in _COUNTS.items()}


def reset_counters() -> None:
    _COUNTS.clear()
