"""The traced window: `torch.profiler` over the window, reduced to the
device's activity (kernels, copies and sets, each with its start and
end) and the host's operations, in one clock.

Only device-side rows count as device time: a user annotation's device
row spans its kernels and the gaps between them, so annotations are left
out. Busy time is the union of the device intervals inside the window;
idle gaps are attributed to the innermost host operation running at the
gap's midpoint.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from typing import List, Tuple

import torch

WINDOW = "perfbench.window"
MIN_GAP_US = 5.0


class Trace:
    """Device intervals [(name, start_us, end_us)] and host intervals,
    clipped to the window [w0, w1] (us)."""

    def __init__(self, prof):
        from torch.autograd import DeviceType
        dev, host, w0, w1 = [], [], None, None
        for e in prof.events():
            t0, t1 = e.time_range.start, e.time_range.end
            if e.device_type == DeviceType.CUDA:
                if not e.is_user_annotation:
                    dev.append((e.name, t0, t1))
            elif e.name == WINDOW:
                w0, w1 = t0, t1
            else:
                host.append((e.name, t0, t1))
        if w0 is None:
            raise RuntimeError("the traced window left no range")
        self.w0, self.w1 = w0, w1
        self.dev = sorted((n, max(a, w0), min(b, w1)) for n, a, b in dev
                          if b > w0 and a < w1)
        self.dev.sort(key=lambda r: r[1])
        self.host = sorted(((n, a, b) for n, a, b in host
                            if b > w0 and a < w1), key=lambda r: r[1])

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        out: List[list] = []
        for _, a, b in self.dev:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def kernel_s(self, match) -> float:
        """Device seconds of the rows whose name `match(name)` accepts
        (summed, not unioned: kernels of one stream do not overlap)."""
        return sum(b - a for n, a, b in self.dev if match(n)) / 1e6

    def top_ops(self, k: int = 10) -> List[list]:
        tot = defaultdict(float)
        for n, a, b in self.dev:
            tot[n] += (b - a) / 1e6
        return [[n[:160], s] for n, s in
                sorted(tot.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """Idle seconds summed by the host operation running at each gap's
        midpoint (innermost), the k largest."""
        starts = [h[1] for h in self.host]
        tot = defaultdict(float)
        prev = self.w0
        gaps = []
        for a, b in self.busy_intervals() + [(self.w1, self.w1)]:
            if a - prev >= MIN_GAP_US:
                gaps.append((prev, a))
            prev = max(prev, b)
        for a, b in gaps:
            mid = 0.5 * (a + b)
            name = "host: no operation"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 4000, -1), -1):
                if self.host[j][2] >= mid:
                    name = f"host: {self.host[j][0]}"
                    break
            tot[name[:160]] += (b - a) / 1e6
        return [[n, s] for n, s in
                sorted(tot.items(), key=lambda kv: -kv[1])[:k]]


@contextlib.contextmanager
def profiled(on: bool, cuda: bool):
    """A profiler over the block (None when `on` is false); the block's
    extent is marked as the window."""
    if not on:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield prof
        if cuda:
            torch.cuda.synchronize()
