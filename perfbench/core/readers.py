"""What the per-layer metric readers (`perfbench/metrics/<name>.py`)
share. A reader takes the traced window's context and returns its number,
or None where it finds nothing to read; it never returns 0 for a share of
a roofline or of a peak.

The context: `mode` (infer or train), `batch`, `steps` (batches or steps
in the traced window), `trace` (`core.trace.Trace`), `work` (the model
work of those steps: `flops`, and the least time of the convolutions,
`sm_bound_s` and `dense_conv_bound_s`), `graph_build_ms()`, and the
card's peaks.
"""

from __future__ import annotations

from typing import Iterable, Optional


def matcher(patterns: Iterable[str]):
    pats = tuple(p.lower() for p in patterns)
    return lambda name: any(p in name.lower() for p in pats)


def idle_pct(ctx) -> Optional[float]:
    w = ctx.trace.window_s
    busy = ctx.trace.busy_s()
    if w <= 0 or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / w)


def mfu_pct(ctx) -> Optional[float]:
    w = ctx.trace.window_s
    if w <= 0 or ctx.work["flops"] <= 0 or ctx.trace.busy_s() <= 0:
        return None
    return 100.0 * ctx.work["flops"] / (w * ctx.peak_flops)


def roofline_pct(ctx, bound_key: str, match) -> Optional[float]:
    t = ctx.trace.kernel_s(match)
    if t <= 0 or ctx.work[bound_key] <= 0:
        return None
    return 100.0 * ctx.work[bound_key] / t


def per_step_ms(ctx, match) -> Optional[float]:
    if ctx.steps <= 0 or ctx.trace.busy_s() <= 0:
        return None
    return 1e3 * ctx.trace.kernel_s(match) / ctx.steps
