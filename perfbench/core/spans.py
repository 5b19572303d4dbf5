"""The traced window's device and idle time, attributed to the program's
spans (`uresnet.*`, `uresnet_pytorch_tpu_torch/utils/timing.py:span`).

From the window's `torch.profiler` (kineto's raw events: each op's thread,
sequence number and forward thread, and each device row's link to the op
that launched it):

- Device time. A kernel, copy or set goes to the innermost span around
  the op that launched it, on that op's own thread; one launched in no op
  (a ctypes call of the port's kernel library) to the innermost span
  around its launch call (CUDA's runtime or driver API, which the
  profiler links to the kernel). An op that autograd's
  backward runs, outside any recompute span, goes instead to the spans
  of the forward op that made its node (the same thread and sequence
  number), so a layer's span owns its forward and its backward kernels.
  An op in no span on a thread other than the step's (autograd's engine
  thread) goes to the spans open on the step's thread when it started.
- Idle time. Each gap between the device's busy intervals inside the
  window, however short, goes to the innermost span open on the thread
  that runs `uresnet.step`, at the gap's midpoint.

Time in no span goes to `outside`, so the leaf buckets (each path's
innermost span, or `outside`) partition the device rows' time and the idle
time. A path is the tuple of span names from the outermost in.
"""

from __future__ import annotations

import sys
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

SPAN = "uresnet."
RECOMPUTE = "uresnet.recompute."
STEP = "uresnet.step"
OUTSIDE = "outside"

Path = Tuple[str, ...]


class Op(NamedTuple):
    """A host op or span."""
    id: int             # its correlation id (what device rows link to)
    name: str
    thread: int
    start: float        # us
    end: float
    seq: int = -1       # autograd sequence number (-1: none)
    fwd_thread: int = 0  # a backward node's forward thread (0: not one)


class Row(NamedTuple):
    """A device row: a kernel, copy or set."""
    start: float
    end: float
    op: int             # the launching op's id (0: none)
    thread: Optional[int] = None    # the launch call's thread and start,
    launched: float = 0.0           # for a launch made in no op


@dataclass
class Attribution:
    device_us: Dict[Path, float] = field(default_factory=dict)
    idle_us: Dict[Path, float] = field(default_factory=dict)
    main_thread: Optional[int] = None

    def leaves(self, which: str = "device") -> Dict[str, float]:
        """us by leaf bucket: the innermost span, or `outside`."""
        out: Dict[str, float] = defaultdict(float)
        for path, us in getattr(self, which + "_us").items():
            out[leaf(path)] += us
        return dict(out)


def leaf(path: Path) -> str:
    return path[-1] if path else OUTSIDE


def _nest(ops: List[Op]):
    """Per op id: (its thread, start, the spans around it with itself if
    it is one, the backward node around it or None); per thread, its
    spans as (start, end, path) in start order."""
    by_thread: Dict[int, List[Op]] = defaultdict(list)
    for op in ops:
        by_thread[op.thread].append(op)
    around, spans = {}, defaultdict(list)
    for th, lst in by_thread.items():
        lst.sort(key=lambda o: (o.start, -o.end))
        stack: list = []            # (end, path, node)
        for o in lst:
            while stack and stack[-1][0] <= o.start:
                stack.pop()
            path, node = stack[-1][1:] if stack else ((), None)
            if o.name.startswith(SPAN):
                path = path + (o.name,)
                spans[th].append((o.start, o.end, path))
            if o.fwd_thread > 0 and o.seq >= 0:
                node = o
            around[o.id] = (th, o.start, path, node)
            stack.append((o.end, path, node))
    return around, spans


def _paths_at(spans: list, times: List[float]) -> List[Path]:
    """The innermost span's path at each of `times` (ascending), of spans
    (start, end, path) in start order that nest."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][0] <= t:
            s = spans[i]
            i += 1
            while stack and stack[-1][1] <= s[0]:
                stack.pop()
            stack.append(s)
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(stack[-1][2] if stack else ())
    return out


def attribute(ops: List[Op], rows: List[Row], w0: float, w1: float,
              busy: List[Tuple[float, float]]) -> Attribution:
    """Device rows and idle gaps inside [w0, w1] by span path. `busy` is
    the window's union of device intervals (`Trace.busy_intervals`)."""
    around, spans = _nest(ops)
    steps = Counter(o.thread for o in ops if o.name == STEP)
    main = steps.most_common(1)[0][0] if steps else None
    # the forward op that made each node: the last op to take its number
    made: Dict[Tuple[int, int], Path] = {}
    for o in sorted(ops, key=lambda o: o.start):
        if o.seq >= 0 and o.fwd_thread == 0:
            made[(o.thread, o.seq)] = around[o.id][2]

    res = Attribution(main_thread=main)
    dev: Dict[Path, float] = defaultdict(float)
    # rows placed by time on a thread: (time, us) by thread
    timed: Dict[int, list] = defaultdict(list)
    for r in rows:
        if not (r.end > w0 and r.start < w1):
            continue
        us = min(r.end, w1) - max(r.start, w0)
        got = around.get(r.op)
        if got is None:
            if r.thread is None:
                dev[()] += us
            else:
                timed[r.thread].append((r.launched, us))
            continue
        th, start, path, node = got
        if not (path and path[-1].startswith(RECOMPUTE)):
            if node is not None:
                path = made.get((node.fwd_thread, node.seq), path)
            if not path and main is not None and th != main:
                timed[main].append((start, us))
                continue
        dev[path] += us
    # other threads first: what finds no span there goes to the step's
    order = [t for t in timed if t != main]
    for th in order + ([main] if main is not None else []):
        items = sorted(timed.get(th, []))
        at = _paths_at(spans.get(th, []), [t for t, _ in items])
        for (t, us), path in zip(items, at):
            if not path and main is not None and th != main:
                timed[main].append((t, us))
            else:
                dev[path] += us

    gaps, prev = [], w0
    for a, b in list(busy) + [(w1, w1)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    idle: Dict[Path, float] = defaultdict(float)
    mids = [0.5 * (a + b) for a, b in gaps]
    for (a, b), path in zip(gaps, _paths_at(spans.get(main, []), mids)):
        idle[path] += b - a
    res.device_us, res.idle_us = dict(dev), dict(idle)
    return res


def records(prof) -> Tuple[List[Op], List[Row]]:
    """Ops and device rows of a finished `torch.profiler.profile`, in the
    time base of its `events()` (us from the trace's start). Device rows
    are those `core.trace.Trace` counts: user annotations left out.

    Kineto's events: an op has its own correlation id and links to none; a
    device row and the runtime call that launched it share CUDA's
    correlation id and link to the op around the call, if any. A runtime
    call carries the system's thread id, which the calls made in an op map
    to the profiler's own."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _filter_name
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    host, dev, calls = [], [], []
    for e in res.events():
        name = e.name()
        if _filter_name(name) or getattr(e, "is_hidden_event",
                                         lambda: False)():
            continue
        a = (e.start_ns() - t0) / 1000
        kind = e.device_type()
        if kind == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((a, (e.end_ns() - t0) / 1000,
                            e.linked_correlation_id(), e.correlation_id()))
        elif (kind == DeviceType.CPU and not e.is_async()
              and e.start_thread_id() == e.end_thread_id()):
            rec = (e.correlation_id(), name, e.start_thread_id(), a,
                   (e.end_ns() - t0) / 1000, e.sequence_nr(),
                   e.fwd_thread_id())
            (host if e.linked_correlation_id() == 0 else calls).append(
                (rec, e.linked_correlation_id()))
    cuda_ids = {d[3] for d in dev}
    ops, unlinked = [], {}
    for rec, _ in host:
        if rec[0] in cuda_ids and rec[1].startswith("cu"):
            unlinked[rec[0]] = rec      # a runtime call made in no op
        else:
            ops.append(Op(*rec))
    thread_of = {o.id: o.thread for o in ops}
    tids = {rec[2]: thread_of[link] for rec, link in calls
            if link in thread_of}
    rows = []
    for a, b, link, cid in dev:
        call = unlinked.get(cid) if link not in thread_of else None
        th = tids.get(call[2]) if call is not None else None
        rows.append(Row(a, b, link, th, call[3] if th is not None else 0.0))
    return ops, rows


def _window_profiler(ctx):
    """The window's profiler: `ctx.prof`, or else the window object `w`
    of the harness's `Run.per_layer`, which calls the readers."""
    prof = getattr(ctx, "prof", None)
    f = sys._getframe(1)
    while prof is None and f is not None:
        w = f.f_locals.get("w") if f.f_code.co_name == "per_layer" else None
        prof = getattr(w, "prof", None)
        f = f.f_back
    return prof


def of(ctx) -> Optional[Attribution]:
    """The window's attribution, built once and kept on the readers'
    context; None where the program left no `uresnet.step` span."""
    if not hasattr(ctx, "spans"):
        prof = _window_profiler(ctx)
        ctx.spans = None
        if prof is not None:
            tr = ctx.trace
            ops, rows = records(prof)
            ctx.spans = attribute(ops, rows, tr.w0, tr.w1,
                                  tr.busy_intervals())
    got = ctx.spans
    return got if got is not None and got.main_thread is not None else None


def _device_run(ctx) -> Optional[Attribution]:
    """The attribution of a window with steps and device time (a CPU run
    has none: no device number is read from it)."""
    if ctx.steps <= 0 or ctx.trace.busy_s() <= 0:
        return None
    return of(ctx)


def device_ms(ctx, take: Callable[[str], bool]) -> Optional[float]:
    """Device ms per batch or step of the leaf buckets `take` accepts."""
    att = _device_run(ctx)
    if att is None:
        return None
    return 1e-3 * sum(us for p, us in att.device_us.items()
                      if take(leaf(p))) / ctx.steps


def idle_ms(ctx, take: Callable[[Path], bool]) -> Optional[float]:
    """Idle ms per batch or step of the paths `take` accepts."""
    att = _device_run(ctx)
    if att is None:
        return None
    return 1e-3 * sum(us for p, us in att.idle_us.items()
                      if take(p)) / ctx.steps


def cell_fill_pct() -> Optional[float]:
    """The share of the tile engine's capacity cells that hold a voxel,
    over every level and every forward traced (the program's counters,
    `utils/timing.py:counters`); None where the program keeps none."""
    from uresnet_pytorch_tpu_torch.utils import timing
    counters = getattr(timing, "counters", None)
    c = counters() if counters is not None else {}
    cap = sum(c.get("capacity_cells", []))
    if cap <= 0:
        return None
    return 100.0 * sum(c.get("active_cells", [])) / cap
