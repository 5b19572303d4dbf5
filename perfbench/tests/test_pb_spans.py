"""The attribution of a traced window to the program's spans
(`core/spans.py`): on hand-built event lists, each rule and the leaf
partition; on a real CPU profile of a training step, the links it rests
on (a backward node's forward op by thread and sequence number)."""

import random
from types import SimpleNamespace

import pytest

from perfbench.core import spans
from perfbench.core.spans import Op, Row, attribute

MAIN, WORKER = 1, 2


def _sum_rows(rows, w0, w1):
    return sum(min(r.end, w1) - max(r.start, w0) for r in rows
               if r.end > w0 and r.start < w1)


def _check_partition(att, rows, w0, w1, busy):
    dev, idle = att.leaves("device"), att.leaves("idle")
    busy_us = sum(b - a for a, b in busy)
    assert sum(dev.values()) == pytest.approx(_sum_rows(rows, w0, w1),
                                              rel=1e-12)
    assert sum(idle.values()) == pytest.approx(w1 - w0 - busy_us, rel=1e-12)
    return dev, idle


def test_kernel_goes_to_the_innermost_span():
    ops = [Op(1, "uresnet.step", MAIN, 0, 100),
           Op(2, "uresnet.stage.enc0", MAIN, 10, 90),
           Op(3, "uresnet.norm", MAIN, 20, 40),
           Op(4, "aten::mul", MAIN, 25, 30),
           Op(5, "aten::add", MAIN, 50, 55),
           Op(6, "aten::copy_", MAIN, 95, 99)]
    rows = [Row(30, 35, 4), Row(55, 60, 5), Row(99, 101, 6)]
    att = attribute(ops, rows, 0, 110, [(30, 35), (55, 60), (99, 101)])
    assert att.device_us == {
        ("uresnet.step", "uresnet.stage.enc0", "uresnet.norm"): 5,
        ("uresnet.step", "uresnet.stage.enc0"): 5,
        ("uresnet.step",): 2}


def test_kernel_launched_in_no_op_goes_to_its_launch_calls_span():
    """A ctypes launch of the kernel library runs in no op: the row goes
    to the span around its launch call, on the call's thread, though the
    device runs it later; a call in no span off the step's thread goes to
    the step's thread at that time."""
    ops = [Op(1, "uresnet.step", MAIN, 0, 100),
           Op(2, "uresnet.conv", MAIN, 10, 20),
           Op(3, "uresnet.reorder", MAIN, 60, 70)]
    rows = [Row(50, 58, 0, MAIN, 12.0), Row(80, 81, 99, MAIN, 65.0),
            Row(90, 92, 0, WORKER, 15.0), Row(95, 96, 0)]
    att = attribute(ops, rows, 0, 100, [(50, 58), (80, 81), (90, 92),
                                        (95, 96)])
    assert att.device_us == {("uresnet.step", "uresnet.conv"): 8 + 2,
                             ("uresnet.step", "uresnet.reorder"): 1,
                             (): 1}


def test_engine_thread_launch_alone_goes_to_the_steps_thread():
    ops = [Op(1, "uresnet.step", MAIN, 0, 100),
           Op(2, "uresnet.backward", MAIN, 50, 90)]
    att = attribute(ops, [Row(95, 97, 0, WORKER, 60.0)], 0, 100, [(95, 97)])
    assert att.device_us == {("uresnet.step", "uresnet.backward"): 2}


def test_backward_op_goes_to_its_forward_ops_span():
    """The node (fwd_thread, seq) names the forward op that made it; of
    ops that took the number, the last one started made the node."""
    ops = [Op(1, "uresnet.step", MAIN, 0, 200),
           Op(2, "aten::empty", MAIN, 5, 6, seq=7),    # took 7, no node
           Op(3, "uresnet.norm", MAIN, 10, 30),
           Op(4, "aten::mul", MAIN, 12, 15, seq=7),    # made node 7
           Op(5, "uresnet.backward", MAIN, 100, 190),
           Op(6, "MulBackward0", WORKER, 110, 130, seq=7, fwd_thread=MAIN),
           Op(7, "aten::mul", WORKER, 112, 118),
           # on the step's thread too (a CPU backward)
           Op(8, "MulBackward0", MAIN, 140, 160, seq=7, fwd_thread=MAIN),
           Op(9, "aten::mul", MAIN, 142, 150)]
    rows = [Row(118, 120, 7), Row(150, 153, 9)]
    att = attribute(ops, rows, 0, 200, [(118, 120), (150, 153)])
    assert att.device_us == {("uresnet.step", "uresnet.norm"): 5}


def test_recompute_kernel_stays_in_its_recompute_span():
    ops = [Op(1, "uresnet.step", MAIN, 0, 200),
           Op(2, "uresnet.stage.enc0", MAIN, 10, 50),
           Op(3, "uresnet.norm", MAIN, 12, 20),
           Op(4, "aten::mul", MAIN, 13, 15, seq=3),
           Op(5, "uresnet.backward", MAIN, 100, 190),
           Op(6, "ConvBackward", WORKER, 110, 180, seq=9, fwd_thread=MAIN),
           Op(7, "uresnet.recompute.stage.enc0", WORKER, 112, 170),
           Op(8, "uresnet.recompute.norm", WORKER, 115, 130),
           Op(9, "aten::mul", WORKER, 116, 120, seq=3),
           Op(10, "aten::relu", WORKER, 140, 145)]
    rows = [Row(120, 124, 9), Row(145, 146, 10)]
    att = attribute(ops, rows, 0, 200, [(120, 124), (145, 146)])
    assert att.leaves() == {"uresnet.recompute.norm": 4,
                            "uresnet.recompute.stage.enc0": 1}


def test_engine_op_in_no_span_goes_to_the_steps_thread():
    """An op of autograd's engine thread with no span and no forward op
    (a gradient's accumulation) goes to what the step's thread was in;
    a row linked to no op goes outside."""
    ops = [Op(1, "uresnet.step", MAIN, 0, 200),
           Op(2, "uresnet.backward", MAIN, 100, 190),
           Op(3, "AccumulateGrad", WORKER, 150, 160),
           Op(4, "aten::add_", WORKER, 151, 155)]
    rows = [Row(155, 158, 4), Row(160, 161, 0)]
    att = attribute(ops, rows, 0, 200, [(155, 158), (160, 161)])
    assert att.device_us == {("uresnet.step", "uresnet.backward"): 3,
                             (): 1}


def test_idle_gap_goes_to_the_steps_thread_innermost_span():
    ops = [Op(1, "uresnet.step", MAIN, 0, 100),
           Op(2, "uresnet.graph_build", MAIN, 2, 35),
           Op(3, "uresnet.backward", MAIN, 50, 90),
           # the engine thread's span at the same time is not the host's
           Op(4, "uresnet.recompute.norm", WORKER, 55, 85)]
    busy = [(10, 20), (40, 45), (48, 60), (70, 95)]
    att = attribute(ops, [], 0, 120, busy)
    assert att.idle_us == {("uresnet.step", "uresnet.graph_build"): 10 + 20,
                           ("uresnet.step",): 3,
                           ("uresnet.step", "uresnet.backward"): 10,
                           (): 25}
    assert att.main_thread == MAIN


def _random_window(seed):
    """Nested spans and ops on two threads, rows linked to random ops,
    some to none (with or without their launch call), some past the
    window's ends."""
    rng = random.Random(seed)
    ops, rows, nid = [], [], [0]

    def tree(thread, a, b, depth):
        t = a
        while t < b - 2:
            s = t + rng.uniform(0, 2)
            e = min(b, s + rng.uniform(1, (b - a) / 2 + 1))
            nid[0] += 1
            span = rng.random() < 0.4
            name = (rng.choice(["uresnet.norm", "uresnet.conv",
                                "uresnet.recompute.norm"]) if span
                    else "aten::op")
            node = thread == WORKER and rng.random() < 0.2
            ops.append(Op(nid[0], name, thread, s, e,
                          seq=rng.randrange(20) if not span else -1,
                          fwd_thread=MAIN if node else 0))
            if depth < 3:
                tree(thread, s, e, depth + 1)
            t = e
    ops.append(Op(10 ** 6, "uresnet.step", MAIN, 0, 1000))
    tree(MAIN, 0, 1000, 0)
    tree(WORKER, 500, 1000, 1)
    for _ in range(400):
        s = rng.uniform(-50, 1050)
        op = rng.choice([0] + [o.id for o in ops])
        # a launch made in no op: its call's thread and time, if known
        th = rng.choice([None, MAIN, WORKER]) if not op else None
        rows.append(Row(s, s + rng.uniform(0, 5), op, th,
                        rng.uniform(0, 1000)))
    rows.sort(key=lambda r: r.start)
    busy = []
    for r in rows:
        a, b = max(r.start, 0), min(r.end, 1000)
        if b < a:
            continue
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    return ops, rows, [tuple(x) for x in busy]


@pytest.mark.parametrize("seed", range(5))
def test_every_microsecond_lands_in_one_leaf_bucket(seed):
    ops, rows, busy = _random_window(seed)
    att = attribute(ops, rows, 0, 1000, busy)
    dev, idle = _check_partition(att, rows, 0, 1000, busy)
    assert set(dev) <= {"uresnet.step", "uresnet.norm", "uresnet.conv",
                        "uresnet.recompute.norm", "outside"}
    assert idle


def test_readers_are_handed_the_window_profiler(monkeypatch):
    """`Run.per_layer` puts the traced window's profiler on the readers'
    context, and `spans.of` attributes that one: a CPU step's spans."""
    from perfbench.core import harness
    from perfbench.core.trace import Trace
    from perfbench.tests import tiny
    seen = []

    def reader(name, root):
        def read(ctx):
            seen.append(ctx)
            return None
        return read
    monkeypatch.setattr(harness, "load_reader", reader)
    tiny.execute("sparse16_train_b8", trace=1)
    assert seen and all(c.prof is not None for c in seen)
    prof = seen[0].prof
    att = spans.of(SimpleNamespace(prof=prof, trace=Trace(prof)))
    assert att is not None
    assert set(att.idle_us) and att.device_us == {}


@pytest.mark.parametrize("remat", ["stage_dots", "none"])
def test_real_cpu_profile_of_a_step(remat):
    """One CPU training step under torch.profiler: every backward node but
    the gradients' accumulation finds the forward op that made it; with a
    row for each aten op, the leaves partition the rows, and recompute
    leaves appear exactly under a recomputing mode."""
    from torch.profiler import ProfilerActivity, profile
    from perfbench.core import harness
    from perfbench.core.cells import load_cell
    from perfbench.tests import tiny
    from uresnet_pytorch_tpu_torch.config import URESNetConfig
    from uresnet_pytorch_tpu_torch.trainval import TrainVal
    mo, to = tiny.overrides("sparse16_train_b8", remat_mode=remat)
    cell = load_cell("sparse16_train_b8", model_overrides=mo,
                     traffic_overrides=to)
    run = harness.Run(cell, 3000000011, "cpu")
    run.make_inputs()
    tv = TrainVal(URESNetConfig(**cell.model, batch_size=run.batch,
                                train=True), device="cpu")
    tv.initialize()
    tv.train_step(run.blobs[0])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tv.train_step(run.blobs[1])
    ops, rows = spans.records(prof)
    assert rows == []
    made = {(o.thread, o.seq) for o in ops if o.seq >= 0 and not o.fwd_thread}
    nodes = [o for o in ops if o.fwd_thread and o.seq >= 0
             and "AccumulateGrad" not in o.name]
    assert nodes and all((o.fwd_thread, o.seq) in made for o in nodes)
    rows = [Row(o.start, o.end, o.id) for o in ops
            if o.name.startswith("aten::")]
    w0 = min(o.start for o in ops)
    w1 = max(o.end for o in ops)
    att = attribute(ops, rows, w0, w1, [])
    dev, _ = _check_partition(att, rows, w0, w1, [])
    recomputed = [k for k in dev if k.startswith(spans.RECOMPUTE)]
    assert bool(recomputed) == (remat != "none")
    assert dev["uresnet.norm"] > 0 and dev["uresnet.graph_build"] > 0


def test_cpu_run_reads_no_device_metric():
    """A traced run on the CPU has no device time: the span readers give
    nothing, so no CPU number stands under a device metric's name."""
    from perfbench.tests import tiny
    res = tiny.execute("sparse16_train_b8", trace=1)
    assert res["correct"]
    got = set(res["metrics"])
    assert not {m for m in got if m.startswith(("span_", "idle_"))}
    assert "cell_fill_pct.train" in got
