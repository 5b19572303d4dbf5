"""The port's benchmark timer (`uresnet_pytorch_tpu_torch/utils/benchmark.py`)
against the reference's contract (`uresnet_pytorch_tpu/utils/benchmark.py`),
on the CPU: the same names, arguments and defaults; 2 * (n1 + n2) calls,
each trip length run once to warm and once timed; each call chained to the
previous one's result; a known cost read back as seconds per call; and
`timed_train` driving a CPU `TrainVal`."""

import inspect
import math
import time

import numpy as np
import pytest
import torch

from uresnet_pytorch_tpu.utils import benchmark as j_benchmark
from uresnet_pytorch_tpu_torch.config import URESNetConfig as TConfig
from uresnet_pytorch_tpu_torch.trainval import TrainVal
from uresnet_pytorch_tpu_torch.utils import benchmark
from tests.test_torch_model import one_torch_thread  # noqa: F401
from tests.test_torch_train import _blob


@pytest.mark.parametrize("name", ["timed_step", "timed_train"])
def test_signatures_match_the_reference(name):
    ours = inspect.signature(getattr(benchmark, name))
    ref = inspect.signature(getattr(j_benchmark, name))
    assert [(p.name, p.default, p.kind) for p in ours.parameters.values()] \
        == [(p.name, p.default, p.kind) for p in ref.parameters.values()]


@pytest.mark.parametrize("n1,n2", [(1, 5), (2, 3)])
def test_timed_step_chains_every_call(n1, n2):
    """2 * (n1 + n2) calls in four trips of n1, n1, n2, n2; a trip's first
    call gets a float32 zero, each later call the previous call's result;
    the args arrive as given."""
    x = torch.arange(4.0)
    seen, returned = [], []

    def step(chain, a, b):
        assert a is x and b == 7
        seen.append(chain)
        out = (a * chain).sum() + 1.0
        returned.append(out)
        return out

    dt = benchmark.timed_step(step, (x, 7), n1=n1, n2=n2)
    assert len(seen) == 2 * (n1 + n2)
    assert math.isfinite(dt) and dt > 0
    starts = np.cumsum([0, n1, n1, n2])
    for i, chain in enumerate(seen):
        if i in starts:
            assert chain.dtype == torch.float32 and chain.shape == ()
            assert float(chain) == 0.0
        else:
            assert chain is returned[i - 1]


def test_timed_train_chains_the_state():
    """step_fn gets the state the previous call returned (the initial state
    at each trip's start) and the batch as given."""
    state0, batch = object(), {"x": 1}
    seen = []

    def step_fn(state, b):
        assert b is batch
        seen.append(state)
        new = object()
        return new, {"loss": torch.tensor(1.0, dtype=torch.bfloat16),
                     "state": new}

    benchmark.timed_train(step_fn, state0, batch, n1=1, n2=3)
    assert len(seen) == 2 * (1 + 3)
    assert [s is state0 for s in seen] == \
        [True, True, True, False, False, True, False, False]


@pytest.mark.parametrize("fn", ["timed_step", "timed_train"])
def test_reads_a_known_cost(fn):
    """A step that sleeps 20 ms reads about 0.02 s a call: the constant
    cost around the trips cancels in the slope."""
    def nap(chain, *_):
        time.sleep(0.02)
        return chain + 1.0
    if fn == "timed_step":
        dt = benchmark.timed_step(nap, (torch.zeros(2),))
    else:
        dt = benchmark.timed_train(
            lambda st, b: (st, {"loss": nap(torch.zeros(()))}), None, None)
    assert 0.015 <= dt <= 0.2, dt


def test_timed_train_drives_trainval():
    """On a CPU TrainVal at a tiny config: 2 * (n1 + n2) optimizer steps,
    finite losses, and a finite positive time."""
    cfg = TConfig(num_class=5, uresnet_filters=4, uresnet_num_strides=2,
                  spatial_size=16, data_dim=3, reps=1, max_voxels=128,
                  min_level_capacity=32, batch_size=1,
                  compute_dtype="float32")
    tv = TrainVal(cfg, device="cpu")
    tv.initialize()
    blob = _blob(cfg, B=1, mean_voxels=60)
    losses = []

    def step_fn(tv_, b):
        metrics = tv_.train_step(b)
        losses.append(float(metrics["loss"]))
        return tv_, metrics

    dt = benchmark.timed_train(step_fn, tv, blob, n1=1, n2=2)
    assert tv.global_step == 2 * (1 + 2)
    assert len(losses) == 6 and all(map(math.isfinite, losses))
    assert math.isfinite(dt) and dt > 0
