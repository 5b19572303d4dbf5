"""Benchmark timing: seconds per call of a step, on the device its tensors
live on.

Port of `uresnet_pytorch_tpu/utils/benchmark.py`, with its names,
arguments and meaning. A CUDA call returns once its kernels are queued, so
a clock around one call reads the launch, not the work. The timer runs a
trip of n chained calls: each call gets the scalar tensor the previous one
returned, so no call can be skipped or overlapped with the next, and the
returned scalars accumulate on the device. One host fetch (`.item()`) of
the sum ends the timed window; it waits for every kernel the trip queued.
Time per call is the slope between trips of n1 and n2 calls, so the
constant cost (the first launch's latency, the fetch) cancels. Each trip
length runs once to warm (kernel builds and loads, the allocator's first
blocks) and once timed. The loops are plain Python on tensors: nothing is
compiled or captured, so the host's launch work counts where it is not
hidden behind the device's. On CPU tensors the same loops time the CPU.
"""

from __future__ import annotations

import time
from typing import Callable

import torch


def _device_of(tree) -> torch.device:
    """The device of the first tensor off the CPU in a nest of tuples,
    lists and dicts; the CPU where there is none."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    items = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (tuple, list)) else ())
    for item in items:
        dev = _device_of(item)
        if dev.type != "cpu":
            return dev
    return torch.device("cpu")


def _slope(run: Callable[[int], float], n1: int, n2: int) -> float:
    """Seconds per call between trips of n1 and n2 calls, each run once to
    warm and once timed."""
    times = {}
    for n in (n1, n2):
        run(n)
        t0 = time.perf_counter()
        run(n)
        times[n] = time.perf_counter() - t0
    return max(times[n2] - times[n1], 1e-9) / (n2 - n1)


def timed_step(step: Callable, args, n1: int = 1, n2: int = 5) -> float:
    """Seconds per call of `step(chain, *args) -> f32 scalar tensor`.

    `chain` is a float32 scalar on the args' device (0 for a trip's first
    call, else the previous call's result) that the step must mix into its
    computation, and its result must depend on the step's output (e.g.
    ``out.sum() * 1e-30``): that chain serializes the calls."""
    dev = _device_of(args)

    def run(n: int) -> float:
        chain = acc = torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(n):
            chain = step(chain, *args)
            acc = acc + chain
        return acc.item()
    return _slope(run, n1, n2)


def timed_train(step_fn: Callable, state, batch, n1: int = 1,
                n2: int = 5) -> float:
    """Seconds per training step. `step_fn(state, batch) -> (state,
    metrics)`; the state it hands on is the chained dependency, and
    `metrics["loss"]` accumulates. With `trainval.TrainVal`, which updates
    itself in place: ``timed_train(lambda tv, b: (tv, tv.train_step(b)),
    tv, blob)``, which takes 2 * (n1 + n2) steps."""
    def run(n: int) -> float:
        st = state
        acc = torch.zeros((), dtype=torch.float32)
        for _ in range(n):
            st, metrics = step_fn(st, batch)
            acc = acc + metrics["loss"].float()
        return acc.item()
    return _slope(run, n1, n2)
