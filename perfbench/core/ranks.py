"""A cell over several cards: one rank process a card, joined by the
port's own `parallel.launch` (NCCL between cards; gloo on the CPU), each
rank a `harness.Run` whose program is `TrainVal` on its data mesh.

The parent process draws the event pool from the seed and builds the
port's kernel library once, before the ranks start, so that they do not
race one nvcc build into one directory. Every rank gets the pool in
shared memory, builds the same global blobs and hands them whole to
`TrainVal`, which takes its shard of each, as the CLI's `--gpus` path
does. Each rank makes the weights on its card from the seed (`initialize`
then copies rank 0's into every rank).

Set-up ends on each rank with the first steps; the ranks' slowest time a
step among the last of them fixes how many steps the window runs, the
same on every rank, so the loop fetches nothing per step. The window runs
on rank 0's host clock, from a barrier before the first step to a barrier
after every rank's closing sync. With tracing, rank 0 alone is profiled.

Each rank writes what it read to a file of the parent's temporary
directory: rank 0 its window, the first steps' losses, gradients and
state, and with tracing its per-layer readings; every rank its peak
memory and the forbidden modules (`core/guard.py`) it holds once its
window has closed, where any makes the run print no result. The parent then makes the events' blobs and the weights again
itself, on its own card once the ranks have exited, for the reference.
"""

from __future__ import annotations

import os
import tempfile
import time
from types import SimpleNamespace
from typing import Callable, Optional

import numpy as np
import torch

from perfbench.core.cells import Cell
from perfbench.core.guard import ForbiddenModules, forbidden_modules
from perfbench.core.harness import Run

# what a rank's window hands the parent
WINDOW_KEYS = ("seconds", "batches", "t0", "failed", "counters", "launches",
               "peak_bytes")


def _pack(pool: list) -> tuple:
    """The pool as three concatenated tensors and the events' lengths:
    passed to a spawned rank, a tensor travels in shared memory."""
    cols = [torch.from_numpy(np.concatenate([ev[i] for ev in pool]))
            for i in range(3)]
    return (*cols, torch.tensor([len(ev[0]) for ev in pool]))


def _unpack(packed: tuple) -> list:
    coords, values, labels, lens = (t.numpy() for t in packed)
    cut = np.cumsum(lens)[:-1]
    return list(zip(np.split(coords, cut), np.split(values, cut),
                    np.split(labels, cut)))


def rank_main(cell: Cell, job: dict, packed: tuple, out_dir: str,
              rank_setup: Optional[Callable]) -> None:
    """One rank: set-up, the window, and what it read, into
    `out_dir/rank<r>.pt`. `rank_setup`, where given, runs first (the
    tests plant a fault in every rank with it)."""
    import torch.distributed as dist
    t_enter = time.perf_counter()
    rank, world = dist.get_rank(), dist.get_world_size()
    if rank_setup is not None:
        rank_setup()
    torch.set_num_threads(job["threads"])
    device = torch.device("cuda", rank) if job["cuda"] else "cpu"
    run = Run(cell, job["seed"], device, job["t_start"], rank, world)
    run.setup(_unpack(packed))
    w = run.window(job["seconds"], job["trace"] and rank == 0)
    res = {k: getattr(w, k, None) for k in WINDOW_KEYS}
    res["t_enter"] = t_enter
    res["forbidden"] = forbidden_modules()
    if rank == 0:
        p = run.prog_train
        res["prog_train"] = {
            "losses": p["losses"],
            "grads": {k: v.cpu() for k, v in p["grads"].items()},
            "state": {k: v.cpu() for k, v in p["state"].items()}}
        if w.prof is not None:
            res["layers"] = run.per_layer(w)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def measure(run: Run, seconds: float, trace: bool,
            rank_setup: Optional[Callable] = None) -> SimpleNamespace:
    """Set-up and the window over the cell's cards, from the parent.
    Returns rank 0's window with the ranks' highest peak memory, its
    `setup_s` (to rank 0's window start) and, with tracing, `layers`
    (`Run.per_layer`'s result on rank 0); leaves `run` ready for the
    reference: the first steps as rank 0 read them, the blobs and the
    weights."""
    from uresnet_pytorch_tpu_torch.parallel import launch
    cell, n = run.cell, run.cell.chips
    if cell.mode != "train":
        raise ValueError(f"{cell.name}: a cell over {n} cards trains")
    t = [time.perf_counter()]
    pool = run.draw_pool()
    t.append(time.perf_counter())
    if run.sparse and run.cuda:
        from uresnet_pytorch_tpu_torch.ops import cuda as kernels
        kernels.build()
    t.append(time.perf_counter())
    # on the CPU the ranks share the machine's cores
    job = {"seed": run.seed, "cuda": run.cuda, "t_start": run.t_start,
           "seconds": seconds, "trace": trace,
           "threads": torch.get_num_threads() if run.cuda else 1}
    with tempfile.TemporaryDirectory() as out:
        launch(rank_main, n, tuple(range(n)) if run.cuda else (),
               args=(cell, job, _pack(pool), out, rank_setup))
        t.append(time.perf_counter())
        ranks = [torch.load(os.path.join(out, f"rank{r}.pt"),
                            weights_only=False) for r in range(n)]
    found = sorted({m for r in ranks for m in r["forbidden"]})
    if found:
        raise ForbiddenModules(", ".join(found))
    lead = ranks[0]
    run.prog_train = lead["prog_train"]
    run.make_inputs(pool)
    t.append(time.perf_counter())
    w = SimpleNamespace(**{k: lead[k] for k in WINDOW_KEYS}, times=None,
                        prof=None, setup_s=lead["t0"] - run.t_start)
    w.peak_bytes = max(r["peak_bytes"] for r in ranks)
    # where the set-up and the rest of the run go, on the host's clock
    w.phases = {"pool": t[1] - t[0], "build": t[2] - t[1],
                "rank_start": lead["t_enter"] - t[2],
                "rank_setup": lead["t0"] - lead["t_enter"],
                "rank_exit": t[3] - lead["t0"] - lead["seconds"],
                "reference_inputs": t[4] - t[3]}
    if trace:
        w.layers = lead["layers"]
    return w
