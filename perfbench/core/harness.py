"""One run of one cell: set-up, the measured window, the per-layer
readings of a traced window, and the comparison with the reference.

The program under test is `uresnet_pytorch_tpu_torch`, driven through
`TrainVal` as its CLI drives it: `forward(blob)` in an inference cell,
`train_step(blob)` in a training cell, on the numpy blobs a loader hands
it. The loop is closed: the next batch goes in when the last returns (an
inference batch returns when its probabilities are on the host; a
training step fetches nothing until the window's one closing sync).

A cell over several cards runs one `Run` a card, each a rank of the
port's data mesh (`core/ranks.py`): `rank` and `world` say which, and the
training window then runs a number of steps fixed at set-up, the same on
every rank, between two barriers.
"""

from __future__ import annotations

import gc
import math
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import reference
from perfbench.core import check, events, peaks
from perfbench.core.cells import ROOT, Cell, load_module
from perfbench.core.trace import Trace, profiled
from perfbench.core.weights import as_variables, make_params
from perfbench.reference.common import Quant, no_tf32

COUNTERS = ("overflow", "tile_spill", "vox_spill")
GiB = float(1 << 30)
CHECKED_STEPS = 3      # the training steps the reference follows
EPOCHS_PREBUILT = 2    # epochs of batches built at set-up, then cycled


def port_counters() -> Dict[str, int]:
    """The port's kernel launch counters: B, C, A, D, E."""
    from uresnet_pytorch_tpu_torch.ops.cuda import (halo_conv, halo_conv_dw,
                                                    halo_extend,
                                                    windowed_gather)
    return {"B": halo_conv.launches, "C": halo_conv_dw.launches,
            "A": windowed_gather.launches, "D": halo_extend.launches_fwd,
            "E": halo_extend.launches_bwd}


def flags(met: dict) -> torch.Tensor:
    """The tile engine's counters of one batch, on the device."""
    return torch.stack([met[k].long() for k in COUNTERS])


def load_reader(name: str, root=ROOT):
    """The per-layer metric `name`'s reader, `perfbench/metrics/<name>.py`
    under the checkout `root`."""
    return load_module(root / "perfbench" / "metrics" / f"{name}.py",
                       "perfbench_metric_").read


class Run:
    def __init__(self, cell: Cell, seed: int, device="cuda",
                 t_start: Optional[float] = None, rank: int = 0,
                 world: int = 1):
        self.cell, self.seed = cell, int(seed)
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.model, self.traffic = cell.model, cell.traffic
        self.ref = cell.reference
        self.batch = int(self.traffic["batch"])
        self.rank, self.world = rank, world
        # the rows of each global blob this rank's program runs
        per = self.batch // world
        self.rows = range(rank * per, (rank + 1) * per)
        # the program runs the tile engine: its kernel library, launch
        # counters and graph build
        self.sparse = self.model.get("sparse_engine") == "tile"
        self.tv = None

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # set-up
    # ------------------------------------------------------------------

    def draw_pool(self) -> list:
        """The event pool of the seed."""
        m, tr = self.model, self.traffic
        return events.make_pool(
            self.seed, int(tr["pool_events"]), m["spatial_size"],
            m["data_dim"], int(tr["mean_voxels"]),
            workers=int(tr.get("pool_workers", 0)),
            max_points=tr.get("max_points"))

    def make_events(self, pool: Optional[list] = None) -> None:
        """The event pool (drawn here unless given), and its batches in
        the seed's order."""
        m = self.model
        self.pool = self.draw_pool() if pool is None else pool
        self.order = events.batch_order(self.seed, len(self.pool), self.batch,
                                        EPOCHS_PREBUILT)
        cw = self.cell.config.get("class_weights")
        self.blobs = [events.blob_of([self.pool[i] for i in idx],
                                     m["max_voxels"], m["data_dim"], cw)
                      for idx in self.order]

    def make_weights(self) -> None:
        """The weights, on the run's device from the seed."""
        self.spec = self.ref.param_spec(self.model)
        self.params = make_params(self.spec, self.seed, self.device)

    def make_inputs(self, pool: Optional[list] = None) -> None:
        """The events, their batches and the weights, all from the seed."""
        self.make_events(pool)
        self.make_weights()

    def build_program(self) -> None:
        from uresnet_pytorch_tpu_torch.config import URESNetConfig
        from uresnet_pytorch_tpu_torch.trainval import TrainVal
        # a rank of a data mesh on the card: rank r on cuda:r, as the
        # CLI's --gpus 0,1,... runs it
        gpus = tuple(range(self.world)) if self.world > 1 and self.cuda \
            else ()
        self.cfg = URESNetConfig(**self.model, batch_size=self.batch,
                                 train=self.cell.mode == "train", gpus=gpus)
        if self.sparse and self.cuda:
            from uresnet_pytorch_tpu_torch.ops import cuda as kernels
            kernels.library()
        self.tv = TrainVal(self.cfg, device=self.device)
        self.tv.initialize(as_variables(self.params))

    def first_steps(self) -> None:
        """Training: the first steps through the window's own call, on
        batches whose events all differ. The reference follows them: each
        step's loss, the first gradient as Adam holds it after step 1
        (its first moment over 1 - b1), and the state after the last."""
        tv = self.tv
        b1 = tv.optimizer.param_groups[0]["betas"][0]
        losses, grads = [], None
        n = CHECKED_STEPS
        for i in range(n):
            if i == 1 and self.world > 1:
                self.sync()
                t1 = time.perf_counter()
            met = tv.train_step(self.blobs[i])
            self._bad_steps(flags(met))
            losses.append(met["loss"].detach().clone())
            if i == 0:
                st = tv.optimizer.state
                grads = {k: (st[p]["exp_avg"] / (1.0 - b1) if p in st
                             else torch.zeros_like(p))
                         for k, p in tv.model.named_parameters()}
        state = {k: v.detach().clone() for k, v in
                 list(tv.model.named_parameters())
                 + list(tv.model.named_buffers())}
        self.prog_train = {"losses": [float(x) for x in losses],
                           "grads": grads, "state": state}
        self.next = n
        if self.world > 1:
            # the ranks' slowest time a step, which fixes the window's
            # steps on every rank alike
            self.sync()
            t = torch.tensor([(time.perf_counter() - t1) / (n - 1)],
                             dtype=torch.float64, device=tv.mesh.device)
            torch.distributed.all_reduce(t, torch.distributed.ReduceOp.MAX,
                                         group=tv.mesh.group)
            self.step_s = float(t)

    def setup(self, pool: Optional[list] = None) -> None:
        self.make_inputs(pool)
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        self.build_program()
        if self.cell.mode == "train":
            self.first_steps()
        else:
            n = int(self.traffic.get("warmup_batches", 2))
            for i in range(n):
                out = self.tv.forward(self.blobs[i % len(self.blobs)])
                out["softmax"].float().cpu().numpy()
                flags(out).cpu()
            self.next = n
        self.sync()

    # ------------------------------------------------------------------
    # the window
    # ------------------------------------------------------------------

    def barrier(self) -> None:
        """Returns when every rank has reached it and its card is idle."""
        self.sync()
        x = torch.zeros(1, device=self.tv.mesh.device)
        torch.distributed.all_reduce(x, group=self.tv.mesh.group)
        self.sync()

    def window(self, seconds: float, trace: bool) -> SimpleNamespace:
        before = port_counters() if self.sparse else None
        if self.world > 1:
            self.barrier()
        with profiled(trace, self.cuda) as prof:
            if self.cell.mode == "train":
                w = self._train_window(seconds)
            else:
                w = self._infer_window(seconds)
        w.peak_bytes = (torch.cuda.max_memory_allocated(self.device)
                        if self.cuda else 0)
        if before is not None:
            after = port_counters()
            w.launches = {k: (after[k] - before[k]) / max(w.batches, 1)
                          for k in after}
        w.prof = prof
        return w

    def _infer_window(self, seconds: float) -> SimpleNamespace:
        tv, n = self.tv, len(self.blobs)
        keep = int(self.traffic["checked_batches"])
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 11]))
        kept: List[tuple] = []
        times, ran = [], []
        counts = np.zeros(len(COUNTERS), np.int64)
        failed = 0
        t0 = time.perf_counter()
        t_end = t0 + seconds
        while True:
            bi = self.next % n
            self.next += 1
            ts = time.perf_counter()
            out = tv.forward(self.blobs[bi])
            probs = out["softmax"].float().cpu().numpy()
            f = flags(out).cpu().numpy()
            te = time.perf_counter()
            times.append(te - ts)
            ran.append(bi)
            counts += f
            if (f > 0).any():
                failed += self.batch
            # a uniform sample of the window's batches (reservoir)
            if len(kept) < keep:
                kept.append((bi, probs))
            else:
                j = int(rng.integers(0, len(ran)))
                if j < keep:
                    kept[j] = (bi, probs)
            if te >= t_end:
                break
        self.kept = kept
        return SimpleNamespace(seconds=te - t0, batches=len(ran), ran=ran,
                               times=times, failed=failed,
                               counters=dict(zip(COUNTERS, counts.tolist())))

    def _train_window(self, seconds: float) -> SimpleNamespace:
        """Steps until `seconds` have passed; over several ranks, the
        steps that take that long at set-up's time a step, then the
        closing barrier: every rank runs the same steps."""
        tv, n = self.tv, len(self.blobs)
        steps = (max(1, math.ceil(seconds / self.step_s))
                 if self.world > 1 else None)
        ran = []
        self._counts.zero_()
        self._bad.zero_()
        t0 = time.perf_counter()
        t_end = t0 + seconds
        while (len(ran) < steps if steps is not None
               else time.perf_counter() < t_end):
            bi = self.next % n
            self.next += 1
            self._bad_steps(flags(tv.train_step(self.blobs[bi])))
            ran.append(bi)
        if steps is not None:
            self.barrier()
        self.sync()
        seconds_run = time.perf_counter() - t0
        return SimpleNamespace(seconds=seconds_run, batches=len(ran), ran=ran,
                               times=None, t0=t0,
                               failed=int(self._bad) * self.batch,
                               counters=dict(zip(COUNTERS,
                                                 self._counts.cpu().tolist())))

    def _bad_steps(self, c: torch.Tensor) -> None:
        """Training: the counters and the steps with one above 0, summed on
        the device, so that a step fetches nothing."""
        if not hasattr(self, "_bad"):
            self._counts = torch.zeros_like(c)
            self._bad = torch.zeros((), dtype=torch.long, device=c.device)
        self._counts += c
        self._bad += (c > 0).any().long()

    # ------------------------------------------------------------------
    # per-layer readings of a traced window
    # ------------------------------------------------------------------

    def work(self, ran: List[int]) -> dict:
        """The model work of this rank's events of the batches run, from
        the reference module's `work`: FLOPs, and the least time of the
        convolutions the roofline shares read, three times a forward's in
        training."""
        mult = 3.0 if self.cell.mode == "train" else 1.0
        tot = {"flops": 0.0, "sm_bound_s": 0.0, "dense_conv_bound_s": 0.0}
        cache: Dict[int, dict] = {}
        for bi in ran:
            if bi not in cache:
                blob = self.blobs[bi]
                coords = [torch.as_tensor(
                    blob["coords"][b, :int(blob["n_voxels"][b])],
                    device=self.device) for b in self.rows]
                cache[bi] = self.ref.work(self.model, coords)
            for k in tot:
                tot[k] += cache[bi][k] * mult
        return tot

    def graph_build_ms(self) -> Optional[float]:
        """Mean ms of the program's graph build (`build_tile_graph`) on
        each batch of one epoch of the pool, timed with CUDA events, after
        one build to warm up."""
        if not (self.sparse and self.cuda):
            return None
        from uresnet_pytorch_tpu_torch.ops.tile_graph import build_tile_graph
        per_epoch = len(self.pool) // self.batch
        ms = []
        for i in range(-1, per_epoch):
            blob = self.blobs[max(i, 0)]
            args = [torch.as_tensor(blob[k], device=self.device)
                    for k in ("coords", "values", "n_voxels")]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            self.sync()
            start.record()
            g = build_tile_graph(*args, self.cfg)
            end.record()
            self.sync()
            del g
            if i >= 0:
                ms.append(start.elapsed_time(end))
        return float(np.mean(ms))

    def per_layer(self, w: SimpleNamespace) -> tuple:
        """(the per-layer metrics this cell reports, busy_s, window_s,
        breakdown) from the traced window."""
        tr = Trace(w.prof)
        ctx = SimpleNamespace(mode=self.cell.mode, batch=self.batch,
                              steps=w.batches, trace=tr, prof=w.prof,
                              work=self.work(w.ran),
                              graph_build_ms=self.graph_build_ms,
                              peak_flops=peaks.PEAK_FLOPS,
                              peak_bytes=peaks.PEAK_BYTES)
        out = {}
        for m in self.cell.per_layer:
            v = load_reader(m["name"], self.cell.root)(ctx)
            if v is not None:
                out[m["name"]] = {"value": float(v), "unit": m["unit"]}
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
        return out, tr.busy_s(), tr.window_s, breakdown

    # ------------------------------------------------------------------
    # the comparison
    # ------------------------------------------------------------------

    def free_program(self) -> None:
        self.tv = None
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def reference_run(self, quant: Optional[Quant] = None):
        """The reference on what the program was given: the logits of the
        sampled batches, or the first training steps."""
        if self.cell.mode == "train":
            return self.reference_run_steps(len(self.prog_train["losses"]),
                                            quant)
        with no_tf32():
            return [self.ref.infer(self.model, self.params, self.blobs[bi],
                                   self.device, quant)
                    for bi, _ in self.kept]

    def reference_run_steps(self, n: int, quant: Optional[Quant] = None,
                            half_batch: bool = False) -> dict:
        with no_tf32():
            return reference.train_steps(self.ref, self.model, self.params,
                                         self.blobs[:n], self.device, quant,
                                         half_batch)

    def numbers(self, ref, detail: Optional[dict] = None
                ) -> Dict[str, float]:
        if self.cell.mode == "train":
            return check.train_numbers(self.prog_train, ref, self.params,
                                       detail)
        return check.infer_numbers(
            [(probs, self.blobs[bi]["n_voxels"], r)
             for (bi, probs), r in zip(self.kept, ref)])

    def served_as(self, ref) -> list:
        """Another run's logits of the sampled batches as probabilities
        laid out as the program serves them: what a control or a fault is
        judged on in the program's place."""
        out = []
        shape = (self.batch, self.model["max_voxels"], self.model["num_class"])
        for (bi, _), logits in zip(self.kept, ref):
            p = np.zeros(shape, np.float32)
            soft = torch.softmax(logits.float(), -1).cpu().numpy()
            off = 0
            for b, n in enumerate(self.blobs[bi]["n_voxels"]):
                p[b, :n] = soft[off:off + n]
                off += n
            out.append((bi, p))
        return out


def measure(run: Run, seconds: float, trace: bool,
            rank_setup=None) -> SimpleNamespace:
    """Set-up and the window of a run: in this process, or one rank
    process a card where the cell takes several (`core/ranks.py`, which
    runs `rank_setup` first in each rank). The window carries `setup_s`
    and, with tracing, `layers` (`Run.per_layer`'s result)."""
    if run.cell.chips > 1:
        from perfbench.core import ranks
        return ranks.measure(run, seconds, trace, rank_setup)
    run.setup()
    setup_s = time.perf_counter() - run.t_start
    w = run.window(seconds, trace)
    w.setup_s = setup_s
    if trace:
        w.layers = run.per_layer(w)
    return w


def p95_ms(times: List[float]) -> float:
    return float(np.percentile(np.asarray(times) * 1e3, 95))


def end_to_end(cell: Cell, w: SimpleNamespace, setup_s: float
               ) -> Dict[str, dict]:
    """The cell's end-to-end metrics, from the host clock."""
    events_done = w.batches * int(cell.traffic["batch"])
    known = {"setup_s": setup_s, "peak_mem_gib": w.peak_bytes / GiB}
    if cell.mode == "infer":
        known["infer_events_per_s"] = events_done / w.seconds
        known["infer_batch_p95_ms"] = p95_ms(w.times)
    else:
        known["train_events_per_s"] = events_done / w.seconds
    out = {}
    for m in cell.end_to_end:
        # each quantity under whichever name of its kind the cell reports
        # (a cell may have a metric and a bound of its own)
        kind = [k for k in known if m["name"].endswith(k)]
        if not kind:
            raise KeyError(f"{cell.name}: the harness does not measure "
                           f"{m['name']!r}")
        out[m["name"]] = {"value": known[kind[0]], "unit": m["unit"]}
    return out
