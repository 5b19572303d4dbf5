"""The CLI's loops: `train`, `inference` and `iotest`.

Port of `uresnet_pytorch_tpu/main_funcs.py`, with its loops, CSV columns
(`train_log.csv`, `inference_log.csv` under `log_dir`) and warnings.
`train` and `inference` take `device`: the card unless the caller asks for
"cpu"; `iotest` runs no model.

- `train` fetches scalars from the card only on report steps; the other
  steps stay asynchronous. `tforward` is the whole train step (forward,
  backward and Adam), fenced by that fetch on report steps, and
  `tbackward` is 0, as in the reference's CSV.
- `inference` sweeps the `model_path` glob in sorted (lexicographic)
  order, so `snap-10` comes before `snap-2`, as in the reference. Its
  metrics accumulate on the device as tensor adds; batch 0 is fenced by one
  `.item()` and the clock restarts there, and the one host fetch of the
  sums ends the timed pass, so `events_per_sec` is the steady rate.
- Under a data mesh (`--gpus 0,1`: `bin/uresnet_torch.py` starts one rank
  per ordinal) every metric is the global batch's, and rank 0 alone
  prints, writes the CSVs, the checkpoints and the prediction file (`-of`):
  each batch's rows of every rank reach it in one collective
  (`parallel.gather_rows`), and it stores them in the one-process batch's
  order, so the file is the one-process file.
- `profile_dir` takes a `torch.profiler` trace (CPU, and CUDA on the card)
  of the train loop and writes it there as a Chrome trace.

The reference's persistent XLA compilation cache has no counterpart: the
port compiles nothing per process but its CUDA kernels, which are built
once into `build/` and loaded from there.
"""

from __future__ import annotations

import glob
import os
import sys
import time

import numpy as np
import torch

from uresnet_pytorch_tpu_torch.config import URESNetConfig
from uresnet_pytorch_tpu_torch.iotools import io_factory
from uresnet_pytorch_tpu_torch.parallel.mesh import gather_rows
from uresnet_pytorch_tpu_torch.trainval import TrainVal
from uresnet_pytorch_tpu_torch.utils import CSVData, StopWatch


def _maybe_start_profiler(cfg: URESNetConfig, device: torch.device):
    if not cfg.profile_dir:
        return lambda: None
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()

    def stop():
        prof.stop()
        os.makedirs(cfg.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(cfg.profile_dir,
                                              "trace.json"))
    return stop


def train(cfg: URESNetConfig, io=None, device="cuda") -> TrainVal:
    tv = TrainVal(cfg, device=device)
    tv.initialize()
    lead = tv.mesh.rank == 0      # the rank that reports and writes
    io = io or io_factory(cfg)
    io.initialize()
    os.makedirs(cfg.log_dir, exist_ok=True)
    csv = CSVData(os.path.join(cfg.log_dir, "train_log.csv"))
    watch = StopWatch()
    stop_profiler = (_maybe_start_profiler(cfg, tv.device) if lead
                     else lambda: None)
    epoch_per_iter = cfg.batch_size / max(1, len(io))
    start_step = tv.global_step
    try:
        for it in range(start_step, cfg.iteration):
            watch.start("iter")
            watch.start("io")
            blob = io.next()
            tio = watch.stop("io")
            watch.start("forward")
            metrics = tv.train_step(blob)
            report = (cfg.report_step > 0 and (it + 1) % cfg.report_step == 0
                      and lead)
            if report:
                # fetch scalars only on report steps; off-step iterations
                # stay asynchronous on the device
                loss = float(metrics["loss"])
                acc = float(metrics["accuracy"])
                overflow = int(metrics["overflow"])
                tile_spill = int(metrics["tile_spill"])
                vox_spill = int(metrics["vox_spill"])
                if overflow:
                    print(f"WARNING: iter {it + 1}: {overflow} halo pairs "
                          "were DROPPED (corrupted halo values); the port's "
                          "halo and link maps are exact, so this is a fault",
                          file=sys.stderr, flush=True)
                if tile_spill:
                    print(f"WARNING: iter {it + 1}: {tile_spill} tiles "
                          f"({vox_spill} input voxels) exceeded the tile "
                          "capacity and were DROPPED (zero logits for those "
                          "voxels) — raise tile_occupancy headroom / "
                          "capacity_factor or reduce event density",
                          file=sys.stderr, flush=True)
            tfwd = watch.stop("forward")
            tsave = 0.0
            if cfg.checkpoint_step > 0 and (it + 1) % cfg.checkpoint_step == 0:
                watch.start("save")
                tv.save_state(it + 1)
                tsave = watch.stop("save")
            titer = watch.stop("iter")
            if report:
                csv.record(
                    ["iter", "epoch", "loss", "accuracy", "titer", "tio",
                     "tforward", "tbackward", "tsave", "lr", "overflow",
                     "tile_spill"],
                    [it + 1, (it + 1) * epoch_per_iter, loss, acc, titer, tio,
                     tfwd, 0.0, tsave, cfg.learning_rate, overflow,
                     tile_spill])
                csv.write()
                csv.flush()
                print(f"iter {it + 1}/{cfg.iteration} epoch "
                      f"{(it + 1) * epoch_per_iter:.3f} loss {loss:.4f} "
                      f"acc {acc:.4f} titer {titer:.3f}s (io {tio:.3f}s)",
                      flush=True)
        if cfg.checkpoint_step > 0 and cfg.iteration % cfg.checkpoint_step != 0:
            tv.save_state(cfg.iteration)
    finally:
        stop_profiler()
        csv.close()
        io.finalize()
    return tv


def _store_predictions(io, tv: TrainVal, blob, softmax) -> None:
    """Hand the writer one global batch's rows, on rank 0 alone. Each rank
    holds batch_size / ranks events of the loader's rank-strided share
    (iotools/io_base.py), so rank r's j-th event is the one-process batch's
    event ranks * j + r: the rows gathered on rank 0 interleave back into
    that order."""
    rows = gather_rows(tv.mesh, *(torch.as_tensor(np.asarray(blob[k]))
                                  for k in ("coords", "n_voxels", "index")),
                       softmax.float())
    if rows is None:                  # not rank 0
        return
    # (ranks, bs, ...) -> (bs * ranks, ...), rank r's row j at j * ranks + r
    coords, n_voxels, index, softmax = (
        r.transpose(0, 1).reshape(-1, *r.shape[2:]).cpu().numpy()
        for r in rows)
    io.store_segment(index, {"coords": coords, "n_voxels": n_voxels,
                             "index": index}, softmax)


def inference(cfg: URESNetConfig, io=None, device="cuda") -> dict:
    tv = TrainVal(cfg.replace(train=False, model_path=""), device=device)
    tv.initialize()
    lead = tv.mesh.rank == 0
    ckpts = sorted(glob.glob(cfg.model_path)) if cfg.model_path else [None]
    if cfg.model_path and not ckpts:
        raise FileNotFoundError(f"no checkpoint matches {cfg.model_path!r}")
    io = io or io_factory(cfg)
    io.initialize()
    os.makedirs(cfg.log_dir, exist_ok=True)
    csv = CSVData(os.path.join(cfg.log_dir, "inference_log.csv"))
    n_iters = max(1, len(io) // cfg.batch_size)
    last_summary = {}
    try:
        for ckpt in ckpts:
            if ckpt is not None:
                tv.restore_state(ckpt)
            acc = None
            t0 = time.perf_counter()
            for it in range(n_iters):
                blob = io.next()
                res = tv.forward(blob)
                upd = {
                    "loss": res["loss"], "accuracy": res["accuracy"],
                    "cls_correct": res["per_class_accuracy"] * res["class_count"],
                    "cls_count": res["class_count"],
                    "inter": res["intersection"], "union": res["union"],
                }
                acc = upd if acc is None else {k: acc[k] + upd[k]
                                               for k in acc}
                if cfg.output_file:
                    _store_predictions(io, tv, blob, res["softmax"])
                if it == 0:
                    # fence batch 0 and restart the clock: the reported
                    # rate is the steady state
                    res["loss"].item()
                    t0 = time.perf_counter()
            # the one host fetch: the completion fence, inside the window
            acc = {k: v.cpu().numpy() for k, v in acc.items()}
            dt = time.perf_counter() - t0
            rate_iters = max(n_iters - 1, 1)
            tot_loss, tot_acc = float(acc["loss"]), float(acc["accuracy"])
            cls_count = acc["cls_count"]
            inter, union = acc["inter"], acc["union"]
            per_class = acc["cls_correct"] / np.maximum(cls_count, 1.0)
            iou = inter / np.maximum(union, 1.0)
            miou = float(iou[cls_count > 0].mean()) if (cls_count > 0).any() else 0.0
            row_keys = (["ckpt", "loss", "accuracy", "miou",
                         "events_per_sec"] +
                        [f"acc_class{c}" for c in range(cfg.num_class)] +
                        [f"iou_class{c}" for c in range(cfg.num_class)])
            row_vals = ([os.path.basename(ckpt) if ckpt else "none",
                         tot_loss / n_iters, tot_acc / n_iters, miou,
                         rate_iters * cfg.batch_size / dt] + list(per_class)
                        + list(iou))
            last_summary = dict(zip(row_keys, row_vals))
            if not lead:
                continue
            csv.record(row_keys, row_vals)
            csv.write()
            csv.flush()
            print(f"inference {last_summary['ckpt']}: loss "
                  f"{last_summary['loss']:.4f} acc {last_summary['accuracy']:.4f} "
                  f"({last_summary['events_per_sec']:.2f} ev/s)", flush=True)
    finally:
        csv.close()
        io.finalize()
    return last_summary


def iotest(cfg: URESNetConfig, io=None) -> float:
    """Loader-only throughput: events/s over `iteration` batches after
    one warm-up batch."""
    io = io or io_factory(cfg)
    io.initialize()
    n = max(1, cfg.iteration)
    try:
        io.next()  # warmup / thread spin-up
        t0 = time.perf_counter()
        for _ in range(n):
            io.next()
        dt = time.perf_counter() - t0
    finally:
        io.finalize()
    eps = n * cfg.batch_size / dt
    print(f"iotest: {n} batches, {eps:.1f} events/s", flush=True)
    return eps
