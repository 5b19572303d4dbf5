#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `uresnet_pytorch_tpu_torch/csrc/`
(nvcc, into build/torch_kernels/), then:

1. holds kernels A and B against their plain torch versions at the shapes
   config-3 inference gives them (B at every conv shape of the forward:
   the stem, L0 and the decoder's L0 concat at t=4, L1-L4 and the decoder's
   L3 concat at t=2, each on the plan `kernel_plan` gives it; A's two link
   directions at links 1-3 at widths 1, 48, 64 and 80, and in float32, at
   a t_c=4 link of a global t=4 graph and at links of 2D graphs, and its
   single-spec gather), and times them with CUDA events (A on the
   device-only timer `device_ms`, beside `torch.gather` of the same rows);
2. drives BASELINE config 3 (sparse U-ResNet inference, 512^3 events of
   ~1e5 voxels, batch 8, bf16, tile schedule (4,2,2,2,2); random weights
   from a seed) through `models.construct("uresnet_sparse")`: one
   profiled forward (device time by kernel kind, and the link ops' share),
   then three timed forwards whose kernel launches it counts (kernel A's
   exactly: 9 a forward, 21 a config-4 step, on every path), and compares
   the logits with the same model on the plain versions;
3. holds the backward's kernels against their plain versions on config
   4's real halo maps (batch 2): kernel C (d_W) at every conv shape of the
   step (on `dw_plan`'s plan), timed, and kernel B as d_x
   on flipped weights; then kernels C and B at the branches that other
   widths and tile sizes reach (L3 128->128 with two Cout slices, C's
   packed path at Cin 8, and tile_size=8's one-tile chunks on a t=8 graph
   of the same events);
4. drives BASELINE config 4 (the same model training at batch 2 with
   remat_mode="stage_dots" and Adam at 1e-3) through
   `trainval.TrainVal`: one step on the kernels against one on the plain
   versions (loss, every gradient, the new BN moments), the kernel
   launches of one step (kernel C's by shape, which with phase 3's times
   give its ms per step), five steps on one batch (finite, falling
   losses), step time and events/s, and peak memory under "stage_dots"
   and under "none";
5. holds kernels D (the halo extend) and E (its transpose) against their
   plain versions, bitwise, on config 3's real halo maps at every extend
   shape of the unfused path (L0 with C = 1, 16 and 32, L2, L4, and L0 in
   float32), and times them beside the bound and a one-call torch
   yardstick (`index_select` / `index_add_` over a flat row map);
6. drives config-3 inference with `ops.tile_conv.USE_FUSED = False` (the
   unfused tile conv: kernel D, a cuDNN VALID conv, the epilogue in torch)
   for three forwards against the fused kernel path from the same weights,
   then one float32 forward on the auto path, which takes the unfused
   conv on the card, against the plain f32 path;
7. drives config-4 training with `USE_FUSED = False`: one step against
   the fused kernel step (and each gradient against the plain f32 step's
   bf16 noise), the launches of kernels D and E in one step, step time and
   peak memory under "stage_dots" and "none";
8. drives config 3 and 4 at four configurations whose widths or tile size
   kernels B and C's plans once refused (`WIDTH_CASES`):
   `uresnet_filters=12` (widths 12, 36 and 60: Cout no multiple of 8),
   `width_ramp="geometric"` (256 -> 256), `uresnet_filters=32` (160 ->
   160) and `tile_size=8` with `tile_sizes=None` (t=8 at every level: the
   decoder's 96 -> 48 and 128 -> 64 concat convs): for each, one forward
   (batch 2) and one training step (batch 1), each held to the plain path
   at phase 2's and phase 4's bounds, with the exact launches of kernels
   A-E (37 B a forward, 81 B and 41 C a step, no D or E), every bf16 conv
   decided fused (`record_rule`), three timed forwards and steps and the
   peak memory of each; phases 1 and 3 hold B, its d_x and C at each of
   these convs' shapes (`WIDTH_B`, `WIDTH_DW`, `WIDTH_DX`, `WIDTH_T8`)
   beside the unfused path's time for the same conv;
9. drives the port's CLI (`flags.parse_args` on a user's argv, then
   `main_funcs`) on synthetic events in a temporary directory: `train` at
   config 4 for 3 iterations with a checkpoint each (3 checkpoints, a
   3-row `train_log.csv` in the reference's columns, finite losses,
   exactly 81 B, 41 C and 21 A launches a step), a fresh `TrainVal`
   restored from the last checkpoint (logits `torch.equal` to the trained
   model's), `inference` at config 3 over the checkpoint glob (3 rows of
   `inference_log.csv`, exactly 37 B and 9 A launches a forward; with
   h5py, the prediction file read back), and `iotest`; it prints the
   CLI's events/s and step times beside phases 2 and 4, the checkpoint's
   size and its save and restore times, and which host collate ran;
10. drives the dense U-ResNet (`construct("uresnet_dense")`, cuDNN
   convolutions) at BASELINE config 1 (64^3, batch 1, bf16): its float32
   forward on the card against the same weights on the CPU (max|delta|
   <= 1e-4 max|ref|), the bf16 forward against the f32 one at phase 2's
   bounds, ten timed forwards; at config 2 (128^3, batch 1, class weights
   1.0 / 0.5, training through `TrainVal`): a bf16 step against an f32
   step at phase 4's bounds, the running moments after one step against
   one momentum update from that step's batch moments (each block is
   recomputed in backward), five steps, step time and peak memory; and
   `train -mn uresnet_dense` (2 iterations, a checkpoint each) and
   `inference` over the checkpoints through the CLI;
11. drives the row-gather engine (`sparse_engine="gather"`) at config 3:
   the tile engine's logits (37 B, 9 A launches) held to the gather
   engine's from the same variables at phase 2's bounds, three timed
   forwards; and at config 4's shape (batch 2): a step against the tile
   engine's step, five steps, step time and peak memory. Neither phase 10
   nor 11 launches any of kernels A-E, which they check.
12. drives data parallel at config 5 (`benchmarks/run_all.py:159-173`:
   config 4's model at batch max(2, ranks)) through `parallel.launch` and
   `TrainVal`: (a) one NCCL rank, four steps from phase 4's variables and
   blob, step 1 held to phase 4's step without a process group at phase
   4's bounds; (b) two ranks on the one card over gloo (NCCL refuses two
   ranks on one device), one event each, two steps, step 1 held to the
   one-process step at DP_BOUNDS, and the same step in f32 (the unfused
   path) at DP_F32_BOUNDS; planted faults (per-rank BN, DDP's; per-rank
   loss normalization with averaged gradients) must break those bounds.
   Every step of every rank launches exactly 81 B, 41 C and 21 A, (b)'s
   parameters are `torch.equal` across the ranks after each step; step
   times beside phase 4's ((b) labelled: not a multi-card rate) and peak
   memory. (c) `main_funcs.inference` with `-of` at config 3 over two
   checkpoints of 12 events, in one process and on two gloo ranks sharing
   the card: a recording loader stands in for the h5 file (the card's
   machine has no h5py), and rank 0 must hand `io.store_segment` the
   one-process rows (index, coords, n_voxels `torch.equal`, softmax at
   phase 2's bounds), rank 1 nothing.
13. drives the SCN layer API (`uresnet_pytorch_tpu_torch.scn`): a U-Net
   of its layers (submanifold convs with BN-LeakyReLU, a stride-2
   Convolution, MaxPooling and AveragePooling down, UnPooling and
   Deconvolution up with channel joins) on one config-3 event, in f32 on
   the card and on the CPU and in f64 on the CPU (the witness): the
   train-mode forward, the running moments it commits, and an eval-mode
   forward and backward held card vs CPU at max|delta| <= 1e-4 max|ref|,
   the train-mode backward held to the witness at SCN_TRAIN_GRAD_BOUND
   (the CPU's f32 gap to it printed beside); max and average pooling on a
   fully active 32^3 grid held to F.max_pool3d / F.avg_pool3d; no launch
   of kernels A-E.
14. drives the eval pair (`URESNET_EVAL_PAIR=1`, the reference's batch-16
   memory A/B) at config 3: forwards at batch 16 with the knob unset
   (concat) and set (pair) from the same variables and events, the pair
   held to concat and to the plain path at phase 2's bounds, the exact
   kernel-B and kernel-A launches of each forward (37 and 9 concat, 41 and
   9 pair), three timed forwards and the peak memory each way, and the
   same readings at batch 8 beside phase 2's.
15. times the config-3 forward with `utils.benchmark.timed_step` and the
   config-4 step with `timed_train` (the port of the reference's timer),
   beside phase 2's and phase 4's medians.
16. holds the BN kernels (`csrc/norm_act.cu`: stats, apply, bwd reduce,
   bwd apply) to their plain versions at every BN input of a config-3
   train forward at batch 8 (level 0 C = 16 and the pair 16+16 up to level
   4's 80, on their real masks, re-masked; one at a leaky slope), at
   widths 12, 36, 60 and 256, level 0 in f32, the dense level 0 (8, 16,
   128^3) channels-last in bf16 and f32, and every BN input of the
   row-gather engine's config-3 and config-4 train forwards (masked, no
   re-mask), each at its stated tolerance (`NORM_SUM_RTOL`, one rounding,
   `NORM_FLIP_SHARE`); times each kernel on `device_ms` beside its byte
   bound and the plain chain's forward and backward; and checks that the
   kernels refuse a volume whose channels are not contiguous. Phases 2
   and 4 assert the BN launches (27 a forward, 180 and 90 a step; the
   plain path, on which `plain_versions` runs the kernels' plain versions,
   none), phase 11 the row-gather engine's (45 a forward, 162 and 90 a
   step).
17. MinkUNet34C (`models/minkunet_tiled.py`, `construct("minkunet34c")`;
   `mink_phase`, alone with `python3 chip_smoke.py --mink`): the BN
   operator with a residual (`norm_act(..., residual=r)`: apply, bwd
   reduce and bwd apply with r, d_r written) against its plain versions at
   the model's level-0 width (96) and level-4 width (256) on their real
   masks of a 512^3 batch of 8 (level 0 in f32: its first 4 events),
   bf16 and f32, slopes 0 and 1 (the
   projection's BN), timed beside the same kernels without r; kernels D
   and E at a halo of 2 (the 5^3 stem), bitwise against their plain
   versions on real maps (t=4 at C=1 bf16 and f32 and C=32, t=2 at C=32:
   E's 32-entry table); kernel B's wide path (`kernel_plan`'s ring > 0)
   at every conv of the model that takes it (`MINK_B`), raw, with the
   epilogue and as d_x, against its plain version on the batch-8 graph,
   timed beside its bound and the unfused path (D + cuDNN, `unfused_ms`);
   then the whole model at its published widths on one 512^3 batch: eval
   logits and one train step (stage_dots) on the kernels against the
   plain versions (phase 2's and phase 4's bounds), the kernel launches of
   a step (100 of kernel B, `MINK_STEP_WIDE` of them wide), and three
   timed steps at batch 8 with their peak memory.

Every check raises, so any failure exits nonzero. The last line is a JSON
object naming the device; the line before it lists each kernel's route,
launches, error, times and bound. The script imports nothing of JAX or of
the JAX package: the port carries its own configuration and event
generator.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import glob
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

SEED = 0
BATCH = 8
BATCH4 = 2              # config 4: benchmarks/run_all.py's training batch
N_VOXELS = 100_000      # per event, as bench.py
HALO_RTOL, HALO_ATOL = 2e-2, 1e-2   # bf16 bound of tests/test_tpu_gated.py
DW_RTOL = 1e-3          # kernel C: max|err| <= DW_RTOL * max|ref|; f32 sums
#                         in another order over up to ~4e6 cells
PEAK_FLOPS = 989e12     # H100 SXM bf16 dense tensor-core peak, FLOP/s
PEAK_BYTES = 3.35e12    # H100 SXM HBM3, bytes/s


# kernels D and E in phase 5: every extend shape of the unfused path at
# config 3 (batch 8): the stem (C = 1), L0 blocks, the decoder's L0 concat
# (C = 32, the largest extend: 1.6e9 values), t=2 blocks at L2 and L4, and
# L0 in float32 (the auto path's dtype); (name, level, t, C, dtype)
EXTEND_SHAPES = (("L0 t=4 C=16", 0, 4, 16, torch.bfloat16),
                 ("stem L0 t=4 C=1", 0, 4, 1, torch.bfloat16),
                 ("dec concat L0 t=4 C=32", 0, 4, 32, torch.bfloat16),
                 ("L2 t=2 C=48", 2, 2, 48, torch.bfloat16),
                 ("L4 t=2 C=80", 4, 2, 80, torch.bfloat16),
                 ("L0 t=4 C=16 f32", 0, 4, 16, torch.float32))


# kernels B and C at the widths of phase 8's configurations, each beside
# the unfused path (kernel D + cuDNN) that took those convs before:
# (name, level, t, Cin, Cout) of the forward convs on config 3's maps
# (phase 1), of the d_W and d_x (of a conv Cin -> Cout) on config 4's
# (phase 3). uresnet_filters=12 runs widths 12-60, whose Cout is no
# multiple of 8; the decoder's first conv after the concat takes 2 Cout,
# and in training runs as two half convs (d_x 12 -> 24 and 36 -> 72 of the
# concat convs only in these checks). The bottom level (L4) runs 160 ->
# 160 at uresnet_filters=32 and 256 -> 256 at width_ramp="geometric".
# WIDTH_T8: tile_size=8's decoder convs after the concat at levels 2 and 3
# (96 -> 48, 128 -> 64), in eval (training runs them as halves), on a
# t=8 graph of config 4's events: kernel B and, at the same widths, C.
WIDTH_B = (("f12 stem L0 t=4 1->12", 0, 4, 1, 12),
           ("f12 L0 t=4 12->12", 0, 4, 12, 12),
           ("f12 dec L0 t=4 24->12", 0, 4, 24, 12),
           ("f12 L2 t=2 36->36", 2, 2, 36, 36),
           ("f12 dec L2 t=2 72->36", 2, 2, 72, 36),
           ("f12 L4 t=2 60->60", 4, 2, 60, 60),
           ("f32 L4 t=2 160->160", 4, 2, 160, 160),
           ("geo L4 t=2 256->256", 4, 2, 256, 256))
WIDTH_DW = (("f12 stem L0 t=4 1->12", 0, 4, 1, 12),
            ("f12 L0 t=4 12->12", 0, 4, 12, 12),
            ("f12 L2 t=2 36->36", 2, 2, 36, 36),
            ("f12 L4 t=2 60->60", 4, 2, 60, 60),
            ("f32 L4 t=2 160->160", 4, 2, 160, 160),
            ("geo L4 t=2 256->256", 4, 2, 256, 256))
WIDTH_DX = (("f12 L0 t=4 12->12", 0, 4, 12, 12),
            ("f12 dec L0 t=4 24->12", 0, 4, 24, 12),
            ("f12 L2 t=2 36->36", 2, 2, 36, 36),
            ("f12 dec L2 t=2 72->36", 2, 2, 72, 36),
            ("f12 L4 t=2 60->60", 4, 2, 60, 60),
            ("f32 L4 t=2 160->160", 4, 2, 160, 160),
            ("geo L4 t=2 256->256", 4, 2, 256, 256))
WIDTH_T8 = (("t8 dec L2 t=8 96->48", 2, 8, 96, 48),
            ("t8 dec L3 t=8 128->64", 3, 8, 128, 64))

# MinkUNet34C's convs on kernel B's wide path (`kernel_plan`'s ring > 0),
# held and timed in phase 17 on its 512^3 batch-8 graph: (name, level, t,
# Cin, Cout) of every such forward conv, and each one's d_x (Cout -> Cin
# on flipped weights). The decoder's first conv runs as two convs, against
# the up half and the skip half; the up convs at levels 0-1 (96 -> 96) and
# the skip convs 32 -> 96 stay on the resident path, as do levels 1-2's
# 32 -> 32 and 32 -> 64 and their d_x.
MINK_B = (("mink L0 dec t=4 96->96", 0, 4, 96, 96),
          ("mink L1 dec t=2 96->96", 1, 2, 96, 96),
          ("mink L2 t=2 64->64", 2, 2, 64, 64),
          ("mink L2 dec t=2 64->128", 2, 2, 64, 128),
          ("mink L2 dec t=2 128->128", 2, 2, 128, 128),
          ("mink L3 t=2 64->128", 3, 2, 64, 128),
          ("mink L3 t=2 128->128", 3, 2, 128, 128),
          ("mink L3 dec t=2 128->256", 3, 2, 128, 256),
          ("mink L3 dec t=2 256->256", 3, 2, 256, 256),
          ("mink L4 t=2 128->256", 4, 2, 128, 256),
          ("mink L4 t=2 256->256", 4, 2, 256, 256))
# of a stage_dots step's 100 kernel-B launches (50 forward convs, 50 d_x),
# those on the wide path: the forward convs of MINK_B's shapes (5 at L2
# 64->64, 4 + 1 at dec L2, 1 + 7 at L3, 4 + 1 at dec L3, 1 + 11 at L4, 4
# at dec L1, 4 at dec L0) and their d_x
MINK_STEP_WIDE = 2 * 43


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def config3():
    from uresnet_pytorch_tpu_torch.config import URESNetConfig
    return URESNetConfig(
        num_class=5, uresnet_filters=16, uresnet_num_strides=5,
        spatial_size=512, data_dim=3, reps=2,
        max_voxels=max(256, 1 << int(np.ceil(np.log2(N_VOXELS * 1.3)))),
        capacity_factor=0.5, min_level_capacity=2048, tile_size=4,
        tile_occupancy=4.5, tile_sizes=(4, 2, 2, 2, 2),
        compute_dtype="bfloat16")


def config4():
    """benchmarks/run_all.py config 4: `_sparse_cfg(False, 2)`."""
    return dataclasses.replace(config3(), batch_size=BATCH4,
                               remat_mode="stage_dots", learning_rate=0.001)


def event_blob(cfg, batch, mean_voxels: int = int(N_VOXELS * 1.5)):
    """bench.py's and run_all.py's events (`_event_blob(cfg, batch,
    150000)`): generator dedupe eats ~35%, so the target is 1.5x."""
    from uresnet_pytorch_tpu_torch.iotools.synthetic import generate_event
    dim = cfg.data_dim
    blob = {"coords": np.zeros((batch, cfg.max_voxels, dim), np.int32),
            "values": np.zeros((batch, cfg.max_voxels), np.float32),
            "label": np.zeros((batch, cfg.max_voxels), np.int32),
            "n_voxels": np.zeros((batch,), np.int32)}
    for b in range(batch):
        c, v, l = generate_event(SEED, b, cfg.spatial_size, dim,
                                 mean_voxels=mean_voxels)
        n = min(len(c), cfg.max_voxels)
        blob["coords"][b, :n], blob["values"][b, :n] = c[:n], v[:n]
        blob["label"][b, :n], blob["n_voxels"][b] = l[:n], n
    return blob


def events(cfg, device):
    blob = event_blob(cfg, BATCH)
    return tuple(torch.from_numpy(blob[k]).to(device)
                 for k in ("coords", "values", "n_voxels"))


def bound(flops: float, nbytes: float):
    """(least ms on an H100 SXM for this work, what bounds it)."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def live_rows(level) -> int:
    return int(level.halo.blive.sum())


@contextlib.contextmanager
def plain_versions():
    """The model with each kernel's plain torch version in the kernel
    wrapper's place, on the same device: the reference the kernel path is
    held against. The wrappers themselves never fall back."""
    from uresnet_pytorch_tpu_torch.ops import tile_conv
    from uresnet_pytorch_tpu_torch.ops.cuda import halo_conv as hc_mod
    from uresnet_pytorch_tpu_torch.ops.cuda import halo_extend as he_mod
    from uresnet_pytorch_tpu_torch.ops.cuda.halo_conv_dw import (
        halo_conv_dw_plain)
    from uresnet_pytorch_tpu_torch.ops.cuda.windowed_gather import (
        link_assemble_plain, link_parent_plain)
    from uresnet_pytorch_tpu_torch.ops.halo import (halo26_extend,
                                                    halo26_transpose)
    from uresnet_pytorch_tpu_torch.ops.cuda import norm_act as na_mod
    with mock.patch.object(tile_conv, "halo_conv", hc_mod.halo_conv_plain), \
            mock.patch.object(na_mod, "_forward", na_mod._forward_plain), \
            mock.patch.object(na_mod, "_backward", na_mod._backward_plain), \
            mock.patch.object(tile_conv, "link_assemble",
                              link_assemble_plain), \
            mock.patch.object(tile_conv, "link_parent", link_parent_plain), \
            mock.patch.object(hc_mod, "halo_conv", hc_mod.halo_conv_plain), \
            mock.patch.object(hc_mod, "halo_conv_dw", halo_conv_dw_plain), \
            mock.patch.object(he_mod, "halo26_fwd", halo26_extend), \
            mock.patch.object(he_mod, "halo26_bwd", halo26_transpose):
        yield


def fused(on: bool):
    """The tile conv path: kernel B (True) or the unfused halo extend +
    VALID conv (False), as `ops.tile_conv.USE_FUSED` selects it."""
    from uresnet_pytorch_tpu_torch.ops import tile_conv
    return mock.patch.object(tile_conv, "USE_FUSED", on)


def time_ms(fn, iters: int = 5) -> float:
    """Mean time of fn over `iters` runs after one warm-up, CUDA events
    around calls made from Python: for a kernel shorter than its wrapper's
    host work the window measures the host (PERF.md section 7), so short
    kernels are timed with `device_ms`."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, launches: int = 50, reps: int = 5) -> float:
    """Median device time of one call of fn with no host work in the
    window: `launches` calls are captured in one CUDA graph (each wrapper
    launches on the current stream, so its ctypes launch is captured too)
    and each of `reps` replays is timed with CUDA events. fn must not
    synchronise; its inputs stay where the last call left them in L2."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    del graph
    return float(np.median(times))


@contextlib.contextmanager
def link_ranges():
    """Profiler ranges "link_assemble" and "link_parent" around the tile
    conv's two link ops (forward, backward and recompute alike), so that a
    profile can sum the device time of the kernels each launches."""
    from uresnet_pytorch_tpu_torch.ops import tile_conv

    def ranged(name, fn):
        def run(*args, **kw):
            with torch.profiler.record_function(name):
                return fn(*args, **kw)
        return run
    with mock.patch.object(tile_conv, "_assemble_impl",
                           ranged("link_assemble", tile_conv._assemble_impl)), \
            mock.patch.object(tile_conv, "_parent_corner_impl",
                              ranged("link_parent",
                                     tile_conv._parent_corner_impl)):
        yield


def halo_bytes(halo) -> int:
    return sum(v.numel() * v.element_size()
               for v in (halo.idx, halo.ok, halo.blive))


def unfused_ms(halo, t, x, w, g=None, wrt=None) -> float:
    """The same conv on the unfused path, which the card ran before kernels
    B and C took its widths: kernel D and one cuDNN VALID conv
    (`_valid_conv`), or, given g, the backward of that toward x (cuDNN's
    dgrad, then kernel E) or toward w (cuDNN's wgrad), timed alone."""
    from uresnet_pytorch_tpu_torch.ops.cuda.halo_extend import (
        halo26_extend_op)
    from uresnet_pytorch_tpu_torch.ops.tile_conv import _valid_conv

    def conv(xx, ww):
        return _valid_conv(halo26_extend_op(xx, halo.idx, halo.ok, t, 3), ww,
                           t, 3)
    if g is None:
        with torch.no_grad():
            return time_ms(lambda: conv(x, w))
    xx = x.detach().requires_grad_(wrt == "x")
    ww = w.detach().requires_grad_(wrt == "w")
    out = conv(xx, ww)
    inp = xx if wrt == "x" else ww
    return time_ms(lambda: torch.autograd.grad(out, inp, g,
                                               retain_graph=True))


def check_halo_conv(name, level, t, cin, cout, rng, device,
                    unfused: bool = False):
    """Kernel B vs its plain version on one level's real halo maps, raw and
    with the epilogue. Returns (max_abs_err, kernel ms, plain ms, bound
    ms, bound by) of the epilogue form, and with `unfused` the same conv's
    `unfused_ms`."""
    from uresnet_pytorch_tpu_torch.ops.cuda.halo_conv import (
        halo_conv, halo_conv_plain, kernel_plan)
    B, T = level.keys.shape
    cells = t ** 3
    cs, cw, ring, kg, _ = kernel_plan(t, 3, cin, cout)
    live = level.halo.blive[..., None, None].cpu().numpy()
    x = rng.standard_normal((B, T, cells, cin), dtype=np.float32) * live
    w = rng.standard_normal((27, cin, cout), dtype=np.float32) \
        * np.float32((2.0 / (27 * cin)) ** 0.5)
    a = rng.standard_normal(cout, dtype=np.float32) * 0.2 + 1.0
    b = rng.standard_normal(cout, dtype=np.float32) * 0.2
    x, w = (torch.from_numpy(v).to(device, torch.bfloat16) for v in (x, w))
    a, b = (torch.from_numpy(v).to(device) for v in (a, b))
    mask = level.occ & level.halo.blive[..., None]
    ep = dict(a=a, b=b, alpha=0.1, mask=mask)
    worst = 0.0
    for form, kw in (("raw", {}), ("bn_act", ep)):
        got = halo_conv(x, w, level.halo, t, 3, **kw).float()
        ref = halo_conv_plain(x, w, level.halo, t, 3, **kw).float()
        torch.cuda.synchronize()
        scale = max(float(ref.abs().max()), 1e-30)
        err = (got - ref).abs()
        ok = bool((err / scale <= HALO_ATOL
                   + HALO_RTOL * ref.abs() / scale).all())
        worst = max(worst, float(err.max()))
        print(f"halo_conv {name} {form}: x {tuple(x.shape)} -> "
              f"{tuple(got.shape)}, max|err| {float(err.max()):.3e}, "
              f"max|ref| {scale:.3e}, within bf16 bound: {ok}")
        require(ok, f"halo_conv {name} {form} disagrees with plain")
    ms = time_ms(lambda: halo_conv(x, w, level.halo, t, 3, **ep))
    raw_ms = time_ms(lambda: halo_conv(x, w, level.halo, t, 3))
    plain_ms = time_ms(lambda: halo_conv_plain(x, w, level.halo, t, 3, **ep),
                       iters=2)
    n_live = live_rows(level)
    # live rows of x, weights, maps, affine and mask read; every row written
    nbytes = (n_live * cells * cin * 2 + w.numel() * 2 + halo_bytes(level.halo)
              + 8 * cout + mask.numel() + B * T * cells * cout * 2)
    bound_ms, by = bound(2 * 27 * cin * cout * n_live * cells, nbytes)
    slices = -(-cout // cs)
    path = f"wide, a ring of {ring} x {kg} offsets" if ring else "resident"
    print(f"halo_conv {name}: kernel bn_act {ms:.3f} ms, raw {raw_ms:.3f} "
          f"ms, plain bn_act {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
          f"({by}); {path}: {slices} Cout slice(s) of {cs}, chunks of {cw} "
          f"channels")
    if not unfused:
        return worst, ms, plain_ms, bound_ms, by
    u_ms = unfused_ms(level.halo, t, x, w)
    print(f"halo_conv {name}: unfused (D + cuDNN VALID conv) {u_ms:.3f} ms")
    return worst, ms, plain_ms, bound_ms, by, u_ms


def check_gather(name, spec, src_rows, feat, rng, device):
    """Kernel A's single-spec gather (one octant) vs its plain version on
    one real link spec: bitwise. Times both, and torch.gather of the same
    rows (the mask left out) as the library call, on the device-only
    timer. Returns (max_abs_err, kernel ms, plain ms, bound ms, bound by,
    library ms)."""
    from uresnet_pytorch_tpu_torch.ops.cuda.windowed_gather import (
        windowed_gather, windowed_gather_plain)
    B, N = spec.idx.shape
    src = torch.from_numpy(rng.standard_normal(
        (B, src_rows, feat), dtype=np.float32)).to(device, torch.bfloat16)
    got = windowed_gather(src, spec.idx, spec.ok)
    ref = windowed_gather_plain(src, spec.idx, spec.ok)
    torch.cuda.synchronize()
    same = torch.equal(got, ref)
    err = float((got.float() - ref.float()).abs().max())
    served = int(spec.ok.sum())
    print(f"windowed_gather {name}: src {tuple(src.shape)} -> "
          f"{tuple(got.shape)}, rows served {served}, equal: {same}")
    require(same, f"windowed_gather {name} is not equal to plain")
    ms = device_ms(lambda: windowed_gather(src, spec.idx, spec.ok))
    plain_ms = time_ms(lambda: windowed_gather_plain(src, spec.idx, spec.ok))
    rows = torch.where(spec.ok, spec.idx, 0).long()[..., None].expand(
        B, N, feat)
    library_ms = device_ms(lambda: torch.gather(src, 1, rows))
    row_bytes = feat * src.element_size()
    bound_ms, by = bound(0, spec.idx.numel() * 4 + spec.ok.numel()
                         + served * row_bytes + B * N * row_bytes)
    print(f"windowed_gather {name}: kernel {ms:.4f} ms, plain {plain_ms:.3f}"
          f" ms, torch.gather {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({by})")
    return err, ms, plain_ms, bound_ms, by, library_ms


def check_link(name, link, op, t_c, dim, C, rng, device,
               dtype=torch.bfloat16):
    """One link direction of kernel A (`link_assemble` or `link_parent`)
    against its plain version (the per-octant loops) on a real link, with
    torch.equal (the plain parent's sum turns -0.0 into +0.0). Times both,
    and torch.gather of the same rows (the mask left out; from the corner
    view for the parent side) as the library call, on the device-only
    timer. Returns (max_abs_err, kernel ms, plain ms, bound ms, bound by,
    library ms)."""
    from uresnet_pytorch_tpu_torch.ops.cuda.windowed_gather import (
        corner_view, link_assemble, link_assemble_plain, link_parent,
        link_parent_plain)
    B, noct, Tc = link.cidx.shape
    Tf = link.idx2.shape[1]
    th = t_c // 2
    if op == "assemble":
        kern, plain = link_assemble, link_assemble_plain
        x = rng.standard_normal((B, Tf, th ** dim, C), dtype=np.float32)
        idx, ok = link.cidx.transpose(1, 2), link.cok.transpose(1, 2)
    else:
        kern, plain = link_parent, link_parent_plain
        x = rng.standard_normal((B, Tc, t_c ** dim, C), dtype=np.float32)
        idx, ok = link.idx2, link.pok
    x = torch.from_numpy(x).to(device, dtype)
    got, ref = kern(x, link, t_c, dim), plain(x, link, t_c, dim)
    torch.cuda.synchronize()
    same = got.shape == ref.shape and torch.equal(got, ref)
    err = float((got.float() - ref.float()).abs().max())
    served = int(ok.sum())
    print(f"link_{op} {name}: {tuple(x.shape)} -> {tuple(got.shape)} "
          f"{str(dtype)[6:]}, rows served {served}, equal to plain: {same}")
    require(same, f"link_{op} {name} is not equal to plain")
    ms = device_ms(lambda: kern(x, link, t_c, dim))
    plain_ms = time_ms(lambda: plain(x, link, t_c, dim), iters=2)
    src = x.reshape(B, Tf, -1) if op == "assemble" else \
        corner_view(x, t_c, dim)
    rows = torch.where(ok, idx, 0).reshape(B, -1).long()[..., None].expand(
        B, idx[0].numel(), src.shape[-1])
    library_ms = device_ms(lambda: torch.gather(src, 1, rows))
    row_bytes = src.shape[-1] * x.element_size()
    # the maps read once, each served source row read once, the output
    # written once
    bound_ms, by = bound(0, idx.numel() * 5 + served * row_bytes
                         + got.numel() * got.element_size())
    print(f"link_{op} {name}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
          f"torch.gather {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({by})")
    return err, ms, plain_ms, bound_ms, by, library_ms


def check_dw(name, level, t, cin, cout, rng, device, unfused: bool = False):
    """Kernel C vs its plain version on one level's real halo maps:
    max|err| <= DW_RTOL * max|ref|. Returns (max_abs_err, kernel ms, plain
    ms, bound ms, bound by), and with `unfused` the unfused path's d_W
    (cuDNN's wgrad) ms."""
    from uresnet_pytorch_tpu_torch.ops.cuda.halo_conv_dw import (
        dw_plan, halo_conv_dw, halo_conv_dw_plain)
    B, T = level.keys.shape
    cells = t ** 3
    plan = tuple(dw_plan(t, 3, cin, cout))
    live = level.halo.blive[..., None, None].cpu().numpy()
    x = rng.standard_normal((B, T, cells, cin), dtype=np.float32) * live
    g = rng.standard_normal((B, T, cells, cout), dtype=np.float32) * live
    x, g = (torch.from_numpy(v).to(device, torch.bfloat16) for v in (x, g))
    got = halo_conv_dw(x, g, level.halo, t, 3)
    ref = halo_conv_dw_plain(x, g, level.halo, t, 3)
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    ok = err <= DW_RTOL * scale
    print(f"halo_conv_dw {name}: x {tuple(x.shape)}, g {tuple(g.shape)} -> "
          f"{tuple(got.shape)}, max|err| {err:.3e}, max|ref| {scale:.3e}, "
          f"within {DW_RTOL:g} of max|ref|: {ok}")
    require(ok, f"halo_conv_dw {name} disagrees with plain")
    ms = time_ms(lambda: halo_conv_dw(x, g, level.halo, t, 3))
    plain_ms = time_ms(lambda: halo_conv_dw_plain(x, g, level.halo, t, 3),
                       iters=2)
    n_live = live_rows(level)
    nbytes = (n_live * cells * (cin + cout) * 2 + halo_bytes(level.halo)
              + got.numel() * 4)
    bound_ms, by = bound(2 * 27 * cin * cout * n_live * cells, nbytes)
    print(f"halo_conv_dw {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} "
          f"ms, bound {bound_ms:.4f} ms ({by}); plan (Cout slice, tiles a "
          f"chunk, warp groups, M tiles a warp) {plan}")
    if not unfused:
        return err, ms, plain_ms, bound_ms, by
    w = torch.zeros(27, cin, cout, dtype=torch.bfloat16, device=device)
    u_ms = unfused_ms(level.halo, t, x, w, g, wrt="w")
    print(f"halo_conv_dw {name}: unfused d_W (cuDNN wgrad) {u_ms:.3f} ms")
    return err, ms, plain_ms, bound_ms, by, u_ms


def check_dx(name, level, t, cin, cout, rng, device, unfused: bool = False):
    """Kernel B as the d_x of a conv cin -> cout: conv(g, flip_weights(w)),
    cout -> cin, against its plain version, to the bf16 bound. Returns
    (max_abs_err, kernel ms, plain ms, bound ms, bound by), and with
    `unfused` the unfused path's d_x (cuDNN's dgrad, then kernel E) ms."""
    from uresnet_pytorch_tpu_torch.ops.cuda.halo_conv import (
        flip_weights, halo_conv, halo_conv_plain, kernel_plan)
    B, T = level.keys.shape
    _, _, ring, kg, _ = kernel_plan(t, 3, cout, cin)
    live = level.halo.blive[..., None, None].cpu().numpy()
    g = rng.standard_normal((B, T, t ** 3, cout), dtype=np.float32) * live
    w = rng.standard_normal((27, cin, cout), dtype=np.float32) \
        * np.float32((2.0 / (27 * cout)) ** 0.5)
    g, w = (torch.from_numpy(v).to(device, torch.bfloat16) for v in (g, w))
    wf = flip_weights(w).contiguous()
    got = halo_conv(g, wf, level.halo, t, 3).float()
    ref = halo_conv_plain(g, wf, level.halo, t, 3).float()
    torch.cuda.synchronize()
    scale = max(float(ref.abs().max()), 1e-30)
    err = (got - ref).abs()
    ok = bool((err / scale <= HALO_ATOL + HALO_RTOL * ref.abs() / scale).all())
    print(f"halo_conv d_x {name}: g {tuple(g.shape)} on flipped weights, "
          f"max|err| {float(err.max()):.3e}, max|ref| {scale:.3e}, within "
          f"bf16 bound: {ok}")
    require(ok, f"halo_conv d_x {name} disagrees with plain")
    ms = time_ms(lambda: halo_conv(g, wf, level.halo, t, 3))
    plain_ms = time_ms(lambda: halo_conv_plain(g, wf, level.halo, t, 3),
                       iters=2)
    n_live = live_rows(level)
    nbytes = (n_live * t ** 3 * cout * 2 + wf.numel() * 2
              + halo_bytes(level.halo) + B * T * t ** 3 * cin * 2)
    bound_ms, by = bound(2 * 27 * cin * cout * n_live * t ** 3, nbytes)
    print(f"halo_conv d_x {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} "
          f"ms, bound {bound_ms:.4f} ms ({by}); "
          + (f"wide, a ring of {ring} x {kg} offsets" if ring
             else "resident"))
    if not unfused:
        return float(err.max()), ms, plain_ms, bound_ms, by
    x = torch.zeros(B, T, t ** 3, cin, dtype=torch.bfloat16, device=device)
    u_ms = unfused_ms(level.halo, t, x, w, g, wrt="x")
    print(f"halo_conv d_x {name}: unfused d_x (cuDNN dgrad + E) {u_ms:.3f} "
          f"ms")
    return float(err.max()), ms, plain_ms, bound_ms, by, u_ms


def row_map(halo, t, device):
    """(B*T*(t+2)^3,) int64: for each extended cell, its source row in x
    viewed as (B*T*t^3, C) with one zero row appended (index B*T*t^3):
    the extend as one `index_select`, and its transpose as one
    `index_add_`. Built from ops/halo.py's geometry, for the yardsticks
    only."""
    from uresnet_pytorch_tpu_torch.ops.halo import (body_cells, halo_offsets,
                                                    slab_cells)
    B, _, T = halo.idx.shape
    cells = t ** 3
    zero_row = B * T * cells
    first = (torch.arange(B, device=device)[:, None] * T
             + torch.arange(T, device=device)[None]) * cells      # (B, T)
    rows = torch.full((B, T, (t + 2) ** 3), zero_row, dtype=torch.long,
                      device=device)
    rows[:, :, torch.as_tensor(body_cells(t, 3), device=device)] = \
        first[..., None] + torch.arange(cells, device=device)
    ev = torch.arange(B, device=device)[:, None] * T * cells
    for k, off in enumerate(halo_offsets(3)):
        ec, sc = (torch.as_tensor(v, device=device)
                  for v in slab_cells(off, t))
        src = (ev + halo.idx[:, k].long() * cells)[..., None] + sc
        rows[:, :, ec] = torch.where(halo.ok[:, k, :, None], src, zero_row)
    return rows.flatten()


def extend_bytes(kernel: str, a, halo, t: int, dim: int, h: int = 1) -> int:
    """The bytes kernel D ("d", on x) or E ("e", on g) must move at halo
    width h: D reads every row of x and writes every extended row; E reads
    the extended cells that have a source (the body cells, and the slab
    cells of the neighbors that exist) and writes every row of d_x; both
    read the maps."""
    from uresnet_pytorch_tpu_torch.ops.halo import halo_offsets
    B, T, _, C = a.shape
    cells, ecells = t ** dim, (t + 2 * h) ** dim
    if kernel == "d":
        values = B * T * (cells + ecells) * C
    else:
        slab = torch.tensor([t ** sum(d == 0 for d in off)
                             * h ** sum(d != 0 for d in off)
                             for off in halo_offsets(dim)],
                            device=halo.ok.device)
        has = B * T * cells + int((halo.ok.sum((0, 2)) * slab).sum())
        values = (has + B * T * cells) * C
    return values * a.element_size() + halo.idx.numel() * 4 \
        + halo.ok.numel()


def same_bits(a, b) -> bool:
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    return a.dtype == b.dtype and torch.equal(a.view(ints[a.dtype]),
                                              b.view(ints[b.dtype]))


def check_extend(name, halo, t, c, dtype, gen, device, dim: int = 3,
                 timed: bool = True, h: int = 1):
    """Kernels D and E at halo width h against their plain versions on
    one level's real halo maps, bitwise, on random rows everywhere (dead
    rows included). Times each kernel on the device-only timer beside its
    bound; with `timed` (h = 1), also the plain version (CUDA events, one
    call) and the one-call yardstick on the same timer (3D only). Returns
    {d|e: (max_abs_err, kernel ms, plain ms, bound ms, bound by, library
    ms)}, None for what was not timed."""
    from uresnet_pytorch_tpu_torch.ops.cuda.halo_extend import (halo26_bwd,
                                                                halo26_fwd)
    from uresnet_pytorch_tpu_torch.ops.halo import (halo26_extend,
                                                    halo26_transpose)
    B, _, T = halo.idx.shape
    cells, ecells = t ** dim, (t + 2 * h) ** dim
    x = torch.randn(B, T, cells, c, generator=gen, device=device).to(dtype)
    g = torch.randn(B, T, ecells, c, generator=gen, device=device).to(dtype)
    # zeros of both signs (a missing neighbor's +0.0 turns a -0.0 body
    # +0.0) and subnormals (kernel E adds bf16 natively)
    for a in (x, g):
        a[a.abs() < 0.1] = -0.0
        a[a.abs() > 2] *= 1e-39
    out = {}
    for key, kern, plain, a in (("d", halo26_fwd, halo26_extend, x),
                                ("e", halo26_bwd, halo26_transpose, g)):
        got, ref = kern(a, halo, t, dim, h), plain(a, halo, t, dim, h)
        torch.cuda.synchronize()
        same = same_bits(got, ref)
        err = float((got.float() - ref.float()).abs().max())
        print(f"{kern.__name__} {name}: {tuple(a.shape)} -> "
              f"{tuple(got.shape)} {str(dtype)[6:]}, bitwise equal to plain: "
              f"{same}")
        require(same, f"{kern.__name__} {name} is not bitwise equal to plain")
        ms = device_ms(lambda: kern(a, halo, t, dim, h),
                       launches=graph_launches(got))
        bound_ms, by = bound(0, extend_bytes(key, a, halo, t, dim, h))
        plain_ms = library_ms = None
        if timed:
            plain_ms = time_ms(lambda: plain(a, halo, t, dim), iters=1)
            rows = row_map(halo, t, device)
            xpad = torch.cat([x.reshape(-1, c), x.new_zeros(1, c)])
            if key == "d":
                lib = torch.index_select(xpad, 0, rows).view(got.shape)
                require(torch.equal(lib, got), f"the index_select yardstick "
                        f"at {name} is not the extend")
                lib_fn = lambda: torch.index_select(xpad, 0, rows)  # noqa
            else:
                # over the cells that have a source: the others carry zeros
                # into the appended row, and ~1e8 atomic adds to that one
                # row would time contention, not the transpose
                has = (rows != xpad.shape[0] - 1).nonzero().squeeze(1)
                acc = torch.zeros_like(xpad)
                rows_e, g_e = rows[has], g.reshape(-1, c)[has]
                lib_fn = lambda: acc.index_add_(0, rows_e, g_e)  # noqa
            library_ms = device_ms(lib_fn, launches=4, reps=3)
            del rows, xpad
        print(f"{kern.__name__} {name}: kernel {ms:.4f} ms (device-only), "
              f"bound {bound_ms:.4f} ms ({by}), {bound_ms / ms:.0%} of it"
              + (f"; plain {plain_ms:.3f} ms, "
                 f"{'index_select' if key == 'd' else 'index_add_'} "
                 f"{library_ms:.4f} ms" if timed else ""))
        out[key] = (err, ms, plain_ms, bound_ms, by, library_ms)
    return out


def graph_launches(out) -> int:
    """Launches in one `device_ms` graph of a kernel with this output: up
    to 50, fewer where the graph's outputs would pass 4 GB."""
    nbytes = out.numel() * out.element_size()
    return int(min(50, max(4, 4e9 // max(nbytes, 1))))


@contextlib.contextmanager
def record_extend(shapes: dict, path: str):
    """Counts kernel D's and E's launches in `shapes` by path, kernel and
    input shape while the block runs, keeping the first launch's maps; the
    wrappers (and their counters) still run."""
    from uresnet_pytorch_tpu_torch.ops.cuda import halo_extend as he
    wrapped = {"D": he.halo26_fwd, "E": he.halo26_bwd}

    def wrap(kernel):
        def run(a, spec, t, dim, h=1):
            B, T, _, C = a.shape
            key = (f"{path} {kernel} B={B} T={T} t={t} C={C} "
                   f"{str(a.dtype)[6:]}")
            rec = shapes.setdefault(key, {
                "path": path, "kernel": kernel, "shape": tuple(a.shape),
                "dtype": a.dtype, "t": t, "dim": dim, "launches": 0,
                "spec": (spec.idx, spec.ok)})
            rec["launches"] += 1
            return wrapped[kernel](a, spec, t, dim, h)
        return run
    with mock.patch.multiple(he, halo26_fwd=wrap("D"), halo26_bwd=wrap("E")):
        yield


def time_recorded(shapes: dict, device, seed: int = SEED) -> dict:
    """Each recorded D or E shape timed on its own maps on the device-only
    timer (random inputs from `seed`), beside its launches and bound."""
    from uresnet_pytorch_tpu_torch.ops.cuda import halo_extend as he
    from uresnet_pytorch_tpu_torch.ops.halo import Halo26Spec
    gen = torch.Generator(device=device)
    res = {}
    for i, (key, rec) in enumerate(shapes.items()):
        gen.manual_seed(seed + i)
        a = torch.randn(rec["shape"], generator=gen, device=device).to(
            rec["dtype"])
        spec = Halo26Spec(*rec["spec"], None, None)
        t, dim = rec["t"], rec["dim"]
        fn = he.halo26_fwd if rec["kernel"] == "D" else he.halo26_bwd
        launches = graph_launches(fn(a, spec, t, dim))
        res[key] = {
            "path": rec["path"], "kernel": rec["kernel"],
            "launches": rec["launches"],
            "ms": device_ms(lambda: fn(a, spec, t, dim), launches=launches),
            "bound_ms": bound(0, extend_bytes(rec["kernel"].lower(), a, spec,
                                              t, dim))[0]}
        del a
    return res


def extend_per_run(shapes: dict, device, what: str, by_shape: dict) -> dict:
    """Times kernels D and E at the shapes `record_extend` saw in one run,
    checks their launches against the wrappers' launches_by_shape counts
    of that run (`by_shape`: kernel -> Counter), and prints each kernel's
    ms x launches in it. Returns {D|E: (ms x launches, bound ms x
    launches)}."""
    timed = time_recorded(shapes, device)
    sums = {}
    for kernel in ("D", "E"):
        got = {}
        for rec in shapes.values():
            if rec["kernel"] == kernel:
                k = (rec["t"], rec["dim"], rec["shape"][-1], rec["dtype"])
                got[k] = got.get(k, 0) + rec["launches"]
        require(got == dict(by_shape[kernel]), f"{what}: kernel {kernel}'s "
                f"recorded launches {got} are not its launches_by_shape "
                f"{dict(by_shape[kernel])}")
        rows = [r for r in timed.values() if r["kernel"] == kernel]
        sums[kernel] = (sum(r["ms"] * r["launches"] for r in rows),
                        sum(r["bound_ms"] * r["launches"] for r in rows))
    print(f"{what}: kernel D {sums['D'][0]:.3f} ms x launches (bound "
          f"{sums['D'][1]:.3f}), kernel E {sums['E'][0]:.3f} (bound "
          f"{sums['E'][1]:.3f}), device-only, by shape: " + "; ".join(
              f"{k.split(' ', 1)[1]} {r['launches']} x {r['ms']:.4f}"
              for k, r in timed.items()))
    return sums


def compare_logits(got, ref, valid, what: str) -> None:
    """Phase 2's bound: p99 rel < 5e-2, p99.9 < 0.15, argmax agreement >
    0.995 over the valid voxels (tests/test_tpu_gated.py:134-146)."""
    got, ref = got[valid], ref[valid]
    rel = ((got - ref).abs() / ref.abs().clamp(min=1.0)).flatten()
    q99 = float(torch.quantile(rel, 0.99))
    q999 = float(torch.quantile(rel, 0.999))
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    print(f"{what} over {int(valid.sum())} voxels: p99 rel {q99:.3e}, p99.9 "
          f"rel {q999:.3e}, max abs {float((got - ref).abs().max()):.3e}, "
          f"argmax agreement {agree:.5f}")
    require(q99 < 5e-2 and q999 < 0.15 and agree > 0.995,
            f"{what}: logits disagree")


def compare_step(cfg, variables, blob, counts, what: str) -> None:
    """Phase 4's bounds: one train step on the kernels (whatever path the
    tile conv takes) against one on the plain versions from the same
    variables: loss within 1e-2, the whole gradient at cosine >= 0.99 and
    |delta|/|ref| <= 5e-2, each leaf within the bf16 noise, the running
    moments within 1e-2; the plain step launches no kernel."""
    from uresnet_pytorch_tpu_torch.trainval import TrainVal

    def fresh(c):
        tv = TrainVal(c)
        tv.initialize(variables)
        return tv

    loss_k, grads_k, stats_k = grads_and_stats(fresh(cfg), blob)
    before = counts()
    with plain_versions():
        loss_p, grads_p, stats_p = grads_and_stats(fresh(cfg), blob)
        # the same step in f32 (plain only: the kernels take bf16), to
        # measure how far bf16 rounding alone moves each gradient
        _, grads_f, _ = grads_and_stats(
            fresh(dataclasses.replace(cfg, compute_dtype="float32")), blob)
    torch.cuda.synchronize()
    require(counts() == before, "the plain-path step launched a kernel")
    rel_loss = abs(loss_k - loss_p) / abs(loss_p)
    print(f"{what} train step: loss {loss_k:.6f} vs {loss_p:.6f} "
          f"(rel {rel_loss:.3e})")
    require(rel_loss <= 1e-2, f"{what}: losses disagree")
    names = sorted(grads_p)
    flat = [torch.cat([g[n].flatten() for n in names])
            for g in (grads_k, grads_p, grads_f)]
    g_cos, g_rel = cos_rel(flat[0], flat[1])
    print(f"whole gradient ({flat[0].numel()} values), {what}: "
          f"cosine {g_cos:.6f}, |delta|/|ref| {g_rel:.3e}; cosine to the "
          f"f32 step: plain bf16 {cos_rel(flat[1], flat[2])[0]:.6f}, "
          f"kernel {cos_rel(flat[0], flat[2])[0]:.6f}")
    require(g_cos >= 0.99 and g_rel <= 5e-2,
            f"{what}: the gradient disagrees")
    # per leaf: the kernel path (bf16, f32 sums in the kernels' order) may
    # sit as far from the plain bf16 path as bf16 rounding moves that
    # leaf, measured as the plain bf16 path's distance to the f32 step
    # (PERF.md: deep BN leaves reach cosine 0.74 there)
    worst, noisiest = [], []
    for n in names:
        k_cos, k_rel = cos_rel(grads_k[n], grads_p[n])
        f_cos, f_rel = cos_rel(grads_p[n], grads_f[n])
        worst.append((k_rel - 1.5 * f_rel, n, k_cos, k_rel, f_cos, f_rel))
        noisiest.append((f_cos, n, k_cos, cos_rel(grads_k[n], grads_f[n])[0]))
        require(k_rel <= 1.5 * f_rel + 0.05,
                f"gradient of {n}: kernel vs plain |delta|/|ref| {k_rel:.3e}"
                f" beyond the bf16 noise (plain bf16 vs f32 {f_rel:.3e})")
    worst.sort(reverse=True)
    for _, n, k_cos, k_rel, f_cos, f_rel in worst[:3]:
        print(f"  closest to the bound: {n}: kernel vs plain cosine "
              f"{k_cos:.5f}, |delta|/|ref| {k_rel:.3e}; plain bf16 vs f32 "
              f"cosine {f_cos:.5f}, |delta|/|ref| {f_rel:.3e}")
    for f_cos, n, k_cos, kf_cos in sorted(noisiest)[:4]:
        print(f"  most moved by bf16: {n}: cosine plain bf16 vs f32 "
              f"{f_cos:.5f}, kernel vs f32 {kf_cos:.5f}, kernel vs plain "
              f"bf16 {k_cos:.5f}")
    worst_stat = 0.0
    for n, sp in stats_p.items():
        d = float(((stats_k[n] - sp).abs() / sp.abs().clamp(min=1.0)).max())
        require(d <= 1e-2, f"batch stat {n} differs by {d:.3e}")
        worst_stat = max(worst_stat, d)
    print(f"{len(names)} gradients within the bf16 noise; {len(stats_p)} "
          f"running moments, worst rel {worst_stat:.3e}")


def cos_rel(a, b):
    """(cosine, |a - b| / |b|) of two gradients."""
    a, b = a.flatten().double(), b.flatten().double()
    return (float(a @ b / (a.norm() * b.norm()).clamp(min=1e-30)),
            float((a - b).norm() / b.norm().clamp(min=1e-30)))


def grads_and_stats(tv, blob):
    """One train forward and backward from tv's current state: (loss,
    {name: grad}, {name: new running moment}); no optimizer step."""
    from uresnet_pytorch_tpu_torch.models.norm import commit_batch_moments
    tv.optimizer.zero_grad(set_to_none=True)
    metrics = tv._metrics(tv._batch(blob), train=True)
    metrics["loss"].backward()
    commit_batch_moments(tv.model)
    grads = {n: p.grad.float().clone() for n, p in tv.model.named_parameters()}
    stats = {n: b.clone() for n, b in tv.model.named_buffers()}
    return float(metrics["loss"].detach()), grads, stats


def timed_call(fn):
    """(fn(), its ms on CUDA events), synchronized after."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def timed_steps(tv, blob, warm: int, timed: int):
    """Losses of warm + timed train steps and the device ms of each timed
    one (CUDA events around the whole step, graph build included)."""
    losses, times = [], []
    for i in range(warm + timed):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = tv.train_step(blob)
        end.record()
        torch.cuda.synchronize()
        losses.append(float(metrics["loss"]))
        if i >= warm:
            times.append(start.elapsed_time(end))
    return losses, times, metrics


# phase 8: the configurations whose widths or tile size kernels B and C's
# plans once refused, at config 3's and 4's full size:
# uresnet_filters=12 (widths 12-60, Cout no multiple of 8),
# width_ramp="geometric" (16-256: 256 -> 256 at L4), uresnet_filters=32
# (32-160: 160 -> 160) and tile_size=8 with tile_sizes=None (t=8 at every
# level: the decoder's 96 -> 48 and 128 -> 64 concat convs in eval). Every
# bf16 conv takes kernels B and C, as config 3's and 4's: 37 B a forward,
# 81 B and 41 C a stage_dots step, no D or E. name -> (overrides, kernel
# A's launches in a forward and in a step): once a link op, at links 1-3
# (link 0 is the identity of the 4 -> 2 tile halving): 9 and 21 (6
# recomputed, 6 backward); at t=8 all four links are real: 12 and 28.
# tests/test_torch_widths.py holds the same configurations to the
# reference on the CPU.
WIDTH_CASES = {
    "filters12": ({"uresnet_filters": 12}, 9, 21),
    "geometric": ({"width_ramp": "geometric"}, 9, 21),
    "filters32": ({"uresnet_filters": 32}, 9, 21),
    "tile8": ({"tile_size": 8, "tile_sizes": None}, 12, 28),
}
FORWARD_LAUNCHES = {"halo_conv": 37, "halo_conv_dw": 0, "halo26_fwd": 0,
                    "halo26_bwd": 0}


@contextlib.contextmanager
def record_rule(calls: list):
    """Appends (Cin, Cout) for every conv the tile conv's shape rule
    decides while the block runs, and raises if it sends a bfloat16 conv
    on the card to the unfused path: every such conv has a plan."""
    from uresnet_pytorch_tpu_torch.ops import tile_conv
    rule = tile_conv._fused

    def record(x, t, dim, Cout, dx=False, dw=False):
        fused = rule(x, t, dim, Cout, dx, dw)
        calls.append((x.shape[-1], Cout))
        require(fused or x.dtype != torch.bfloat16,
                f"the rule sent the bf16 conv {x.shape[-1]} -> {Cout} at "
                f"t={t} (d_x {dx}, d_W {dw}) to the unfused path")
        return fused
    with mock.patch.object(tile_conv, "_fused", record):
        yield


def width_run(name, device, counts, reset_counts, require_a):
    """Phase 8 for WIDTH_CASES[name]: a forward at config 3's size (batch
    2) and a stage_dots step at config 4's (batch 1), each held to the
    plain path at phase 2's and phase 4's bounds, with the exact launches
    of kernels A-E, every conv on the fused path (`record_rule`), three
    timed forwards and steps, and the peak memory of each. Returns {path:
    launches}."""
    from uresnet_pytorch_tpu_torch.models import construct
    from uresnet_pytorch_tpu_torch.ops.tile_graph import tile_size_at
    from uresnet_pytorch_tpu_torch.trainval import TrainVal
    from uresnet_pytorch_tpu_torch.utils.weights import (init_params,
                                                         load_jax_variables)
    kw, a_fwd, a_step = WIDTH_CASES[name]
    cfg = dataclasses.replace(config3(), **kw)
    blob = event_blob(cfg, 2)
    coords, values, nv = (torch.from_numpy(blob[k]).to(device)
                          for k in ("coords", "values", "n_voxels"))
    model = construct("uresnet_sparse")(cfg)
    load_jax_variables(model, init_params(
        cfg, torch.Generator().manual_seed(SEED)))
    print(f"{name}: widths {cfg.n_planes}, tile sizes "
          f"{[tile_size_at(cfg, l) for l in range(len(cfg.n_planes))]}, "
          f"voxels/event {nv.tolist()}")
    rule = []
    with torch.no_grad():
        reset_counts()
        with record_rule(rule):
            logits, diag = model(coords, values, nv)
        torch.cuda.synchronize()
        fwd = counts()
        torch.cuda.reset_peak_memory_stats()
        times = [timed_call(lambda: model(coords, values, nv))[1]
                 for _ in range(3)]
        peak_fwd = torch.cuda.max_memory_allocated()
        require(counts() == {k: 4 * v for k, v in fwd.items()},
                f"{name}: the timed forwards launched {counts()}, not 3 x "
                f"{fwd}")
        before = counts()
        with plain_versions():
            ref, _ = model(coords, values, nv)
        torch.cuda.synchronize()
        require(counts() == before, "the plain-path forward launched a "
                "kernel")
    print(f"{name}: launches in one forward (batch 2): {fwd}; {len(rule)} "
          f"convs, all fused")
    require(all(fwd[k] == n for k, n in FORWARD_LAUNCHES.items()),
            f"{name}: expected {FORWARD_LAUNCHES} in the forward")
    require_a(a_fwd, fwd, f"the {name} forward")
    valid = torch.arange(cfg.max_voxels, device=device)[None] < nv[:, None]
    require(int(diag["overflow"]) == 0 and bool(torch.isfinite(logits).all())
            and bool((logits[~valid] == 0).all()),
            f"{name} logits: overflow, non-finite or nonzero padding")
    compare_logits(logits, ref, valid, f"{name} kernel vs plain logits")
    ms_fwd = sorted(times)[1]
    print(f"{name} forward (batch 2), 3 runs: "
          f"{', '.join(f'{t:.1f}' for t in times)} ms; median {ms_fwd:.1f} "
          f"ms; peak memory {peak_fwd / 2**30:.2f} GiB")
    del model, logits, ref, coords, values, nv, valid
    torch.cuda.empty_cache()

    cfg4 = dataclasses.replace(config4(), batch_size=1, **kw)
    variables = init_params(cfg4, torch.Generator().manual_seed(cfg4.seed))
    blob1 = event_blob(cfg4, 1)
    reset_counts()
    rule = []
    with record_rule(rule):   # the kernel step's decisions
        compare_step(cfg4, variables, blob1, counts,
                     f"{name} kernel vs plain")
    step = counts()
    print(f"{name}: launches in one stage_dots step (batch 1): {step}")
    require(all(step[k] == n for k, n in STEP_LAUNCHES.items()
                if k != "windowed_gather"),
            f"{name}: expected B, C, D, E launches as {STEP_LAUNCHES} in "
            "the step")
    require_a(a_step, step, f"the {name} step")
    tv = TrainVal(cfg4)
    tv.initialize(variables)
    timed_steps(tv, blob1, 1, 0)
    torch.cuda.reset_peak_memory_stats()
    losses, times, metrics = timed_steps(tv, blob1, 0, 3)
    peak_step = torch.cuda.max_memory_allocated()
    require(all(np.isfinite(losses)) and int(metrics["overflow"]) == 0,
            f"{name}: a non-finite loss or a graph overflow in training")
    step_ms = sorted(times)[1]
    print(f"{name}: train step (batch 1), 3 runs after 1: "
          f"{', '.join(f'{t:.1f}' for t in times)} ms; median {step_ms:.1f} "
          f"ms; peak memory {peak_step / 2**30:.2f} GiB")
    del tv
    return {f"{name}_forward": fwd, f"{name}_training_step": step}


# kernel A's device function, and that of the one-warp-per-row kernel A
# that earlier trees launch, for profiles taken against them
KERNEL_A_NAMES = ("link_gather_kernel", "gather_rows_kernel")


def profile_run(fn, what: str, top: int = 12) -> dict:
    """torch.profiler over one call of fn: device time by kernel, summed
    by kind, and the device's busy share of the call's wall time. Only
    device-side kernel rows count: an operator's row repeats its kernels'
    time, and a user annotation's device row (`Optimizer.step#Adam.step`)
    spans its kernels and the gaps between them. The link movement is the
    device time of kernel A and of the torch passes that the link ops
    (`link_ranges`) run around it. Returns the wall and busy ms, ms by
    kind, the link ranges' (torch passes' device ms, calls) and the link
    movement's ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with link_ranges(), profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation
                   and e.self_device_time_total > 0), reverse=True)
    kinds = {"kernel B": 0.0, "kernel C": 0.0, "kernel A": 0.0,
             "kernel D": 0.0, "kernel E": 0.0, "cuDNN convs": 0.0,
             "GEMMs": 0.0, "other torch kernels": 0.0}
    for ms, _, key in rows:
        low = key.lower()
        kind = ("kernel C" if "halo_conv_dw_kernel" in key else
                "kernel B" if "halo_conv_kernel" in key else
                "kernel A" if any(n in key for n in KERNEL_A_NAMES) else
                "kernel D" if "halo_extend_kernel" in key else
                "kernel E" if "halo_transpose_kernel" in key else
                "cuDNN convs" if any(w in low for w in
                                     ("fprop", "dgrad", "wgrad", "conv"))
                else "GEMMs" if any(w in low for w in
                                    ("gemm", "xmma", "cutlass")) else
                "other torch kernels")
        kinds[kind] += ms
    # the torch kernels each link range launched, from its host-side
    # event (a range's device-side row would also count the gaps); kernel
    # A's ctypes launches are not tied to the range, and it runs nowhere
    # else, so all of its time is added
    def launched(ev):
        yield from ev.kernels
        for child in ev.cpu_children:
            yield from launched(child)
    links = {}
    for ev in prof.events():
        if ev.name in ("link_assemble", "link_parent") \
                and ev.device_type == DeviceType.CPU:
            ms, n = links.get(ev.name, (0.0, 0))
            links[ev.name] = (ms + sum(
                k.duration for k in launched(ev)
                if not any(a in k.name for a in KERNEL_A_NAMES)) / 1e3, n + 1)
    busy = sum(kinds.values())
    torch_ms = sum(v[0] for v in links.values())
    link_ms = torch_ms + kinds["kernel A"]
    print(f"profiled {what}: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
          f"({busy / wall_ms:.1%}); by kind: "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in kinds.items()))
    print(f"  link movement {link_ms:.3f} ms: kernel A {kinds['kernel A']:.3f}"
          f" ms + torch passes in the link ops {torch_ms:.3f} ms ("
          + ", ".join(f"{k} {v[0]:.3f} ms in {v[1]} calls"
                      for k, v in sorted(links.items())) + ")")
    for ms, n, key in rows[:top]:
        print(f"  {ms:9.3f} ms {n:6d} calls  {key[:100]}")
    return {"wall_ms": wall_ms, "busy_ms": busy, "kinds": kinds,
            "links": links, "link_torch_ms": torch_ms, "link_ms": link_ms}


TRAIN_LOG_COLUMNS = ["iter", "epoch", "loss", "accuracy", "titer", "tio",
                     "tforward", "tbackward", "tsave", "lr", "overflow",
                     "tile_spill"]


def cli_argv(mode: str, workdir: str, batch: int, *extra: str) -> list:
    """A user's argv for config 3's model (config 4 with the train flags):
    `config3()` spelled as flags, on synthetic events."""
    c3 = config3()
    return [mode, "-io", "synthetic", "-ss", str(c3.spatial_size),
            "-uf", str(c3.uresnet_filters),
            "-uns", str(c3.uresnet_num_strides), "--reps", str(c3.reps),
            "--max-voxels", str(c3.max_voxels),
            "--capacity-factor", str(c3.capacity_factor),
            "--tile-sizes", ",".join(map(str, c3.tile_sizes)),
            "--compute-dtype", c3.compute_dtype, "-bs", str(batch),
            "-wp", os.path.join(workdir, "snap"),
            "-ld", os.path.join(workdir, "log"), *extra]


def require_model_of(cfg, ref, what: str) -> None:
    """The parsed configuration builds the same model and capacities as the
    phase's own (the CLI has no flag for `min_level_capacity`, whose floor
    binds at no level of config 3)."""
    same = (cfg.n_planes == ref.n_planes and cfg.tile_sizes == ref.tile_sizes
            and cfg.reps == ref.reps and cfg.compute_dtype == ref.compute_dtype
            and all(cfg.level_capacity(l) == ref.level_capacity(l)
                    and cfg.tile_occupancy_at(l) == ref.tile_occupancy_at(l)
                    for l in range(ref.uresnet_num_strides)))
    require(same, f"{what}: the CLI's flags do not give the phase's model")


def read_csv(path: str) -> list:
    with open(path) as f:
        return list(csv.DictReader(f))


def cli_phase(device, counts, reset_counts, require_a, fwd_rate: float,
              step_ms: float) -> dict:
    """Phase 9: train, restore, inference and iotest through the port's
    CLI. Returns each driven path's kernel launches."""
    from uresnet_pytorch_tpu_torch import main_funcs
    from uresnet_pytorch_tpu_torch.flags import parse_args
    from uresnet_pytorch_tpu_torch.iotools import io_factory
    from uresnet_pytorch_tpu_torch.trainval import TrainVal
    from uresnet_pytorch_tpu_torch.utils import native
    mean_voxels = int(N_VOXELS * 1.5)
    collate = (f"native ({native.library_path()})" if native.available()
               else "NumPy (the native library did not build)")
    print(f"host collate: {collate}")
    launches = {}
    with tempfile.TemporaryDirectory() as d:
        _, cfg_t = parse_args(cli_argv(
            "train", d, BATCH4, "--remat-mode", "stage_dots", "-lr", "1e-3",
            "-it", "3", "-chks", "1", "-rs", "1", "-nt", "2"))
        require_model_of(cfg_t, config4(), "train")
        require(cfg_t.remat_mode == "stage_dots"
                and cfg_t.learning_rate == config4().learning_rate,
                "train: the CLI's flags do not give config 4")
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        tv = main_funcs.train(cfg_t, io=io_factory(
            cfg_t, n_events=8, mean_voxels=mean_voxels))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches["cli_train_3_steps"] = got = counts()
        print(f"launches in 3 CLI train steps: {got}")
        require((got["halo_conv"], got["halo_conv_dw"], got["halo26_fwd"],
                 got["halo26_bwd"]) == (3 * 81, 3 * 41, 0, 0),
                "expected 81 B and 41 C launches (no D or E) a CLI train "
                "step")
        require_a(3 * 21, got, "3 CLI train steps")
        ckpts = sorted(glob.glob(os.path.join(d, "snap-*.ckpt")))
        require([os.path.basename(p) for p in ckpts]
                == ["snap-1.ckpt", "snap-2.ckpt", "snap-3.ckpt"],
                f"expected 3 checkpoints, found {ckpts}")
        rows = read_csv(os.path.join(d, "log", "train_log.csv"))
        require(len(rows) == 3 and list(rows[0]) == TRAIN_LOG_COLUMNS,
                f"train_log.csv: {len(rows)} rows, columns {list(rows[0])}")
        losses = [float(r["loss"]) for r in rows]
        require(all(np.isfinite(losses)), f"non-finite CLI losses {losses}")
        tfwd = [float(r["tforward"]) * 1e3 for r in rows]
        tsave = [float(r["tsave"]) * 1e3 for r in rows]
        titer = [float(r["titer"]) * 1e3 for r in rows]
        print(f"CLI train: {train_s:.1f} s for 3 iterations; losses "
              f"{', '.join(f'{l:.6f}' for l in losses)}; tforward "
              f"{', '.join(f'{t:.1f}' for t in tfwd)} ms (phase 4's step: "
              f"{step_ms:.1f} ms on CUDA events); titer "
              f"{', '.join(f'{t:.1f}' for t in titer)} ms")

        # restore: a fresh TrainVal from the last checkpoint
        last = ckpts[-1]
        size = os.path.getsize(last)
        tv2 = TrainVal(cfg_t.replace(model_path=last))
        tv2.initialize()
        require(tv2.global_step == 3, f"restored step {tv2.global_step}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tv2.restore_state(last)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        print(f"checkpoint {os.path.basename(last)}: {size} bytes; save "
              f"(the CSV's tsave) {', '.join(f'{t:.1f}' for t in tsave)} ms; "
              f"restore {restore_ms:.1f} ms")
        blob = event_blob(config4(), BATCH4)
        x = [torch.from_numpy(blob[k]).to(device)
             for k in ("coords", "values", "n_voxels")]
        with torch.no_grad():
            trained, _ = tv.model(*x)
            restored, _ = tv2.model(*x)
        require(torch.equal(restored, trained),
                "the restored model's logits differ from the trained model's")
        print("restored logits torch.equal to the trained model's")
        del tv, tv2, trained, restored
        torch.cuda.empty_cache()

        # inference at config 3 over the checkpoint glob
        has_h5py = importlib.util.find_spec("h5py") is not None
        pred = os.path.join(d, "pred.h5")
        _, cfg_i = parse_args(cli_argv(
            "inference", d, BATCH, "-mp", os.path.join(d, "snap-*.ckpt"),
            "-nt", "4", *(["-of", pred] if has_h5py else [])))
        require_model_of(cfg_i, config3(), "inference")
        n_batches = 4
        io = io_factory(cfg_i, n_events=n_batches * BATCH,
                        mean_voxels=mean_voxels)
        torch.cuda.synchronize()
        reset_counts()
        main_funcs.inference(cfg_i, io=io)
        torch.cuda.synchronize()
        launches["cli_inference_12_forwards"] = got = counts()
        n_fwd = 3 * n_batches
        print(f"launches in {n_fwd} CLI inference forwards: {got}")
        require((got["halo_conv"], got["halo_conv_dw"], got["halo26_fwd"],
                 got["halo26_bwd"]) == (37 * n_fwd, 0, 0, 0),
                "expected 37 B launches (no C, D or E) a CLI forward")
        require_a(9 * n_fwd, got, f"{n_fwd} CLI inference forwards")
        rows = read_csv(os.path.join(d, "log", "inference_log.csv"))
        require([r["ckpt"] for r in rows]
                == ["snap-1.ckpt", "snap-2.ckpt", "snap-3.ckpt"],
                f"inference_log.csv rows {[r['ckpt'] for r in rows]}")
        require(all(np.isfinite(float(r["loss"])) for r in rows),
                "non-finite CLI inference loss")
        eps = [float(r["events_per_sec"]) for r in rows]
        print(f"CLI inference events/s per checkpoint (4 threads of "
              f"synthetic events, batch {BATCH}): "
              f"{', '.join(f'{e:.2f}' for e in eps)}; phase 2's forward: "
              f"{fwd_rate:.2f} events/s")
        if has_h5py:
            import h5py
            with h5py.File(pred, "r") as f:
                g = f["prediction"]
                n_ev = 3 * n_batches * BATCH
                rs = g["row_splits"][()]
                require(len(g["entries"]) == n_ev and len(rs) == n_ev + 1
                        and rs[-1] == len(g["coords"]) == len(g["values"])
                        == len(g["softmax"]),
                        "prediction file: row counts disagree")
                require(bool((g["softmax"][()].argmax(-1)
                              == g["values"][()]).all()),
                        "prediction file: values are not the softmax argmax")
                print(f"prediction file: {n_ev} events, {rs[-1]} voxels, "
                      f"{os.path.getsize(pred)} bytes")
        else:
            print("h5py is not installed: the prediction writer (-of) was "
                  "not run on the card")

        _, cfg_io = parse_args(cli_argv("iotest", d, BATCH, "-it", "4",
                                        "-nt", "4"))
        io_eps = main_funcs.iotest(cfg_io, io=io_factory(
            cfg_io, n_events=n_batches * BATCH, mean_voxels=mean_voxels))
        require(io_eps > 0, "iotest gave no rate")
    return launches


def config1():
    """benchmarks/run_all.py config 1: the dense U-ResNet forward, one 64^3
    event (2000 voxels asked of the generator)."""
    from uresnet_pytorch_tpu_torch.config import URESNetConfig
    return URESNetConfig(model_name="uresnet_dense", spatial_size=64,
                         uresnet_filters=16, uresnet_num_strides=5,
                         max_voxels=4096, batch_size=1,
                         compute_dtype="bfloat16")


def config2():
    """benchmarks/run_all.py config 2: the dense U-ResNet training step,
    one 128^3 event (8000 voxels asked), class weights 1.0 / 0.5."""
    from uresnet_pytorch_tpu_torch.config import URESNetConfig
    return URESNetConfig(model_name="uresnet_dense", spatial_size=128,
                         uresnet_filters=16, uresnet_num_strides=5,
                         max_voxels=16384, batch_size=1, weight_key="weight",
                         compute_dtype="bfloat16")


def compare_steps(cfg, ref_cfg, variables, blob, what: str) -> None:
    """Phase 4's bounds between one train step at `cfg` and one at
    `ref_cfg` from the same variables (no optimizer step): loss within
    1e-2, the whole gradient at cosine >= 0.99 and |delta|/|ref| <= 5e-2,
    the running moments within 1e-2."""
    from uresnet_pytorch_tpu_torch.trainval import TrainVal
    res = []
    for c in (cfg, ref_cfg):
        tv = TrainVal(c)
        tv.initialize(variables)
        res.append(grads_and_stats(tv, blob))
        del tv
    (loss, grads, stats), (loss_r, grads_r, stats_r) = res
    rel_loss = abs(loss - loss_r) / abs(loss_r)
    names = sorted(grads_r)
    g_cos, g_rel = cos_rel(torch.cat([grads[n].flatten() for n in names]),
                           torch.cat([grads_r[n].flatten() for n in names]))
    worst_stat = max(float(((stats[n] - sr).abs()
                            / sr.abs().clamp(min=1.0)).max())
                     for n, sr in stats_r.items())
    print(f"{what} train step: loss {loss:.6f} vs {loss_r:.6f} (rel "
          f"{rel_loss:.3e}); whole gradient ({len(names)} leaves): cosine "
          f"{g_cos:.6f}, |delta|/|ref| {g_rel:.3e}; {len(stats_r)} running "
          f"moments, worst rel {worst_stat:.3e}")
    require(rel_loss <= 1e-2, f"{what}: losses disagree")
    require(g_cos >= 0.99 and g_rel <= 5e-2, f"{what}: gradients disagree")
    require(worst_stat <= 1e-2, f"{what}: running moments disagree")


def dense_phase(device, counts, reset_counts) -> dict:
    """Phase 10: the dense U-ResNet (configs 1 and 2) through the model
    entry point, TrainVal and the CLI. Returns each path's kernel
    launches (none: its convolutions are cuDNN's)."""
    from uresnet_pytorch_tpu_torch import main_funcs
    from uresnet_pytorch_tpu_torch.flags import parse_args
    from uresnet_pytorch_tpu_torch.iotools import io_factory
    from uresnet_pytorch_tpu_torch.models import construct
    from uresnet_pytorch_tpu_torch.models.norm import MaskedBatchNorm
    from uresnet_pytorch_tpu_torch.trainval import TrainVal
    from uresnet_pytorch_tpu_torch.utils.weights import (init_params,
                                                         load_jax_variables)
    none = dict.fromkeys(counts(), 0)
    launches = {}
    cfg1 = config1()
    blob = event_blob(cfg1, 1, mean_voxels=2000)
    x_cpu = [torch.from_numpy(blob[k]) for k in ("coords", "values",
                                                 "n_voxels")]
    x = [t.to(device) for t in x_cpu]
    n = int(blob["n_voxels"][0])
    print(f"config 1: dense, 64^3, batch 1, {n} voxels")
    variables = init_params(cfg1, torch.Generator().manual_seed(SEED))
    f32 = dataclasses.replace(cfg1, compute_dtype="float32")

    def model(c, dev):
        m = construct("uresnet_dense")(c, device=dev)
        load_jax_variables(m, variables)
        return m

    with torch.no_grad():
        t0 = time.perf_counter()
        ref, _ = model(f32, "cpu")(*x_cpu)
        cpu_s = time.perf_counter() - t0
        got32, _ = model(f32, device)(*x)
        err = float((got32.cpu() - ref).abs().max())
        scale = float(ref.abs().max())
        print(f"config-1 f32 forward, card vs CPU ({cpu_s:.1f} s there): "
              f"max|delta| {err:.3e}, max|ref| {scale:.3e}")
        require(err <= 1e-4 * scale, "config 1: f32 card vs CPU disagree")
        m16 = model(cfg1, device)
        m16(*x)
        torch.cuda.synchronize()
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(10):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            logits, diag = m16(*x)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        peak = torch.cuda.max_memory_allocated()
        launches["dense_config1_10_forwards"] = got = counts()
        profile_run(lambda: m16(*x), "dense config-1 forward", top=8)
    require(got == none, f"the dense forward launched a kernel: {got}")
    require(tuple(logits.shape) == (1, cfg1.max_voxels, cfg1.num_class)
            and bool(torch.isfinite(logits).all()),
            "config 1: logits of the wrong shape or not finite")
    require({k: int(v) for k, v in diag.items()} == dict.fromkeys(
        ("overflow", "tile_spill", "vox_spill"), 0), f"diag {diag}")
    valid = torch.arange(cfg1.max_voxels, device=device)[None] < n
    compare_logits(logits, got32, valid, "config-1 bf16 vs f32 logits")
    ms = float(np.median(times))
    print(f"config-1 bf16 forward, 10 runs: "
          f"{', '.join(f'{t:.2f}' for t in times)} ms; median {ms:.2f} ms = "
          f"{1e3 / ms:.2f} events/s; peak memory {peak / 2**30:.3f} GiB")
    del ref, got32, logits, m16

    cfg2 = config2()
    blob2 = event_blob(cfg2, 1, mean_voxels=8000)
    blob2["weight"] = np.where(blob2["label"] > 0, 1.0, 0.5).astype(
        np.float32)
    print(f"config 2: dense, 128^3, batch 1, {int(blob2['n_voxels'][0])} "
          f"voxels, class weights 1.0 / 0.5")
    variables2 = init_params(cfg2, torch.Generator().manual_seed(SEED))
    compare_steps(cfg2, dataclasses.replace(cfg2, compute_dtype="float32"),
                  variables2, blob2, "config-2 bf16 vs f32")
    # the running moments take one momentum update from the step's batch
    # moments, though every block's forward runs twice (recompute); the
    # batch moments come from a no-grad train forward of the same weights
    tv = TrainVal(cfg2)
    tv.initialize(variables2)
    probe = TrainVal(cfg2)
    probe.initialize(variables2)
    with torch.no_grad():
        probe._metrics(probe._batch(blob2), train=True)
    bns = [(n, m) for n, m in tv.model.named_modules()
           if isinstance(m, MaskedBatchNorm)]
    moments = {n: m.batch_moments for n, m in probe.model.named_modules()
               if isinstance(m, MaskedBatchNorm)}
    before = {n: (m.mean.clone(), m.var.clone()) for n, m in bns}
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, times, _ = timed_steps(tv, blob2, 0, 1)
    once = twice = 0.0
    for n, m in bns:
        for new, old, batch in zip((m.mean, m.var), before[n], moments[n]):
            mom = m.momentum
            want = mom * old + (1 - mom) * batch
            scale = want.abs().clamp(min=1.0)
            once = max(once, float(((new - want).abs() / scale).max()))
            again = mom * want + (1 - mom) * batch
            twice = max(twice, float(((new - again).abs() / scale).max()))
    print(f"running moments after one step: worst rel {once:.3e} from one "
          f"momentum update ({len(bns)} BNs), {twice:.3e} from two")
    require(once <= 1e-3 < twice,
            "the running moments are not one momentum update")
    more, more_times, metrics = timed_steps(tv, blob2, 1, 3)
    peak2 = torch.cuda.max_memory_allocated()
    launches["dense_config2_5_steps"] = got = counts()
    losses += more
    times += more_times
    print(f"config-2 losses of 5 steps on one batch: "
          f"{', '.join(f'{l:.6f}' for l in losses)}")
    require(got == none, f"the dense step launched a kernel: {got}")
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            "config 2: the loss did not fall in 5 steps")
    profile_run(lambda: tv.train_step(blob2), "dense config-2 step", top=8)
    step_ms = float(np.median(times[1:]))
    print(f"config-2 train step, 3 runs after 2: "
          f"{', '.join(f'{t:.1f}' for t in times[1:])} ms; median "
          f"{step_ms:.1f} ms = {1e3 / step_ms:.3f} events/s; peak memory "
          f"{peak2 / 2**30:.3f} GiB")
    del tv, probe
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as d:
        base = ["-mn", "uresnet_dense", "-io", "synthetic", "-ss", "128",
                "-uf", "16", "-uns", "5", "--max-voxels", "16384", "-bs",
                "1", "-wk", "weight", "--compute-dtype", "bfloat16", "-nt",
                "1", "-wp", os.path.join(d, "snap"),
                "-ld", os.path.join(d, "log")]
        _, ct = parse_args(["train", *base, "-it", "2", "-chks", "1",
                            "-rs", "1"])
        require(ct.model_name == "uresnet_dense"
                and ct.n_planes == cfg2.n_planes
                and ct.max_voxels == cfg2.max_voxels
                and ct.weight_key == cfg2.weight_key,
                "the CLI's flags do not give config 2")
        reset_counts()
        main_funcs.train(ct, io=io_factory(ct, n_events=4, mean_voxels=8000))
        ckpts = sorted(os.path.basename(p)
                       for p in glob.glob(os.path.join(d, "snap-*.ckpt")))
        rows = read_csv(os.path.join(d, "log", "train_log.csv"))
        require(ckpts == ["snap-1.ckpt", "snap-2.ckpt"] and len(rows) == 2
                and all(np.isfinite(float(r["loss"])) for r in rows),
                f"dense CLI train: checkpoints {ckpts}, {len(rows)} rows")
        _, ci = parse_args(["inference", *base,
                            "-mp", os.path.join(d, "snap-*.ckpt")])
        main_funcs.inference(ci, io=io_factory(ci, n_events=2,
                                               mean_voxels=8000))
        irows = read_csv(os.path.join(d, "log", "inference_log.csv"))
        require([r["ckpt"] for r in irows] == ckpts
                and all(np.isfinite(float(r["loss"])) for r in irows),
                f"dense CLI inference rows {irows}")
        launches["dense_cli"] = got = counts()
        require(got == none, f"the dense CLI launched a kernel: {got}")
        print(f"dense CLI: train losses "
              f"{', '.join(r['loss'] for r in rows)}, tforward "
              f"{', '.join(r['tforward'] for r in rows)} s; inference over "
              f"{ckpts}: loss {', '.join(r['loss'] for r in irows)}")
    return launches


def gather_phase(device, counts, reset_counts, require_a,
                 norm_launches) -> dict:
    """Phase 11: the row-gather engine at config 3 (forward, held against
    the tile engine, kernels A and B) and config 4's shape (a step against
    the tile engine's, five steps), each with its exact BN launches
    (`norm_launches()`: none of kernels A-E, the BN kernels at every BN).
    Returns each path's launches of kernels A-E."""
    from uresnet_pytorch_tpu_torch.models import construct
    from uresnet_pytorch_tpu_torch.trainval import TrainVal
    from uresnet_pytorch_tpu_torch.utils.weights import (init_params,
                                                         load_jax_variables)
    none = dict.fromkeys(counts(), 0)
    launches = {}
    cfg = config3()
    coords, values, nv = events(cfg, device)
    variables = init_params(cfg, torch.Generator().manual_seed(SEED))
    models = {}
    for engine in ("tile", "gather"):
        models[engine] = construct("uresnet_sparse")(
            dataclasses.replace(cfg, sparse_engine=engine))
        load_jax_variables(models[engine], variables)
    with torch.no_grad():
        for m in models.values():
            m(coords, values, nv)                      # warm-up
        torch.cuda.synchronize()
        reset_counts()
        tile, _ = models["tile"](coords, values, nv)
        torch.cuda.synchronize()
        launches["tile_forward_phase11"] = got = counts()
        require(got["halo_conv"] == 37, f"tile forward: {got}")
        require_a(9, got, "the tile forward")
        require(norm_launches() == {"fwd": NORM_FORWARD_LAUNCHES, "bwd": 0},
                f"tile forward: norm_act launches {norm_launches()}")
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            logits, diag = models["gather"](coords, values, nv)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        peak = torch.cuda.max_memory_allocated()
        launches["gather_3_forwards"] = got = counts()
        norm_fwd = norm_launches()
        profile_run(lambda: models["gather"](coords, values, nv),
                    "gather-engine config-3 forward", top=10)
    require(got == none, f"the gather engine launched a kernel: {got}")
    require(norm_fwd == {"fwd": 3 * NORM_GATHER_FORWARD_LAUNCHES, "bwd": 0},
            f"expected {NORM_GATHER_FORWARD_LAUNCHES} norm_act launches per "
            f"gather-engine forward, got {norm_fwd} in 3")
    pad = torch.arange(cfg.max_voxels, device=device)[None] >= nv[:, None]
    require(bool(torch.isfinite(logits).all())
            and bool((logits[pad] == 0).all()),
            "gather engine: non-finite logits or nonzero padding rows")
    compare_logits(tile, logits, ~pad,
                   "tile engine (kernels A, B) vs gather engine logits")
    ms = sorted(times)[1]
    print(f"gather-engine config-3 forward, 3 runs: "
          f"{', '.join(f'{t:.1f}' for t in times)} ms; median {ms:.1f} ms = "
          f"{BATCH / (ms / 1e3):.2f} events/s; peak memory "
          f"{peak / 2**30:.2f} GiB")
    del models, tile, logits, coords, values, nv, pad
    torch.cuda.empty_cache()

    cfg4 = config4()
    cfg4g = dataclasses.replace(cfg4, sparse_engine="gather")
    blob = event_blob(cfg4, BATCH4)
    variables4 = init_params(cfg4, torch.Generator().manual_seed(cfg4.seed))
    compare_steps(cfg4, cfg4g, variables4, blob,
                  "tile engine vs gather engine, config 4's shape,")
    tv = TrainVal(cfg4g)
    tv.initialize(variables4)
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, times, _ = timed_steps(tv, blob, 2, 3)
    peak = torch.cuda.max_memory_allocated()
    launches["gather_5_steps"] = got = counts()
    norm_step = norm_launches()
    require(norm_step == {k: 5 * v for k, v in
                          NORM_GATHER_STEP_LAUNCHES.items()},
            f"expected norm_act launches {NORM_GATHER_STEP_LAUNCHES} per "
            f"gather-engine step, got {norm_step} in 5")
    print(f"gather-engine norm_act launches: {norm_fwd} in 3 forwards, "
          f"{norm_step} in 5 steps")
    print(f"gather-engine losses of 5 steps on one batch: "
          f"{', '.join(f'{l:.6f}' for l in losses)}")
    require(got == none, f"the gather step launched a kernel: {got}")
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            "gather engine: the loss did not fall in 5 steps")
    profile_run(lambda: tv.train_step(blob), "gather-engine step", top=8)
    step_ms = sorted(times)[1]
    print(f"gather-engine train step (batch {BATCH4}), 3 runs after 2: "
          f"{', '.join(f'{t:.1f}' for t in times)} ms; median "
          f"{step_ms:.1f} ms = {BATCH4 / (step_ms / 1e3):.3f} events/s; "
          f"peak memory {peak / 2**30:.2f} GiB")
    del tv
    torch.cuda.empty_cache()
    return launches


def counter_modules() -> dict:
    """Each kernel's launch counter: {name: (module, attribute)}."""
    from uresnet_pytorch_tpu_torch.ops.cuda import halo_conv as hc_mod
    from uresnet_pytorch_tpu_torch.ops.cuda import halo_conv_dw as dw_mod
    from uresnet_pytorch_tpu_torch.ops.cuda import halo_extend as he_mod
    from uresnet_pytorch_tpu_torch.ops.cuda import windowed_gather as wg_mod
    return {"halo_conv": (hc_mod, "launches"),
            "halo_conv_dw": (dw_mod, "launches"),
            "windowed_gather": (wg_mod, "launches"),
            "halo26_fwd": (he_mod, "launches_fwd"),
            "halo26_bwd": (he_mod, "launches_bwd")}


def kernel_counts() -> dict:
    return {k: getattr(m, attr) for k, (m, attr) in counter_modules().items()}


# a config-4 (and config-5) stage_dots step's launches, per rank
STEP_LAUNCHES = {"halo_conv": 81, "halo_conv_dw": 41, "windowed_gather": 21,
                 "halo26_fwd": 0, "halo26_bwd": 0}


# phase 12 (b)'s bounds on step 1 of two gloo ranks against one process on
# the batch, each relative: the loss's, the whole gradient's |d|/|ref| and
# the running moments' largest |d| over max(|ref|, 1). Each lies between
# the sound run's reading and those of the faults `dp_rank` plants (PERF.md,
# section 6): in bf16 per-rank BN moves the gradient 4.5e-2 against the
# sound 2.2e-3, and per-rank loss normalization, 3.0e-3, hides in that
# bf16 noise; in f32 the sound run reads 5.9e-5, that fault 2.4e-3.
DP_BOUNDS = {"loss": 1e-5, "grad": 1e-2, "stat": 1e-5}
DP_F32_BOUNDS = {"loss": 1e-5, "grad": 5e-4, "stat": 1e-5}
DP_FAULTS = ("rank_bn", "rank_loss")


def rank_mean_loss(segmentation_loss):
    """The loss normalized per rank and the ranks' gradients averaged,
    as DistributedDataParallel would have it: each rank's gradient is that
    of its own mean loss over the rank count. The value stays the global
    loss, so the fault shows in the gradient alone."""
    def loss(*args, mesh=None, **kw):
        out = segmentation_loss(*args, mesh=mesh, **kw)
        own = segmentation_loss(*args, mesh=None, **kw)["loss"] / mesh.size
        out["loss"] = out["loss"].detach() + own - own.detach()
        return out
    return loss


def dp_rank(cfg, variables, blob, steps: int, out: str,
            faults: bool = False) -> None:
    """One rank of phase 12, in a process that `parallel.launch` started:
    `steps` train steps of `cfg` from `variables` on this rank's shard of
    `blob`, under the process group. Writes to out.format(rank): step 1's
    loss, summed gradients and new moments, each step's loss, kernel
    launches and ms (CUDA events), the parameters after each step (on the
    host) and the peak device memory. With `faults`, step 1 again from
    `variables` with each of DP_FAULTS planted ("rank_bn": BN moments per
    rank; "rank_loss": rank_mean_loss), and in f32 (the unfused path)
    sound and with each fault planted: under {"bfloat16", "float32"} x
    {"sound", *DP_FAULTS}, the sound bf16 run left out."""
    import torch.distributed as dist
    from uresnet_pytorch_tpu_torch import trainval
    from uresnet_pytorch_tpu_torch.models.norm import use_mesh
    from uresnet_pytorch_tpu_torch.parallel.dryrun import step_result
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tv = trainval.TrainVal(cfg)
    tv.initialize(variables)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = {"losses": [], "ms": [], "launches": [], "params": [],
           "backend": dist.get_backend(), "world": tv.mesh.size,
           "device": str(tv.device)}
    for i in range(steps):
        before = kernel_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if i == 0:
            res["first"] = step_result(tv, blob)
            loss = res["first"]["loss"]
        else:
            loss = float(tv.train_step(blob)["loss"])
        end.record()
        torch.cuda.synchronize()
        res["ms"].append(start.elapsed_time(end))
        res["losses"].append(loss)
        res["launches"].append({k: v - before[k]
                                for k, v in kernel_counts().items()})
        res["params"].append({k: p.detach().cpu().clone()
                              for k, p in tv.model.named_parameters()})
    res["peak"] = torch.cuda.max_memory_allocated()
    del tv
    if faults:
        res["faults"] = {}
        sound_loss = trainval.segmentation_loss
        for dtype in ("bfloat16", "float32"):
            for fault in ("sound",) * (dtype == "float32") + DP_FAULTS:
                tv = trainval.TrainVal(dataclasses.replace(
                    cfg, compute_dtype=dtype))
                tv.initialize(variables)
                if fault == "rank_bn":
                    use_mesh(tv.model, None)
                if fault == "rank_loss":
                    trainval.segmentation_loss = rank_mean_loss(sound_loss)
                try:
                    res["faults"][dtype, fault] = step_result(tv, blob)
                finally:
                    trainval.segmentation_loss = sound_loss
                del tv
                torch.cuda.empty_cache()
    torch.save(res, out.format(dist.get_rank()))


def dp_gap(ref: dict, got: dict) -> dict:
    """Step 1 of a data-parallel run against the one-process step: the
    loss's relative difference, the whole gradient's cosine and |d|/|ref|,
    the running moments' largest |d| / max(|ref|, 1), and the three leaves
    of largest max|d|."""
    names = sorted(ref["grads"])
    d_grad = {n: float(np.abs(got["grads"][n] - ref["grads"][n]).max())
              for n in names}
    flat = [torch.from_numpy(np.concatenate([g["grads"][n].ravel()
                                             for n in names]))
            for g in (got, ref)]
    g_cos, g_rel = cos_rel(*flat)
    return {"loss": abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
            "cos": g_cos, "grad": g_rel,
            "stat": max(float((np.abs(got["stats"][n] - r)
                               / np.maximum(np.abs(r), 1.0)).max())
                        for n, r in ref["stats"].items()),
            "zero": sum(v == 0 for v in d_grad.values()), "leaves": len(names),
            "worst": sorted(d_grad.items(), key=lambda kv: -kv[1])[:3]}


def show_gap(what: str, gap: dict) -> None:
    print(f"{what}: loss rel {gap['loss']:.3e}; {gap['leaves']} gradients "
          f"({gap['zero']} exactly equal; largest max|d| "
          f"{', '.join(f'{n} {v:.3e}' for n, v in gap['worst'])}), "
          f"whole-gradient cosine {gap['cos']:.6f}, |d|/|ref| "
          f"{gap['grad']:.3e}; running moments rel {gap['stat']:.3e}")


def broken(gap: dict, bounds: dict) -> list:
    """The bounds of `bounds` that `gap` exceeds."""
    return [k for k, b in bounds.items() if not gap[k] <= b]


def dp_phase(cfg4, variables, blob, step_ms: float) -> dict:
    """Phase 12: data parallel at config 5 (`benchmarks/run_all.py:159-173`:
    config 4's model at batch max(2, ranks)): (a) one NCCL rank, four
    steps, held to phase 4's step without a process group at phase 4's
    bounds; (b) two ranks on the one card over gloo (NCCL refuses two
    ranks on one device), one event each, two steps, step 1 held to the
    one-process step at DP_BOUNDS and its f32 step at DP_F32_BOUNDS; the
    faults `dp_rank` plants must break them: per-rank BN in bf16 and in
    f32, per-rank loss normalization in f32 (its bf16 reading is printed).
    Returns each run's launches."""
    from uresnet_pytorch_tpu_torch.parallel import launch
    from uresnet_pytorch_tpu_torch.parallel.dryrun import step_result
    from uresnet_pytorch_tpu_torch.trainval import TrainVal
    refs = {}
    for dtype in ("bfloat16", "float32"):
        tv = TrainVal(dataclasses.replace(cfg4, compute_dtype=dtype))
        tv.initialize(variables)
        refs[dtype] = step_result(tv, blob)
        del tv
        torch.cuda.empty_cache()
    ref = refs["bfloat16"]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank{}.pt")
        t0 = time.perf_counter()
        launch(dp_rank, 1, device_ids=(0,), args=(cfg4, variables, blob, 4,
                                                  out))
        print(f"(a) one NCCL rank: {time.perf_counter() - t0:.1f} s with "
              "its start")
        a = torch.load(out.format(0), weights_only=False)
        t0 = time.perf_counter()
        launch(dp_rank, 2, device_ids=(0, 0),
               args=(cfg4, variables, blob, 2, out, True))
        print(f"(b) two gloo ranks on one card: "
              f"{time.perf_counter() - t0:.1f} s with their start")
        b = [torch.load(out.format(r), weights_only=False) for r in range(2)]
    require((a["backend"], a["world"]) == ("nccl", 1), f"(a) ran "
            f"{a['backend']} over {a['world']}")
    require(all((r["backend"], r["world"]) == ("gloo", 2) for r in b),
            "(b) did not run gloo over two ranks")
    for what, runs in (("(a)", [a]), ("(b)", b)):
        for r, run in enumerate(runs):
            for i, got in enumerate(run["launches"]):
                require(got == STEP_LAUNCHES, f"{what} rank {r} step {i + 1} "
                        f"launched {got}, expected {STEP_LAUNCHES}")
            require(all(np.isfinite(run["losses"])), f"{what}: a non-finite "
                    "loss")
    print(f"launches per rank per step: {STEP_LAUNCHES} in every step of "
          "(a) and of both ranks of (b)")
    # (a): phase 4's bounds of a bf16 step (a sum over one rank is the
    # identity, so 0 is expected up to kernel C's atomic order)
    gap = dp_gap(ref, a["first"])
    show_gap("(a) one NCCL rank vs no process group, config 4", gap)
    require(gap["loss"] <= 1e-2 and gap["cos"] >= 0.99 and gap["grad"] <= 5e-2
            and gap["stat"] <= 1e-2, "(a) disagrees at phase 4's bounds")
    gaps = {}
    for r, run in enumerate(b):
        gaps[r] = dp_gap(ref, run["first"])
        show_gap(f"(b) gloo rank {r} of 2 (one event each) vs one process "
                 "on both events", gaps[r])
        for (dtype, fault), res in run["faults"].items():
            gaps[r, dtype, fault] = dp_gap(refs[dtype], res)
            show_gap(f"(b) rank {r}, {dtype}, {fault}"
                     + " planted" * (fault != "sound"), gaps[r, dtype, fault])
    print(f"(b) bounds in bf16 {DP_BOUNDS}, in f32 {DP_F32_BOUNDS}")
    for r in range(2):
        for dtype, bounds, faults in (("bfloat16", DP_BOUNDS, ("rank_bn",)),
                                      ("float32", DP_F32_BOUNDS, DP_FAULTS)):
            sound = gaps[r] if dtype == "bfloat16" else gaps[r, dtype, "sound"]
            require(not broken(sound, bounds), f"(b) rank {r} in {dtype} "
                    f"breaks {broken(sound, bounds)}")
            for fault in faults:
                caught = broken(gaps[r, dtype, fault], bounds)
                require(bool(caught), f"(b) rank {r}: the planted {fault} "
                        f"passes the {dtype} bounds")
                print(f"(b) rank {r}: planted {fault} in {dtype} breaks "
                      f"{caught}")
    for i in range(2):
        p0, p1 = (run["params"][i] for run in b)
        require(all(torch.equal(p0[k], p1[k]) for k in p0),
                f"(b) the ranks' parameters differ after step {i + 1}")
    print("(b) parameters torch.equal across the ranks after steps 1 and 2")
    ms_a = float(np.median(a["ms"][1:]))
    print(f"(a) one NCCL rank, config 5 at batch {BATCH4}: steps "
          f"{', '.join(f'{t:.1f}' for t in a['ms'])} ms; median of steps 2-4 "
          f"{ms_a:.1f} ms = {BATCH4 / (ms_a / 1e3):.3f} events/s (phase 4: "
          f"{step_ms:.1f} ms = {BATCH4 / (step_ms / 1e3):.3f}); losses "
          f"{', '.join(f'{l:.6f}' for l in a['losses'])}; peak memory "
          f"{a['peak'] / 2**30:.2f} GiB")
    for r, run in enumerate(b):
        print(f"(b) gloo, 2 ranks on 1 card (not a multi-card rate), rank "
              f"{r}: steps {', '.join(f'{t:.1f}' for t in run['ms'])} ms, "
              f"losses {', '.join(f'{l:.6f}' for l in run['losses'])}, peak "
              f"memory {run['peak'] / 2**30:.2f} GiB")
    return {"dp_nccl_1_rank_step": a["launches"][0],
            "dp_gloo_2_ranks_step_per_rank": b[0]["launches"][0]}


class ScnUNet(torch.nn.Module):
    """Phase 13's U-Net of the SCN layer API (`uresnet_pytorch_tpu_torch
    .scn`): input, submanifold convs with BN-LeakyReLU, down by a stride-2
    Convolution, MaxPooling and AveragePooling, up by UnPooling and
    Deconvolution with channel joins, a per-site linear head, output."""

    def __init__(self, dim: int, size: int, m: int, classes: int):
        super().__init__()
        from uresnet_pytorch_tpu_torch import scn
        self.join = scn.join_table

        def block(cin, cout):
            return torch.nn.ModuleList([
                scn.SubmanifoldConvolution(dim, cin, cout),
                scn.BatchNormLeakyReLU(cout, leakiness=0.1)])
        self.inp = scn.InputLayer(dim, size)
        self.enc0 = block(1, m)
        self.down = scn.Convolution(dim, m, 2 * m)
        self.enc1 = block(2 * m, 2 * m)
        self.maxpool = scn.MaxPooling(dim)
        self.enc2 = block(2 * m, 2 * m)
        self.avgpool = scn.AveragePooling(dim)
        self.enc3 = block(2 * m, 2 * m)
        self.unpool = scn.UnPooling(dim)
        self.dec2 = block(4 * m, 2 * m)
        self.dec1 = block(4 * m, 2 * m)
        self.up = scn.Deconvolution(dim, 2 * m, m)
        self.dec0 = block(2 * m, m)
        self.head = scn.NetworkInNetwork(m, classes, bias=True)
        self.out = scn.OutputLayer(dim)

    def forward(self, coords, values, n_voxels, train: bool = False):
        def run(blk, st):
            return blk[1](blk[0](st), train)
        j = self.join
        st, roi = self.inp(coords, values, n_voxels)
        l0 = run(self.enc0, st)
        l1, link0 = self.down(l0)
        l1 = run(self.enc1, l1)
        l2, link1 = self.maxpool(l1)
        l2 = run(self.enc2, l2)
        l3, link2 = self.avgpool(l2)
        l3 = run(self.enc3, l3)
        u2 = run(self.dec2, j(self.unpool(l3, link2), l2))
        u1 = run(self.dec1, j(self.unpool(u2, link1), l1))
        u0 = run(self.dec0, j(self.up(u1, link0), l0))
        return self.out(self.head(u0), roi)


# phase 13: the SCN U-Net's train-mode parameter gradients on the card,
# each leaf's max|d| over the f64 witness's max|ref|; the card read 1.8e-6
# there, the CPU in f32 6.0e-3 (PERF.md, section 6)
SCN_TRAIN_GRAD_BOUND = 1e-4


def scn_phase(device, counts, reset_counts) -> dict:
    """Phase 13: the SCN layer API on the card: a U-Net of its layers on
    one config-3 event, in f32 on the card and on the CPU and in f64 on the
    CPU (the witness): a train-mode forward and backward, the running
    moments it commits, then an eval-mode forward and backward. The card is
    held to the CPU at max|delta| <= 1e-4 * max|ref| for both outputs, the
    moments and the eval-mode gradients, and to the witness at
    SCN_TRAIN_GRAD_BOUND for the train-mode gradients (the CPU's own f32
    gap to the witness printed beside it); max and average pooling on a
    fully active 32^3 grid are held to F.max_pool3d / F.avg_pool3d, and
    no kernel A-E launches. Returns its launches."""
    import copy
    import torch.nn.functional as F
    from uresnet_pytorch_tpu_torch import scn
    from uresnet_pytorch_tpu_torch.models.norm import commit_batch_moments
    from uresnet_pytorch_tpu_torch.iotools.synthetic import generate_event
    none = dict.fromkeys(counts(), 0)
    reset_counts()
    torch.manual_seed(SEED)
    c, v, _ = generate_event(SEED, 0, 512, 3, mean_voxels=int(N_VOXELS * 1.5))
    n = len(c)
    cpu_args = (torch.from_numpy(c[None].astype(np.int32)),
                torch.from_numpy(v[None].astype(np.float32)),
                torch.tensor([n], dtype=torch.int32))
    ct = torch.randn((1, n, 5), generator=torch.Generator().manual_seed(1))
    net_cpu = ScnUNet(3, 512, 16, 5)
    runs = {"card": (copy.deepcopy(net_cpu).to(device), device,
                     torch.float32),
            "cpu": (net_cpu, "cpu", torch.float32),
            "f64": (copy.deepcopy(net_cpu).double(), "cpu", torch.float64)}
    results = {}

    def grads(model):
        g = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return g
    for where, (model, dev, dtype) in runs.items():
        args = [a.to(dev) for a in cpu_args]
        args[1] = args[1].to(dtype)
        w = ct.to(dev, dtype)
        if dev != "cpu":
            with torch.no_grad():
                model(*args)                            # warm-up
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_train = model(*args, train=True)            # batch moments
        (out_train * w).sum().backward()
        g_train = grads(model)
        commit_batch_moments(model)
        out = model(*args)
        (out * w).sum().backward()
        if dev != "cpu":
            torch.cuda.synchronize()
        results[where] = {"train": out_train.detach().cpu(),
                          "eval": out.detach().cpu(), "g_train": g_train,
                          "g_eval": grads(model),
                          "moments": {k: b.cpu()
                                      for k, b in model.named_buffers()},
                          "ms": (time.perf_counter() - t0) * 1e3}
    k, cpu, f64 = results["card"], results["cpu"], results["f64"]

    def rel(got, ref):
        return float((got.double() - ref.double()).abs().max()
                     / ref.double().abs().max().clamp(min=1e-30))
    worst = 0.0
    for name, got, ref in [("train-mode output", k["train"], cpu["train"]),
                           ("output", k["eval"], cpu["eval"])] + [
            (m, k["moments"][m], cpu["moments"][m]) for m in cpu["moments"]
            ] + [(f"eval-mode {g}", k["g_eval"][g], cpu["g_eval"][g])
                 for g in cpu["g_eval"]]:
        err = rel(got, ref)
        require(bool(torch.isfinite(got).all()) and err <= 1e-4,
                f"SCN U-Net {name}: card vs CPU max|d|/max|ref| {err:.3e}")
        worst = max(worst, err)
    print(f"SCN U-Net (m=16, 4 levels) on one config-3 event ({n} voxels): "
          f"train-mode output, {len(cpu['moments'])} running moments after "
          f"it, eval output and {len(cpu['g_eval'])} eval-mode parameter "
          f"gradients card vs CPU, worst max|d|/max|ref| {worst:.3e} (bound "
          f"1e-4); train forward and backward, eval forward and backward "
          f"{k['ms']:.1f} ms on the card, {cpu['ms']:.1f} ms on the CPU, "
          f"{f64['ms']:.1f} ms in f64 on the CPU (host clock, after a "
          "warm-up on the card)")
    gaps = {}
    for where, res in (("card", k), ("cpu", cpu)):
        gaps[where] = {g: rel(res["g_train"][g], f64["g_train"][g])
                       for g in f64["g_train"]}
        top = sorted(gaps[where].items(), key=lambda kv: -kv[1])[:3]
        moments = max(rel(res["moments"][m], f64["moments"][m])
                      for m in f64["moments"])
        print(f"SCN U-Net train-mode gradients, {where} f32 vs the f64 "
              f"witness, max|d|/max|ref| per leaf: worst "
              f"{', '.join(f'{g} {e:.3e}' for g, e in top)}; train-mode "
              f"output {rel(res['train'], f64['train']):.3e}, moments "
              f"{moments:.3e}")
    card_cpu = max(rel(k["g_train"][g], cpu["g_train"][g])
                   for g in gaps["cpu"])
    print(f"SCN U-Net train-mode gradients card vs CPU: worst {card_cpu:.3e}; "
          f"bound on the card vs the witness {SCN_TRAIN_GRAD_BOUND:g}")
    for g, err in gaps["card"].items():
        require(bool(torch.isfinite(k["g_train"][g]).all())
                and err <= SCN_TRAIN_GRAD_BOUND, f"SCN U-Net train-mode "
                f"gradient {g}: card vs f64 witness {err:.3e}")
    del runs, results, net_cpu, k, cpu, f64
    torch.cuda.empty_cache()

    S = 32
    g = np.stack(np.meshgrid(*([np.arange(S)] * 3), indexing="ij"),
                 -1).reshape(-1, 3).astype(np.int32)
    vals = torch.randn(len(g), generator=torch.Generator().manual_seed(2))
    args = (torch.from_numpy(g[None]).to(device), vals[None].to(device),
            torch.tensor([len(g)], dtype=torch.int32, device=device))
    st, _ = scn.InputLayer(3, S)(*args)
    dense = vals.to(device).view(1, 1, S, S, S)
    for name, layer, pool in (
            ("max", scn.MaxPooling(3), F.max_pool3d),
            ("average", scn.AveragePooling(3), F.avg_pool3d)):
        stc, _ = layer(st)
        got = stc.features[0, :int(stc.num[0]), 0]
        want = pool(dense, 2).flatten()
        err = float((got - want).abs().max()) if got.shape == want.shape \
            else float("inf")
        require(err <= 1e-6 * float(want.abs().max()),
                f"{name} pooling on a full 32^3 grid vs F.{pool.__name__}: "
                f"max|d| {err}")
        print(f"{name} pooling on a fully active 32^3 grid vs "
              f"F.{pool.__name__}: max|d| {err:.3e}")
    torch.cuda.synchronize()
    got = counts()
    require(got == none, f"the SCN API launched a kernel: {got}")
    print("SCN API: no launch of kernels A-E")
    return {"scn_api_unet_and_pools": got}


def recording_io(cfg, n_events: int, mean_voxels: int):
    """The synthetic loader, whose `store_segment` records the rows it is
    handed (index, coords, n_voxels, softmax) in `.stored` instead of
    writing the h5 file: the card's machine has no h5py. Built inside each
    rank, where the loader reads its rank-strided share."""
    from uresnet_pytorch_tpu_torch.iotools.io_synthetic import IOSynthetic

    class RecordingIO(IOSynthetic):
        def store_segment(self, index, blob, softmax):
            self.stored.append({
                "index": torch.from_numpy(np.array(index)),
                "coords": torch.from_numpy(np.array(blob["coords"])),
                "n_voxels": torch.from_numpy(np.array(blob["n_voxels"])),
                "softmax": torch.from_numpy(np.array(softmax))})

    io = RecordingIO(cfg, n_events=n_events, mean_voxels=mean_voxels)
    io.stored = []
    return io


def writer_rank(cfg, n_events: int, out: str) -> None:
    """One rank of phase 12 (c), in a process that `parallel.launch`
    started: `main_funcs.inference` with `-of` on a recording loader.
    Writes the rows this rank handed the writer and its kernel launches
    to out.format(rank)."""
    import torch.distributed as dist
    from uresnet_pytorch_tpu_torch import main_funcs
    io = recording_io(cfg, n_events, int(N_VOXELS * 1.5))
    before = kernel_counts()
    main_funcs.inference(cfg, io=io)
    torch.cuda.synchronize()
    torch.save({"stored": io.stored, "world": dist.get_world_size(),
                "backend": dist.get_backend(),
                "launches": {k: v - before[k]
                             for k, v in kernel_counts().items()}},
               out.format(dist.get_rank()))


def writer_phase(device, counts, reset_counts, require_a) -> dict:
    """Phase 12 (c): the data-parallel prediction writer. `main_funcs
    .inference` with `-of` at config 3 (batch 8) over two checkpoints of
    12 shuffled events, one loader thread: in one process, and on two gloo
    ranks sharing the card (4 events a rank). The second checkpoint's
    batch crosses the epoch. Rank 0 must hand the writer the one-process
    rows: index, coords and n_voxels `torch.equal`, softmax at phase 2's
    bounds; rank 1 nothing. Returns each run's launches."""
    from uresnet_pytorch_tpu_torch import main_funcs
    from uresnet_pytorch_tpu_torch.flags import parse_args
    from uresnet_pytorch_tpu_torch.parallel import launch
    from uresnet_pytorch_tpu_torch.trainval import TrainVal
    print("h5py is not on the card's machine: a recording loader captures "
          "what rank 0 hands io.store_segment, in place of the h5 file")
    n_events, n_fwd = 12, 2
    with tempfile.TemporaryDirectory() as d:
        _, cfg = parse_args(cli_argv(
            "inference", d, BATCH, "-mp", os.path.join(d, "snap-*.ckpt"),
            "-nt", "1", "-of", os.path.join(d, "pred.h5")))
        require_model_of(cfg, config3(), "inference -of")
        tv = TrainVal(cfg.replace(model_path=""))
        tv.initialize()
        path = tv.save_state(1)
        shutil.copy(path, os.path.join(d, "snap-2.ckpt"))
        del tv
        reset_counts()
        io = recording_io(cfg, n_events, int(N_VOXELS * 1.5))
        main_funcs.inference(cfg, io=io)
        torch.cuda.synchronize()
        one, one_launches = io.stored, counts()
        torch.cuda.empty_cache()
        out = os.path.join(d, "rank{}.pt")
        t0 = time.perf_counter()
        launch(writer_rank, 2, device_ids=(0, 0), args=(cfg, n_events, out))
        print(f"(c) two gloo ranks on one card, inference -of: "
              f"{time.perf_counter() - t0:.1f} s with their start")
        ranks = [torch.load(out.format(r), weights_only=False)
                 for r in range(2)]
    require(all((r["backend"], r["world"]) == ("gloo", 2) for r in ranks),
            "(c) did not run gloo over two ranks")
    require((one_launches["halo_conv"], one_launches["windowed_gather"])
            == (37 * n_fwd, 9 * n_fwd), f"(c) one process: launches "
            f"{one_launches}, expected 37 B and 9 A a forward")
    for r, run in enumerate(ranks):
        got = run["launches"]
        require((got["halo_conv"], got["windowed_gather"])
                == (37 * n_fwd, 9 * n_fwd), f"(c) rank {r}: launches {got}, "
                "expected 37 B and 9 A a forward")
    require(ranks[1]["stored"] == [], f"(c) rank 1 handed the writer "
            f"{len(ranks[1]['stored'])} batches")
    got = ranks[0]["stored"]
    require(len(one) == len(got) == n_fwd, f"(c) batches stored: one "
            f"process {len(one)}, rank 0 {len(got)}, expected {n_fwd}")
    for i, (g, w) in enumerate(zip(got, one)):
        for key in ("index", "coords", "n_voxels"):
            require(g[key].dtype == w[key].dtype and torch.equal(g[key],
                                                                 w[key]),
                    f"(c) batch {i}: rank 0's {key} differs from one "
                    "process's")
        valid = (torch.arange(w["coords"].shape[1])[None]
                 < w["n_voxels"][:, None])
        compare_logits(g["softmax"].to(device), w["softmax"].to(device),
                       valid.to(device), f"(c) batch {i} (entries "
                       f"{w['index'].tolist()}): rank 0's softmax vs one "
                       "process's")
    print(f"(c) rank 0 handed the writer the one-process rows of {n_fwd} "
          "batches (index, coords, n_voxels torch.equal; the second crosses "
          "the epoch); rank 1 handed it nothing")
    return {"writer_one_process_2_forwards": one_launches,
            "writer_gloo_2_ranks_2_forwards_per_rank": ranks[0]["launches"]}


def eval_pair_phase(device, counts, reset_counts, require_a, ms2: float,
                    peak2: int) -> dict:
    """Phase 14: the reference's batch-16 memory A/B, `URESNET_EVAL_PAIR`,
    at config 3 on the card. Forwards at batch 16 with the knob unset
    (concat) and set (pair) from the same variables and events: pair held
    to concat and to the plain path (knob set) at phase 2's bounds; the
    exact kernel-B and kernel-A launches of each forward (37 and 9 with
    concat, 41 and 9 with the pair); three timed forwards each way
    (median) and the peak memory each way, reset before each. The same
    two readings at batch 8 beside phase 2's. Returns each run's
    launches."""
    from uresnet_pytorch_tpu_torch.models import construct
    from uresnet_pytorch_tpu_torch.utils.weights import (init_params,
                                                         load_jax_variables)
    cfg = config3()
    model = construct("uresnet_sparse")(cfg)
    load_jax_variables(model, init_params(
        cfg, torch.Generator().manual_seed(SEED)))
    want = {"concat": 37, "pair": 41}
    launches, readings = {}, {}
    for batch in (16, 8):
        blob = event_blob(cfg, batch)
        x = [torch.from_numpy(blob[k]).to(device)
             for k in ("coords", "values", "n_voxels")]
        if batch == 16:
            print(f"config 3 at batch 16: voxels/event "
                  f"{x[2].tolist()}")
        out = {}
        for mode in ("concat", "pair"):
            with mock.patch.dict(os.environ), torch.no_grad():
                os.environ.pop("URESNET_EVAL_PAIR", None)
                if mode == "pair":
                    os.environ["URESNET_EVAL_PAIR"] = "1"
                model(*x)                                # warm-up
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                reset_counts()
                torch.cuda.reset_peak_memory_stats()
                times, per = [], []
                for _ in range(3):
                    before = counts()
                    (logits, diag), t_ms = timed_call(lambda: model(*x))
                    times.append(t_ms)
                    per.append({k: v - before[k]
                                for k, v in counts().items()})
                peak = torch.cuda.max_memory_allocated()
                total = counts()
                if batch == 16 and mode == "pair":
                    with plain_versions():
                        plain, _ = model(*x)
                    torch.cuda.synchronize()
                    require(counts() == total,
                            "the plain-path forward launched a kernel")
            for i, got in enumerate(per):
                require((got["halo_conv"], got["halo_conv_dw"],
                         got["halo26_fwd"], got["halo26_bwd"])
                        == (want[mode], 0, 0, 0),
                        f"batch {batch} {mode} forward {i + 1}: launches "
                        f"{got}, expected {want[mode]} B and no C, D or E")
                require_a(9, got, f"batch {batch} {mode} forward {i + 1}")
            require(int(diag["overflow"]) == 0
                    and bool(torch.isfinite(logits).all()),
                    f"batch {batch} {mode}: overflow or non-finite logits")
            launches[f"eval_{mode}_b{batch}_3_forwards"] = total
            ms = sorted(times)[1]
            readings[batch, mode] = (ms, peak)
            out[mode] = logits
            print(f"batch {batch} eval {mode}: launches a forward "
                  f"{per[0]}; 3 runs {', '.join(f'{t:.1f}' for t in times)} "
                  f"ms, median {ms:.1f} ms = {batch / (ms / 1e3):.2f} "
                  f"events/s; peak memory {peak / 2**30:.2f} GiB")
        if batch == 16:
            valid = (torch.arange(cfg.max_voxels, device=device)[None]
                     < x[2][:, None])
            require(bool((out["pair"][~valid] == 0).all()),
                    "pair logits: nonzero padding")
            compare_logits(out["pair"], out["concat"], valid,
                           "batch 16 eval pair vs concat logits")
            compare_logits(out["pair"], plain, valid,
                           "batch 16 eval pair vs plain-path pair logits")
            del plain, valid
        del out, logits, x
        torch.cuda.empty_cache()
    for batch in (16, 8):
        (mc, pc), (mp, pp) = readings[batch, "concat"], readings[batch, "pair"]
        print(f"batch {batch}: pair / concat forward median {mp:.1f} / "
              f"{mc:.1f} ms, peak memory {pp / 2**30:.2f} / "
              f"{pc / 2**30:.2f} GiB"
              + (f" (phase 2, concat: {ms2:.1f} ms, {peak2 / 2**30:.2f} GiB)"
                 if batch == 8 else ""))
    return launches


def timer_phase(device, ms2: float, step_ms: float) -> None:
    """Phase 15: `utils.benchmark`, the port of the reference's timer:
    the config-3 forward (batch 8) with `timed_step`, its logits' sum
    chained into the next call's values (times 0, so the values stay
    exact), and the config-4 step (batch 2) through `TrainVal` with
    `timed_train`, beside phase 2's and phase 4's medians on CUDA events.
    No limit is set on either reading."""
    from uresnet_pytorch_tpu_torch.models import construct
    from uresnet_pytorch_tpu_torch.trainval import TrainVal
    from uresnet_pytorch_tpu_torch.utils.benchmark import (timed_step,
                                                           timed_train)
    from uresnet_pytorch_tpu_torch.utils.weights import (init_params,
                                                         load_jax_variables)
    cfg = config3()
    model = construct("uresnet_sparse")(cfg)
    load_jax_variables(model, init_params(
        cfg, torch.Generator().manual_seed(SEED)))
    coords, values, nv = events(cfg, device)

    def forward(chain, model, coords, values, nv):
        logits, _ = model(coords, values + chain * 0.0, nv)
        return logits.float().sum() * 1e-30

    with torch.no_grad():
        fwd_s = timed_step(forward, (model, coords, values, nv))
    del model, coords, values, nv
    torch.cuda.empty_cache()
    cfg4 = config4()
    tv = TrainVal(cfg4)
    tv.initialize(init_params(cfg4, torch.Generator().manual_seed(cfg4.seed)))
    step_s = timed_train(lambda tv_, b: (tv_, tv_.train_step(b)), tv,
                         event_blob(cfg4, BATCH4))
    require(tv.global_step == 12, f"timed_train took {tv.global_step} steps, "
            "expected 2 * (1 + 5)")
    print(f"utils.benchmark: config-3 forward {fwd_s * 1e3:.1f} ms a call "
          f"(timed_step, slope of 1 and 5 chained calls; phase 2's median "
          f"{ms2:.1f} ms on CUDA events); config-4 step "
          f"{step_s * 1e3:.1f} ms (timed_train; phase 4's median "
          f"{step_ms:.1f} ms)")
    del tv
    torch.cuda.empty_cache()



# phase 16: kernels norm_act_* (csrc/norm_act.cu) against their plain
# versions. Each kernel is fed what its plain version is fed (the apply and
# backward passes the kernels' own sums), so each is held alone:
# - the sums (stats, bwd reduce): f32 sums in another order over up to
#   ~1.7e7 rows, |delta| <= NORM_SUM_RTOL * the same sum of |terms| (n
#   exact);
# - the outputs (apply, bwd apply): one rounding to the output type at the
#   reference value, plus the f32 rounding of the pre-activation and of the
#   gradient's terms: the kernels form x a + b with an FMA and round once,
#   the plain version rounds each op. Where |v| lies within that rounding
#   of 0 the two can take act'(v) from opposite sides, so the input
#   gradient may differ there: at most NORM_FLIP_SHARE of its elements.
NORM_SUM_RTOL = 1e-5
NORM_FLIP_SHARE = 1e-6
# a config-3 forward in eval / a config-4 stage_dots step: 27 BN calls in
# eval (each block's bn_b runs in conv_a's epilogue), 45 in train, all
# recomputed; a train call is 2 launches (stats, apply), eval 1, backward 2
NORM_DENSE_SHAPE = (8, 128, 128, 128, 16)   # config 2's level 0, rows of C
NORM_FORWARD_LAUNCHES = 27
NORM_STEP_LAUNCHES = {"fwd": 2 * 45 * 2, "bwd": 2 * 45}
# the row-gather engine's: no conv epilogue takes a BN, so 45 in eval; its
# train step recomputes the blocks' 36 BNs (checkpoint), not the down, up
# and head BNs: 81 forward calls
NORM_GATHER_FORWARD_LAUNCHES = 45
NORM_GATHER_STEP_LAUNCHES = {"fwd": 2 * 81, "bwd": 2 * 45}


def norm_inputs(cfg, device) -> list:
    """(name, x, x2, mask, remask, slope) of every distinct BN input of a
    config-3 train forward at batch 8 on the card (`_bn_flat`'s real masks,
    re-masked; the second at a leaky slope), then the widths 12/36/60/256
    on level 0, 2 and 4's masks, level 0 in f32, the dense model's level 0
    in channels-last memory (bf16 and f32), and last every distinct BN
    input of the row-gather engine's train forward at config 3 and config
    4's batch (masked, no re-mask; the first at a leaky slope)."""
    from uresnet_pytorch_tpu_torch.models import construct
    from uresnet_pytorch_tpu_torch.models import uresnet_sparse_tiled as tiled
    seen, cases = set(), []
    real = tiled.norm_act

    def record_run(cfg, batch, prefix):
        """Runs a train forward of cfg's model at `batch`, appending each
        BN input it has not met."""
        def record(x, mask, *args, **kw):
            parts = x if isinstance(x, tuple) else (x,)
            key = (tuple(p.shape for p in parts), kw["remask"])
            if key not in seen:
                seen.add(key)
                widths = "+".join(str(p.shape[-1]) for p in parts)
                cases.append((f"{prefix}{widths} "
                              f"{tuple(parts[0].shape[:-1])}", parts[0],
                              parts[1] if len(parts) > 1 else None, mask,
                              kw["remask"], 0.0))
            return real(x, mask, *args, **kw)
        model = construct("uresnet_sparse")(cfg)
        blob = event_blob(cfg, batch)
        coords, values, nv = (torch.from_numpy(blob[k]).to(device)
                              for k in ("coords", "values", "n_voxels"))
        with torch.no_grad(), mock.patch.object(tiled, "norm_act", record):
            model(coords, values, nv, train=True)
    record_run(cfg, BATCH, "")
    tile = len(cases)
    by_rows = sorted({m.numel(): m for _, _, _, m, _, _ in cases}.items(),
                     reverse=True)
    gen = torch.Generator(device=device).manual_seed(SEED)
    masks = [m for _, m in by_rows]

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=device).to(dtype)
    for c, m in ((12, masks[0]), (36, masks[2]), (60, masks[-1]),
                 (256, masks[-1])):
        cases.append((f"width {c} {tuple(m.shape)}",
                      rand(m.shape + (c,), torch.bfloat16), None, m, True,
                      0.0))
    m0 = masks[0]
    cases.append((f"16 {tuple(m0.shape)} f32",
                  rand(m0.shape + (16,), torch.float32), None, m0, True, 0.0))
    for dtype in (torch.bfloat16, torch.float32):
        vol = rand(NORM_DENSE_SHAPE, dtype)   # channels-last bytes
        cases.append((f"dense 16 (8, 128^3) {str(dtype)[6:]}", vol, None,
                      None, False, 0.0))
    gather = len(cases)
    for c, batch in ((cfg, BATCH), (config4(), BATCH4)):
        record_run(dataclasses.replace(c, sparse_engine="gather"), batch,
                   f"gather b{batch} ")
    for i in (1, gather):   # a leaky slope on each engine's path
        cases[i] = cases[i][:5] + (0.1,)
    require(tile > 1 and len(cases) > gather,
            f"norm_inputs: {tile} tile-engine and {len(cases) - gather} "
            "row-gather BN inputs recorded")
    return cases


def check_norm(name, x, x2, mask, remask, slope, device) -> dict:
    """The four kernels at one shape (train: the sums from the rows, then
    apply, bwd reduce, bwd apply; eval: apply on running moments), each
    held to its plain version and timed on `device_ms` beside its byte
    bound, and the plain torch chain's forward and backward beside them.
    mask None: the dense BN (every row, f32
    coefficients); else the masked BN, re-masked (the tile engine) or not
    (the row-gather engine, whose output and input gradient are nonzero at
    inactive rows)."""
    from uresnet_pytorch_tpu_torch.ops.cuda import norm_act as na
    folded = mask is not None
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    parts = (x,) if x2 is None else (x, x2)
    C = sum(p.shape[-1] for p in parts)

    def vec(lo, hi):
        return lo + (hi - lo) * torch.rand(C, generator=gen, device=device)
    scale, bias = vec(0.5, 1.5), vec(-0.5, 0.5)
    run_mean, run_var = vec(-0.2, 0.2), vec(0.5, 2.0)
    dys = [torch.randn(p.shape, generator=gen, device=device).to(p.dtype)
           for p in parts]
    dy, dy2 = dys[0], dys[1] if x2 is not None else None
    es, rows = x.element_size(), x.numel() // x.shape[-1]
    act_rows = rows if mask is None else int(mask.sum())
    mask_b = 0 if mask is None else rows
    # the rows whose x (and dy) apply and the backward read: the active
    # ones under the re-mask, else every row
    read_rows = act_rows if remask else rows
    y = [torch.empty_like(p) for p in parts]
    dx = [torch.empty_like(p) for p in parts]
    stats = torch.empty(5, C, dtype=torch.float32, device=device)
    grads = torch.empty(4, C, dtype=torch.float32, device=device)
    eps = 1e-4
    y2, dx2 = (y[1], dx[1]) if x2 is not None else (None, None)

    def launch(kernel, train, out=None, out2=None, d=None, d2=None):
        na._launch(kernel, x, x2, d, d2, out, out2, mask, scale, bias,
                   run_mean, run_var, stats if train else None, grads,
                   slope, eps, train, folded, remask)
    launch(na.STATS, True)
    launch(na.APPLY, True, y[0], y2)
    launch(na.BWD_REDUCE, True, d=dy, d2=dy2)
    launch(na.BWD_APPLY, True, dx[0], dx2, dy, dy2)
    torch.cuda.synchronize()
    res = {}
    # stats
    sp = na.stats_plain(x, x2, mask)
    sabs = na.stats_plain(x.abs(), None if x2 is None else x2.abs(), mask)
    err = float(((stats[:2] - sp[:2]).abs() / sabs[:2].clamp(min=1e-30)).max())
    require(err <= NORM_SUM_RTOL and bool(torch.equal(stats[2], sp[2])),
            f"norm_act stats {name}: rel {err:.3e}, n {float(stats[2, 0])} "
            f"vs {float(sp[2, 0])}")
    res["stats"] = err
    mean, var, raw, cnt = na.moments_plain(stats[:3], run_mean, run_var, True)
    err_m = float(torch.maximum((stats[3] - mean).abs(),
                                (stats[4] - var).abs()).max())
    require(err_m <= 1e-6 * float(torch.maximum(mean.abs(), var).max())
            + 1e-30,
            f"norm_act moments {name}: {err_m:.3e}")
    sh, a, b, inv = na.coef_plain(mean, var, scale, bias, eps, folded,
                                  x.dtype)
    ulp = 2.0 ** -7 if x.dtype == torch.bfloat16 else 2.0 ** -23
    # apply
    yp = na.apply_plain(x, x2, mask, sh, a, b, slope, remask)
    worst = 0.0
    for p, got, ref, (sh_, a_, b_) in zip(parts, y, yp,
                                          na._slices(x, x2, sh, a, b)):
        slack = 2.0 ** -22 * ((p.float() - sh_).abs() * a_.abs() + b_.abs())
        d = (got.float() - ref.float()).abs()
        bad = int((d > ulp * ref.float().abs() + slack).sum())
        require(bad == 0, f"norm_act apply {name}: {bad} elements beyond "
                f"one rounding (max |d| {float(d.max()):.3e})")
        worst = max(worst, float(d.max()))
    res["apply"] = worst
    # bwd reduce: the sums, then d_scale and d_bias from them
    gp = na.bwd_reduce_plain(dy, dy2, x, x2, mask, sh, a, b, scale, mean,
                             inv, slope, remask, folded)
    gabs = []
    for p, d, (sh_, a_, b_) in zip(parts, dys, na._slices(x, x2, sh, a, b)):
        g, xf = na._grad_rows(d, p, mask, sh_, a_, b_, slope, remask)
        gabs.append(torch.stack([na._rows(g.abs()).sum(0),
                                 na._rows((g * (xf - sh_)).abs()).sum(0)]))
    gabs = torch.cat(gabs, 1)
    err = float(((grads[:2] - gp[:2]).abs() / gabs.clamp(min=1e-30)).max())
    gb, gx = grads[0], grads[1]
    d_scale = gx * inv + (-(gb * inv)) * mean if folded else gx * inv
    err_p = float(torch.maximum((grads[2] - d_scale).abs(),
                                (grads[3] - gb).abs()).max())
    require(err <= NORM_SUM_RTOL and err_p <= 1e-5 * float(
        d_scale.abs().max() + gb.abs().max()) + 1e-30,
        f"norm_act bwd reduce {name}: sums rel {err:.3e}, d_scale/d_bias "
        f"{err_p:.3e}")
    res["bwd_reduce"] = err
    # bwd apply on the kernel's sums
    c1, c2 = na.stat_grads_plain(grads, scale, mean, raw, cnt, inv, True,
                                 folded)
    dxp = na.bwd_apply_plain(dy, dy2, x, x2, mask, sh, a, b, c1, c2, slope,
                             remask)
    worst, flips = 0.0, 0
    for p, d_, got, ref, (a_, c1_, c2_) in zip(
            parts, dys, dx, dxp, na._slices(x, x2, a, c1, c2)):
        xf = p.float()
        slack = 2.0 ** -20 * (d_.float().abs() * a_.abs() + c1_.abs()
                              + (c2_ * xf).abs())
        d = (got.float() - ref.float()).abs()
        flips += int((d > ulp * ref.float().abs() + slack).sum())
        worst = max(worst, float(d.max()))
    require(flips <= NORM_FLIP_SHARE * sum(p.numel() for p in parts),
            f"norm_act bwd apply {name}: {flips} elements beyond one "
            f"rounding (max |d| {worst:.3e})")
    res["bwd_apply"], res["act_flips"] = worst, flips
    # eval apply on the running moments
    launch(na.APPLY, False, y[0], y2)
    mean_e, var_e, _, _ = na.moments_plain(None, run_mean, run_var, False)
    sh_e, a_e, b_e, _ = na.coef_plain(mean_e, var_e, scale, bias, eps,
                                      folded, x.dtype)
    yp = na.apply_plain(x, x2, mask, sh_e, a_e, b_e, slope, remask)
    for p, got, ref, (sh_, a_, b_) in zip(parts, y, yp,
                                          na._slices(x, x2, sh_e, a_e, b_e)):
        slack = 2.0 ** -22 * ((p.float() - sh_).abs() * a_.abs() + b_.abs())
        bad = int(((got.float() - ref.float()).abs()
                   > ulp * ref.float().abs() + slack).sum())
        require(bad == 0, f"norm_act eval apply {name}: {bad} elements")
    # times beside the byte bounds: the mask byte of each row (where it is
    # read), each active row's x (and dy) once, every output once
    row_b = C * es
    nbytes = {"stats": mask_b + act_rows * row_b,
              "apply": mask_b * remask + read_rows * row_b + rows * row_b,
              "apply_eval": mask_b * remask + read_rows * row_b
              + rows * row_b,
              "bwd_reduce": mask_b * remask + 2 * read_rows * row_b,
              "bwd_apply": mask_b + 2 * read_rows * row_b + rows * row_b}
    calls = {"stats": lambda: launch(na.STATS, True),
             "apply": lambda: launch(na.APPLY, True, y[0], y2),
             "apply_eval": lambda: launch(na.APPLY, False, y[0], y2),
             "bwd_reduce": lambda: launch(na.BWD_REDUCE, True, d=dy, d2=dy2),
             "bwd_apply": lambda: launch(na.BWD_APPLY, True, dx[0], dx2, dy,
                                         dy2)}
    res["ms"] = {k: device_ms(fn, launches=20) for k, fn in calls.items()}
    res["bound_ms"] = {k: v / PEAK_BYTES * 1e3 for k, v in nbytes.items()}
    # the plain torch chain the models ran, forward and forward + backward
    leaves = [p.detach().requires_grad_() for p in parts]
    sc, bi = scale.detach().requires_grad_(), bias.detach().requires_grad_()
    xin = tuple(leaves) if x2 is not None else leaves[0]
    if mask is None:   # the dense model's (B, C, *S) view of the rows
        xin = leaves[0].movedim(-1, 1)

    def chain():
        out, _ = na.chain_plain(xin, mask, sc, bi, run_mean, run_var,
                                train=True, remask=remask, folded=folded,
                                slope=slope, eps=eps, dtype=x.dtype,
                                cdim=-1 if folded else 1)
        return out if isinstance(out, tuple) else (out,)

    def chain_bwd():
        outs = chain()
        torch.autograd.grad(outs, leaves + [sc, bi],
                            [d if o.shape == d.shape else d.movedim(-1, 1)
                             for o, d in zip(outs, dys)])
    res["chain_fwd_ms"] = time_ms(chain, iters=3)
    res["chain_fwd_bwd_ms"] = time_ms(chain_bwd, iters=3)
    res["kernel_fwd_ms"] = res["ms"]["stats"] + res["ms"]["apply"]
    res["kernel_fwd_bwd_ms"] = res["kernel_fwd_ms"] + res["ms"][
        "bwd_reduce"] + res["ms"]["bwd_apply"]
    res["active_rows"], res["rows"] = act_rows, rows
    print(f"norm_act {name}{'' if remask or mask is None else ' (no re-mask)'}"
          f": {act_rows}/{rows} rows active; max |d| stats "
          f"rel {res['stats']:.2e}, apply {res['apply']:.2e}, bwd reduce "
          f"rel {res['bwd_reduce']:.2e}, bwd apply {res['bwd_apply']:.2e} "
          f"({flips} act' flips); ms (bound): "
          + ", ".join(f"{k} {v:.4f} ({res['bound_ms'][k]:.4f})"
                      for k, v in res["ms"].items())
          + f"; kernels fwd {res['kernel_fwd_ms']:.3f} / fwd+bwd "
          f"{res['kernel_fwd_bwd_ms']:.3f} ms vs the plain chain "
          f"{res['chain_fwd_ms']:.3f} / {res['chain_fwd_bwd_ms']:.3f} ms")
    return res


def norm_act_phase(cfg, device) -> dict:
    """Phase 16: the BN kernels at every BN shape of the config-3 train
    forward, the other widths, dtypes, the dense volume and the row-gather
    engine's inputs (`norm_inputs`, `check_norm`), then the kernels'
    refusal of a volume whose channels are not contiguous. Returns the
    results by case."""
    from uresnet_pytorch_tpu_torch.ops.cuda import norm_act as na
    out = {}
    for name, x, x2, mask, remask, slope in norm_inputs(cfg, device):
        out[name] = check_norm(name, x, x2, mask, remask, slope, device)
        torch.cuda.empty_cache()
    C = 16
    vol = torch.randn(2, C, 8, 8, 8, device=device).to(torch.bfloat16)
    ones, zeros = (torch.ones(C, device=device),
                   torch.zeros(C, device=device))
    try:
        na.norm_act(vol, None, ones, zeros, zeros, ones, train=True,
                    remask=False, folded=False, slope=0.0, eps=1e-4,
                    dtype=torch.bfloat16, cdim=1)
        refused = False
    except ValueError:
        refused = True
    require(refused, "norm_act took a (B, C, *S) volume in contiguous "
            "memory on the card: the kernels need channels-last")
    return out


# phase 17: MinkUNet34C
def config_mink(batch: int):
    """The benchmark's MinkUNet34C configuration at `batch`: the `model`
    block of perfbench/configs/minkunet34c_512.json, as the benchmark
    builds it."""
    from uresnet_pytorch_tpu_torch.config import URESNetConfig
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "perfbench", "configs", "minkunet34c_512.json")
    with open(path) as f:
        model = json.load(f)["model"]
    return URESNetConfig(**model, batch_size=batch)


def check_norm_residual(name, x, mask, slope, device) -> dict:
    """`norm_act` with a residual r at one shape, as `check_norm` holds the
    kernels without one: the train forward (`norm_act._forward`, r given)
    against its plain version; the backward's sums (bwd reduce with r)
    against the plain sums, allowing for each element whose pre-activation
    lies within rounding of 0 (act' may flip there) its whole term; d_x and
    d_r of the backward (`norm_act._backward`) against the plain bwd apply
    on the kernel's sums, within one rounding but for `NORM_FLIP_SHARE` of
    the elements; d_scale and d_bias the kernel's sums turned into them.
    Then the three kernels that read r timed with and without it."""
    from uresnet_pytorch_tpu_torch.ops.cuda import norm_act as na
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    C = x.shape[-1]
    eps = 1e-5

    def vec(lo, hi):
        return lo + (hi - lo) * torch.rand(C, generator=gen, device=device)
    scale, bias = vec(0.5, 1.5), vec(-0.5, 0.5)
    run_mean, run_var = vec(-0.2, 0.2), vec(0.5, 2.0)
    r = torch.randn(x.shape, generator=gen, device=device).to(x.dtype)
    dy = torch.randn(x.shape, generator=gen, device=device).to(x.dtype)
    flags = (True, True, True, slope, eps, 0)    # train, remask, folded
    y, _, stats = na._forward(x, None, mask, scale, bias, run_mean, run_var,
                              *flags, r)
    yp, _, sp = na._forward_plain(x, None, mask, scale, bias, run_mean,
                                  run_var, *flags, r)
    dx, _, dsc, dbi, dr = na._backward(dy, None, x, None, mask, scale, bias,
                                       run_mean, run_var, stats, *flags, r)
    grads = torch.empty(4, C, dtype=torch.float32, device=device)
    na._launch(na.BWD_REDUCE, x, None, dy, None, None, None, mask, scale,
               bias, run_mean, run_var, stats, grads, slope, eps, True, True,
               True, r)
    torch.cuda.synchronize()
    ulp = 2.0 ** -7 if x.dtype == torch.bfloat16 else 2.0 ** -23
    res = {}
    err_s = float((stats[:2] - sp[:2]).abs().max()
                  / sp[:2].abs().max().clamp(min=1e-30))
    require(err_s <= NORM_SUM_RTOL, f"norm_act with r {name}: stats {err_s}")
    mean, var, raw, cnt = na.moments_plain(stats[:3], run_mean, run_var,
                                           True)
    sh, a, b, inv = na.coef_plain(mean, var, scale, bias, eps, True, x.dtype)
    # y: one rounding of the plain version's
    d = (y.float() - yp.float()).abs()
    # the kernel rounds fma(x, a, b) + r twice, the plain version x a, + b,
    # + r three times: a few f32 ulps of the terms apart
    slack = 2.0 ** -20 * (x.float().abs() * a.abs() + b.abs()
                          + r.float().abs())
    bad = int((d > ulp * yp.float().abs() + slack).sum())
    require(bad == 0, f"norm_act with r {name} y: {bad} elements beyond one "
            f"rounding (max |d| {float(d.max()):.3e})")
    res["y"] = float(d.max())
    del d, slack
    # the backward's sums, an element near v = 0 free to flip
    gp = na.bwd_reduce_plain(dy, None, x, None, mask, sh, a, b, scale, mean,
                             inv, slope, True, True, r)
    g, xf = na._grad_rows(dy, x, mask, sh, a, b, slope, True, r)
    v = na._pre(xf, sh, a, b, r)
    near = ((v.abs() <= 2.0 ** -20 * ((xf - sh).abs() * a.abs() + b.abs()
                                      + r.float().abs()))
            & mask[..., None]).float()
    dyf = dy.float()
    gabs = torch.stack([na._rows(g.abs()).sum(0),
                        na._rows((g * (xf - sh)).abs()).sum(0)])
    amb = torch.stack([na._rows(dyf.abs() * near).sum(0),
                       na._rows((dyf * (xf - sh)).abs() * near).sum(0)])
    res["near_zero"] = int(near.sum())
    del g, v, near, dyf
    off = (grads[:2] - gp[:2]).abs() - amb
    require(bool((off <= NORM_SUM_RTOL * gabs).all()),
            f"norm_act with r {name}: backward sums beyond rounding and "
            f"act' flips ({float((off / gabs.clamp(min=1e-30)).max()):.3e})")
    res["sums"] = float(((grads[:2] - gp[:2]).abs()
                         / gabs.clamp(min=1e-30)).max())
    require(torch.equal(dsc, grads[2]) and torch.equal(dbi, grads[3]),
            f"norm_act with r {name}: d_scale, d_bias not the kernel's sums")
    # d_x and d_r on the kernel's sums
    c1, c2 = na.stat_grads_plain(grads, scale, mean, raw, cnt, inv, True,
                                 True)
    dxp, drp = na.bwd_apply_plain(dy, None, x, None, mask, sh, a, b, c1, c2,
                                  slope, True, r)
    for what, got, ref, slack in (
            ("dx", dx, dxp, 2.0 ** -20 * (dy.float().abs() * a.abs()
                                          + c1.abs()
                                          + (c2 * x.float()).abs())),
            ("d_r", dr, drp, 2.0 ** -22 * dy.float().abs())):
        d = (got.float() - ref.float()).abs()
        bad = int((d > ulp * ref.float().abs() + slack).sum())
        require(bad <= NORM_FLIP_SHARE * d.numel(),
                f"norm_act with r {name} {what}: {bad} elements beyond one "
                f"rounding (max |d| {float(d.max()):.3e})")
        res[what] = float(d.max())
        del d, slack
    require(not bool(dr[~mask].any()) and not bool(y[~mask].any()),
            f"norm_act with r {name}: an inactive row holds a nonzero")
    out_y = torch.empty_like(x)
    out_dx, out_dr = torch.empty_like(x), torch.empty_like(x)

    def launch(kernel, rr, out=None, d=None, drr=None):
        na._launch(kernel, x, None, d, None, out, None, mask, scale, bias,
                   run_mean, run_var, stats, grads, slope, eps, True, True,
                   True, rr, drr)
    ms = {}
    for tag, rr, drr in (("with r", r, out_dr), ("without r", None, None)):
        ms[tag] = {
            "apply": device_ms(lambda: launch(na.APPLY, rr, out_y),
                               launches=20),
            "bwd_reduce": device_ms(lambda: launch(na.BWD_REDUCE, rr,
                                                   d=dy), launches=20),
            "bwd_apply": device_ms(lambda: launch(na.BWD_APPLY, rr, out_dx,
                                                  dy, drr), launches=20)}
    act = int(mask.sum())
    row_b = C * x.element_size()
    bound_ms = {k: v / PEAK_BYTES * 1e3 for k, v in {
        "apply": mask.numel() + act * 2 * row_b + x.numel() // C * row_b,
        "bwd_reduce": mask.numel() + act * 3 * row_b,
        "bwd_apply": mask.numel() + act * 3 * row_b
        + 2 * (x.numel() // C) * row_b}.items()}
    res["ms"], res["bound_ms"] = ms, bound_ms
    print(f"norm_act with r {name} slope {slope}: {act}/{mask.numel()} rows "
          f"active; max |d| y {res['y']:.2e}, dx {res['dx']:.2e}, d_r "
          f"{res['d_r']:.2e}; sums rel {res['sums']:.2e} "
          f"({res['near_zero']} pre-activations within rounding of 0); ms "
          f"with r (bound) / without r: "
          + ", ".join(f"{k} {ms['with r'][k]:.4f} ({bound_ms[k]:.4f}) / "
                      f"{ms['without r'][k]:.4f}" for k in bound_ms))
    return res


def mink_phase(device, counts) -> dict:
    """Phase 17: MinkUNet34C's new kernel paths, then the whole model
    against the plain versions at its published widths (see the module's
    docstring). Returns the readings by name."""
    from uresnet_pytorch_tpu_torch.models import construct
    from uresnet_pytorch_tpu_torch.ops.cuda import halo_conv as hc_mod
    from uresnet_pytorch_tpu_torch.ops.tile_graph import build_tile_graph
    from uresnet_pytorch_tpu_torch.trainval import TrainVal
    from uresnet_pytorch_tpu_torch.utils.weights import init_params
    out = {}
    cfg8 = config_mink(BATCH)
    blob8 = event_blob(cfg8, BATCH)
    args8 = [torch.from_numpy(blob8[k]).to(device)
             for k in ("coords", "values", "n_voxels")]
    with torch.no_grad():
        graph = build_tile_graph(*args8, cfg8)
    masks = []
    for lev in graph.levels:
        rows = torch.arange(lev.keys.shape[1], device=device)
        masks.append((lev.occ & (rows[None] < lev.num[:, None])[..., None])
                     .contiguous())
    gen = torch.Generator(device=device).manual_seed(SEED)
    # (a) the BN operator with a residual at level 0's 96 and level 4's 256
    # (level 0 in f32 on the batch's first half: nine such tensors of the
    # whole batch do not fit beside the comparison's)
    for level, C in ((0, 96), (4, 256)):
        for dtype in (torch.bfloat16, torch.float32):
            m = masks[level]
            if level == 0 and dtype == torch.float32:
                m = m[:BATCH // 2].contiguous()
            x = (torch.randn(m.shape + (C,), generator=gen, device=device)
                 * m[..., None]).to(dtype)
            for slope in (0.0, 1.0):
                name = f"L{level} C={C} {str(dtype)[6:]}"
                out[f"norm_act_r {name} s{slope}"] = check_norm_residual(
                    name, x, m, slope, device)
            del x
            torch.cuda.empty_cache()
    # (b) kernels D and E at a halo of 2
    for name, level, t, c, dtype in (
            ("h=2 L0 t=4 C=1", 0, 4, 1, torch.bfloat16),
            ("h=2 L0 t=4 C=1 f32", 0, 4, 1, torch.float32),
            ("h=2 L0 t=4 C=32", 0, 4, 32, torch.bfloat16),
            ("h=2 L1 t=2 C=32", 1, 2, 32, torch.bfloat16)):
        out[f"extend {name}"] = check_extend(
            name, graph.levels[level].halo, t, c, dtype, gen, device,
            timed=False, h=2)
    del graph, masks
    torch.cuda.empty_cache()
    # (c) kernel B's wide path at every shape of the model that takes it,
    # forward (raw and with the epilogue) and d_x, beside D + cuDNN
    with torch.no_grad():
        graph = build_tile_graph(*args8, cfg8)
    rng = np.random.default_rng(SEED + 17)
    for name, level, t, cin, cout in MINK_B:
        lev = graph.levels[level]
        out[f"halo_conv {name}"] = check_halo_conv(name, lev, t, cin, cout,
                                                   rng, device, unfused=True)
        torch.cuda.empty_cache()
        out[f"halo_conv d_x {name}"] = check_dx(name, lev, t, cin, cout, rng,
                                                device, unfused=True)
        torch.cuda.empty_cache()
    del graph
    torch.cuda.empty_cache()
    # (d) the whole model on one 512^3 batch against the plain versions
    cfg = config_mink(BATCH4)
    blob = event_blob(cfg, BATCH4)
    args = [torch.from_numpy(blob[k]).to(device)
            for k in ("coords", "values", "n_voxels")]
    variables = init_params(cfg, torch.Generator().manual_seed(SEED))
    tv = TrainVal(cfg)
    tv.initialize(variables)
    with torch.no_grad():
        got, _ = tv.model(*args)
        with plain_versions():
            ref, _ = tv.model(*args)
    torch.cuda.synchronize()
    rows = torch.arange(cfg.max_voxels, device=device)
    valid = rows[None] < args[2][:, None]
    compare_logits(got, ref, valid, "minkunet34c eval logits, kernels vs "
                   "plain")
    del tv, got, ref
    torch.cuda.empty_cache()
    compare_step(cfg, variables, blob, counts, "minkunet34c")
    torch.cuda.empty_cache()
    # launches of one stage_dots step and timed steps at batch 8
    tv = TrainVal(cfg8)
    tv.initialize(init_params(cfg8, torch.Generator().manual_seed(SEED)))
    tv.train_step(blob8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    before, wide = counts(), hc_mod.launches_wide
    losses, ms = [], []
    for _ in range(3):
        met, t_ms = timed_call(lambda: tv.train_step(blob8))
        losses.append(float(met["loss"]))
        ms.append(t_ms)
    after = counts()
    per_step = {k: (after[k] - before[k]) / 3 for k in after}
    per_step["halo_conv_wide"] = (hc_mod.launches_wide - wide) / 3
    require(per_step["halo_conv"] == 100
            and per_step["halo_conv_wide"] == MINK_STEP_WIDE,
            f"minkunet34c: expected 100 kernel-B launches a step, "
            f"{MINK_STEP_WIDE} of them wide, got {per_step}")
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    require(all(np.isfinite(losses)), f"minkunet34c losses {losses}")
    print(f"minkunet34c batch {BATCH} stage_dots: step ms {ms}, losses "
          f"{losses}, peak {peak:.2f} GiB; kernel launches a step "
          f"{per_step}")
    out["step"] = {"ms": ms, "losses": losses, "peak_gib": peak,
                   "launches": per_step}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.stdout.reconfigure(line_buffering=True)   # a cut run keeps its lines
    from uresnet_pytorch_tpu_torch.models import construct
    from uresnet_pytorch_tpu_torch.ops import cuda
    from uresnet_pytorch_tpu_torch.ops.cuda import halo_conv_dw as dw_mod
    from uresnet_pytorch_tpu_torch.ops.cuda import halo_extend as he_mod
    from uresnet_pytorch_tpu_torch.ops.cuda import norm_act as na_mod
    from uresnet_pytorch_tpu_torch.ops.cuda import windowed_gather as wg_mod
    from uresnet_pytorch_tpu_torch.ops.tile_graph import build_tile_graph
    from uresnet_pytorch_tpu_torch.trainval import TrainVal
    from uresnet_pytorch_tpu_torch.utils.weights import (init_params,
                                                         load_jax_variables)
    counters = counter_modules()

    def reset_counts():
        for m, attr in counters.values():
            setattr(m, attr, 0)
        dw_mod.launches_by_shape.clear()
        he_mod.launches_by_shape_fwd.clear()
        he_mod.launches_by_shape_bwd.clear()
        wg_mod.launches_by_op.update(dict.fromkeys(wg_mod.launches_by_op, 0))
        na_mod.launches_fwd = na_mod.launches_bwd = 0

    def norm_launches():
        return {"fwd": na_mod.launches_fwd, "bwd": na_mod.launches_bwd}

    def require_a(n: int, got: dict, what: str) -> None:
        """Kernel A launches once a link op: the graph build's occupancy
        assemble, and each down and up link, at links 1-3."""
        require(got["windowed_gather"] == n,
                f"expected {n} kernel-A launches in {what}, got "
                f"{got['windowed_gather']} ({dict(wg_mod.launches_by_op)})")

    counts = kernel_counts

    def extend_by_shape():
        """Kernel D's and E's launches by (t, dim, C, dtype) since the
        counts were last set to 0."""
        return {"D": dict(he_mod.launches_by_shape_fwd),
                "E": dict(he_mod.launches_by_shape_bwd)}

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    lib = cuda.build()
    print(f"kernels built: {lib.name} in {time.perf_counter() - t0:.1f} s")

    if "--mink" in sys.argv[1:]:
        # phase 17 alone
        mink = mink_phase(device, counts)
        print(f"chip_smoke --mink: {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"mink": mink}, default=str))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    cfg = config3()
    coords, values, nv = events(cfg, device)
    print(f"config 3: batch {BATCH}, voxels/event {nv.tolist()}")

    # -- phase 1: kernels A and B against their plain versions ------------
    rng = np.random.default_rng(SEED)
    with torch.no_grad():
        graph = build_tile_graph(coords, values, nv, cfg)
    lv = graph.levels
    print("tile rows per level:", [tuple(l.keys.shape) for l in lv],
          "live:", [int(l.num.max()) for l in lv])
    # every conv shape class of the path: the stem (Cin 1, packed into the
    # MMA depth), square blocks at t=4 and at each t=2 level, and the
    # decoder's first conv after the skip concat (Cin = 2 Cout) at L0 and
    # L3 (27x128x64 is the largest weight stack)
    halo_res = {name: check_halo_conv(name, lv[l], t, ci, co, rng, device)
                for name, l, t, ci, co in (
                    ("L0 t=4 16->16", 0, 4, 16, 16),
                    ("stem L0 t=4 1->16", 0, 4, 1, 16),
                    ("dec L0 t=4 32->16", 0, 4, 32, 16),
                    ("L1 t=2 32->32", 1, 2, 32, 32),
                    ("L2 t=2 48->48", 2, 2, 48, 48),
                    ("dec L3 t=2 128->64", 3, 2, 128, 64),
                    ("L4 t=2 80->80", 4, 2, 80, 80))}
    print("halo_conv per shape (bn_act ms, plain ms, bound ms): " + "; ".join(
        f"{k} {r[1]:.3f} / {r[2]:.3f} / {r[3]:.4f}"
        for k, r in halo_res.items()))
    width_b = {name: check_halo_conv(name, lv[l], t, ci, co, rng, device,
                                     unfused=True)
               for name, l, t, ci, co in WIDTH_B}
    # kernel A: the single-spec gather (one octant) at link 1, levels 1 ->
    # 2 (link 0 is the identity of the 4 -> 2 tile halving); both link
    # directions at links 1-3 at the widths the path moves (the graph
    # build's occupancy 1; the encoder's and decoder's 48, 64, 80), and in
    # float32 (the card's f32 path); at a t_c=4 link of a global t=4 graph
    # of the same events; at t_c=2 and t_c=4 links of 2D graphs
    link = graph.links[1]
    Tf, Tc = lv[1].keys.shape[1], lv[2].keys.shape[1]
    gather_res = {"link1 child[0] F=48": check_gather(
        "link1 child[0] F=48", link.children[0], Tf, 48, rng, device),
        "link1 parent[0] F=48": check_gather(
            "link1 parent[0] F=48", link.parents[0], Tc * 8, 48, rng,
            device)}
    link_checks = [(f"link{l} {op} C={c}", graph.links[l], op, 2, 3, c,
                    torch.bfloat16)
                   for l, w in ((1, 48), (2, 64), (3, 80))
                   for op, c in (("assemble", 1), ("assemble", w),
                                 ("parent", 1), ("parent", w))]
    link_checks += [(f"link1 {op} C=48 f32", link, op, 2, 3, 48,
                     torch.float32) for op in ("assemble", "parent")]
    del lv
    with torch.no_grad():
        links4 = build_tile_graph(coords, values, nv, dataclasses.replace(
            cfg, tile_sizes=None)).links
    link_checks += [(f"t=4 link1 {op} C={c}", links4[1], op, 4, 3, c,
                     torch.bfloat16)
                    for op, c in (("assemble", 1), ("assemble", 48),
                                  ("parent", 48))]
    for tiles in ((4, 2, 2, 2, 2), None):
        cfg2 = dataclasses.replace(cfg, data_dim=2, tile_sizes=tiles,
                                   max_voxels=16384)
        blob2 = event_blob(cfg2, 2, mean_voxels=12000)
        with torch.no_grad():
            link2 = build_tile_graph(*(torch.from_numpy(blob2[k]).to(device)
                                       for k in ("coords", "values",
                                                 "n_voxels")), cfg2).links[1]
        t_c = 2 if tiles else 4
        link_checks += [(f"2d t=4 link1 {op} C=16" if t_c == 4 else
                         f"2d link1 {op} C=16", link2, op, t_c, 2, 16,
                         torch.bfloat16) for op in ("assemble", "parent")]
    link_res = {name: check_link(name, lk, op, t_c, d, c, rng, device, dt)
                for name, lk, op, t_c, d, c, dt in link_checks}
    del graph, link, links4, link2, link_checks

    # -- phase 2: config-3 inference through the model entry point ---------
    variables = init_params(cfg, torch.Generator().manual_seed(SEED))
    model = construct("uresnet_sparse")(cfg)
    load_jax_variables(model, variables)
    with torch.no_grad():
        model(coords, values, nv)                     # warm-up
        profile_run(lambda: model(coords, values, nv),
                    "fused config-3 forward", top=8)
        torch.cuda.synchronize()
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            logits, diag = model(coords, values, nv)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        infer_launches = counts()
        infer_norm = norm_launches()
        peak = torch.cuda.max_memory_allocated()
    print(f"launches in 3 forwards: {infer_launches}; norm_act {infer_norm}")
    require(infer_norm == {"fwd": NORM_FORWARD_LAUNCHES * 3, "bwd": 0},
            f"expected {NORM_FORWARD_LAUNCHES} norm_act launches per eval "
            f"forward, got {infer_norm} in 3")
    require(infer_launches["halo_conv"] == 37 * 3,
            f"expected 37 halo_conv launches per forward, got "
            f"{infer_launches['halo_conv']} in 3")
    print(f"kernel A by entry point: {dict(wg_mod.launches_by_op)}")
    require_a(9 * 3, infer_launches, "3 forwards (3 occupancy + 3 down + "
              "3 up a forward)")
    require(infer_launches["halo_conv_dw"] == 0,
            "inference launched the weight-gradient kernel")
    diag = {k: int(v) for k, v in diag.items()}
    print(f"diag: {diag}")
    require(diag["overflow"] == 0, "graph overflow")
    require(tuple(logits.shape) == (BATCH, cfg.max_voxels, cfg.num_class),
            f"logits shape {tuple(logits.shape)}")
    require(bool(torch.isfinite(logits).all()), "non-finite logits")
    pad = torch.arange(cfg.max_voxels, device=device)[None] >= nv[:, None]
    require(bool((logits[pad] == 0).all()), "padding rows not zero")
    ms = sorted(times)[1]
    print(f"forward (graph build included), 3 runs: "
          f"{', '.join(f'{t:.1f}' for t in times)} ms; median {ms:.1f} ms = "
          f"{BATCH / (ms / 1e3):.2f} events/s; peak memory "
          f"{peak / 2**30:.2f} GiB")

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with plain_versions(), torch.no_grad():
        start.record()
        ref, _ = model(coords, values, nv)
        end.record()
        torch.cuda.synchronize()
    print(f"plain-path forward: {start.elapsed_time(end):.1f} ms")
    require(counts() == infer_launches,
            "the plain-path forward launched a kernel")
    compare_logits(logits, ref, ~pad, "kernel vs plain logits")
    del model, logits, ref, coords, values, nv, pad
    torch.cuda.empty_cache()

    # -- phase 3: the backward's kernels on config 4's halo maps -----------
    cfg4 = config4()
    blob = event_blob(cfg4, BATCH4)
    print(f"config 4: batch {BATCH4}, voxels/event "
          f"{blob['n_voxels'].tolist()}, remat_mode {cfg4.remat_mode}")
    with torch.no_grad():
        graph = build_tile_graph(
            *(torch.from_numpy(blob[k]).to(device)
              for k in ("coords", "values", "n_voxels")), cfg4)
    lv = graph.levels
    print("tile rows per level:", [tuple(l.keys.shape) for l in lv],
          "live:", [int(l.num.max()) for l in lv])
    # each weight-gradient shape of the step (the decoder's first conv_a
    # runs as a pair of convs against the halves of its (2C, C) stack);
    # its launches per step are counted in phase 4
    dw_shapes = [("stem L0 t=4 1->16", 0, 4, 1, 16),
                 ("L0 t=4 16->16", 0, 4, 16, 16),
                 ("L1 t=2 32->32", 1, 2, 32, 32),
                 ("L2 t=2 48->48", 2, 2, 48, 48),
                 ("dec pair half L3 t=2 64->64", 3, 2, 64, 64),
                 ("L4 t=2 80->80", 4, 2, 80, 80)]
    dw_res = {name: check_dw(name, lv[l], t, ci, co, rng, device)
              for name, l, t, ci, co in dw_shapes}
    print("halo_conv_dw per shape (ms): " + "; ".join(
        f"{name} {dw_res[name][1]:.3f}" for name, *_ in dw_shapes))
    # branches of kernels B and C that the step above does not reach but
    # that the shape rule sends them at other widths and tile sizes
    # (uresnet_filters=32 and width_ramp="geometric": L3 128->128, two Cout
    # slices; tile_size=8: chunks of one 512-cell tile), and C's packed
    # path with 16-byte staging (1 < Cin < 16, Cin a multiple of 8)
    cfg8 = dataclasses.replace(cfg4, tile_size=8, tile_sizes=None)
    with torch.no_grad():
        lv8 = build_tile_graph(
            *(torch.from_numpy(blob[k]).to(device)
              for k in ("coords", "values", "n_voxels")), cfg8).levels
    dw_branch = {name: check_dw(name, level, t, ci, co, rng, device)
                 for name, level, t, ci, co in (
                     ("L3 t=2 128->128", lv[3], 2, 128, 128),
                     ("L0 t=4 8->8", lv[0], 4, 8, 8),
                     ("tile_size=8 L0 t=8 16->16", lv8[0], 8, 16, 16))}
    b_branch = {name: check_halo_conv(name, level, t, ci, co, rng, device)
                for name, level, t, ci, co in (
                    ("L3 t=2 128->128", lv[3], 2, 128, 128),
                    ("tile_size=8 L0 t=8 16->16", lv8[0], 8, 16, 16))}
    width_b.update({name: check_halo_conv(name, lv8[l], t, ci, co, rng,
                                          device, unfused=True)
                    for name, l, t, ci, co in WIDTH_T8})
    width_dw8 = {name: check_dw(name, lv8[l], t, ci, co, rng, device,
                                unfused=True)
                 for name, l, t, ci, co in WIDTH_T8}
    del lv8
    dx_res = {"d_x L0 t=4 16->16": check_dx("L0 t=4 16->16", lv[0], 4, 16,
                                            16, rng, device),
              "d_x L4 t=2 80->80": check_dx("L4 t=2 80->80", lv[4], 2, 80,
                                            80, rng, device)}
    width_dw = {name: check_dw(name, lv[l], t, ci, co, rng, device,
                               unfused=True)
                for name, l, t, ci, co in WIDTH_DW}
    width_dw.update(width_dw8)
    width_dx = {f"d_x {name}": check_dx(name, lv[l], t, ci, co, rng, device,
                                        unfused=True)
                for name, l, t, ci, co in WIDTH_DX}
    del graph, lv

    # -- phase 4: config-4 training through TrainVal -----------------------
    variables = init_params(cfg4, torch.Generator().manual_seed(cfg4.seed))
    compare_step(cfg4, variables, blob, counts, "kernel vs plain")

    tv = TrainVal(cfg4)
    tv.initialize(variables)
    torch.cuda.synchronize()
    reset_counts()
    losses, _, _ = timed_steps(tv, blob, 1, 0)
    train_launches = counts()
    train_norm = norm_launches()
    dw_launches = dict(dw_mod.launches_by_shape)
    print(f"launches in one stage_dots step: {train_launches}; norm_act "
          f"{train_norm}")
    require(train_norm == NORM_STEP_LAUNCHES,
            f"expected norm_act launches {NORM_STEP_LAUNCHES} per step (45 "
            f"BN calls, each recomputed), got {train_norm}")
    # kernel C's launches of that step by shape, as its wrapper counted
    # them: every shape timed in phase 3, and only those
    require(set(dw_launches) == {(t, ci, co) for _, _, t, ci, co
                                 in dw_shapes},
            f"kernel C launched at (t, Cin, Cout) {sorted(dw_launches)} in "
            f"the step, phase 3 timed {[s[2:] for s in dw_shapes]}")
    dw_per_step = {name: dw_launches[(t, ci, co)]
                   for name, _, t, ci, co in dw_shapes}
    dw_step_ms = sum(dw_res[name][1] * n for name, n in dw_per_step.items())
    print("halo_conv_dw per shape (ms x launches counted in the step): "
          + "; ".join(f"{name} {dw_res[name][1]:.3f} x {n}"
                      for name, n in dw_per_step.items())
          + f"; sum {dw_step_ms:.3f} ms per config-4 step")
    require(train_launches["halo_conv"] == 81,
            f"expected 81 halo_conv launches per step (41 forward + 40 "
            f"d_x), got {train_launches['halo_conv']}")
    require(train_launches["halo_conv_dw"] == 41,
            f"expected 41 halo_conv_dw launches per step, got "
            f"{train_launches['halo_conv_dw']}")
    require_a(21, train_launches, "the step (9 forward, 6 recomputed, 6 "
              "backward)")
    torch.cuda.reset_peak_memory_stats()
    more, times, metrics = timed_steps(tv, blob, 1, 3)
    peak_dots = torch.cuda.max_memory_allocated()
    losses += more
    print(f"losses of 5 steps on one batch: "
          f"{', '.join(f'{l:.6f}' for l in losses)}")
    require(all(np.isfinite(losses)), "non-finite training loss")
    require(losses[-1] < losses[0], "the loss did not fall in 5 steps")
    print(f"step counters: overflow {int(metrics['overflow'])}, tile_spill "
          f"{int(metrics['tile_spill'])}, vox_spill "
          f"{int(metrics['vox_spill'])}")
    require(int(metrics["overflow"]) == 0, "graph overflow in training")
    step_ms = sorted(times)[1]
    print(f"train step (graph build and Adam included), 3 runs after 2 "
          f"warm-ups: {', '.join(f'{t:.1f}' for t in times)} ms; median "
          f"{step_ms:.1f} ms = {BATCH4 / (step_ms / 1e3):.3f} events/s; "
          f"peak memory {peak_dots / 2**30:.2f} GiB (stage_dots)")
    profile_run(lambda: tv.train_step(blob), "step")
    del tv
    torch.cuda.empty_cache()

    tv_none = TrainVal(dataclasses.replace(cfg4, remat_mode="none"))
    tv_none.initialize(variables)
    timed_steps(tv_none, blob, 1, 0)
    torch.cuda.reset_peak_memory_stats()
    _, none_times, _ = timed_steps(tv_none, blob, 0, 1)
    peak_none = torch.cuda.max_memory_allocated()
    print(f"remat_mode none: step {none_times[0]:.1f} ms, peak memory "
          f"{peak_none / 2**30:.2f} GiB")
    profile_run(lambda: tv_none.train_step(blob), "step", top=6)
    del tv_none
    torch.cuda.empty_cache()

    # -- phase 5: kernels D and E against their plain versions -------------
    print(f"phase 5 at {time.perf_counter() - t_start:.1f} s")
    coords, values, nv = events(cfg, device)
    with torch.no_grad():
        graph = build_tile_graph(coords, values, nv, cfg)
    lv = graph.levels
    gen = torch.Generator(device=device).manual_seed(SEED)
    ext_res = {}
    with torch.no_grad():
        for name, l, t, c, dt in EXTEND_SHAPES:
            ext_res[name] = check_extend(name, lv[l].halo, t, c, dt, gen,
                                         device)
            torch.cuda.empty_cache()
    # the kernels' other branches, bitwise: uresnet_filters=12's rows of 24
    # and 120 bytes (8-byte units; D stores two to a 16-byte piece at
    # C=12), C=1 in float32 (4-byte units, four to D's piece), t=8 on a
    # tile_size=8 graph of config 4's events, and a 2D graph at t=2 (2-byte
    # units at C=3; 16-byte ones at C=16)
    with torch.no_grad():
        lv8 = build_tile_graph(
            *(torch.from_numpy(blob[k]).to(device)
              for k in ("coords", "values", "n_voxels")), cfg8).levels
        cfg2 = dataclasses.replace(cfg, data_dim=2)
        blob2 = event_blob(cfg2, 2, mean_voxels=30000)
        lv2 = build_tile_graph(
            *(torch.from_numpy(blob2[k]).to(device)
              for k in ("coords", "values", "n_voxels")), cfg2).levels
        ext_branch = {name: check_extend(name, level.halo, t, c, dt, gen,
                                         device, dim=dim, timed=False)
                      for name, level, t, c, dt, dim in (
                          ("L0 t=4 C=12", lv[0], 4, 12, torch.bfloat16, 3),
                          ("L4 t=2 C=60", lv[4], 2, 60, torch.bfloat16, 3),
                          ("stem L0 t=4 C=1 f32", lv[0], 4, 1, torch.float32,
                           3),
                          ("tile_size=8 L0 t=8 C=16", lv8[0], 8, 16,
                           torch.bfloat16, 3),
                          ("2D L1 t=2 C=3", lv2[1], 2, 3, torch.bfloat16, 2),
                          ("2D L1 t=2 C=16", lv2[1], 2, 16, torch.bfloat16,
                           2))}
    del graph, lv, lv8, lv2
    torch.cuda.empty_cache()

    # -- phase 6: config-3 inference on the unfused tile conv --------------
    print(f"phase 6 at {time.perf_counter() - t_start:.1f} s")
    variables3 = init_params(cfg, torch.Generator().manual_seed(SEED))
    model = construct("uresnet_sparse")(cfg)
    load_jax_variables(model, variables3)
    valid = torch.arange(cfg.max_voxels, device=device)[None] < nv[:, None]
    with torch.no_grad():
        ref, _ = model(coords, values, nv)            # the fused kernel path
        with fused(False):
            reset_counts()
            shapes = {}
            with record_extend(shapes, "forward"):
                model(coords, values, nv)             # warm-up
            torch.cuda.synchronize()
            ext_runs = {"unfused_forward": extend_per_run(
                shapes, device, "unfused config-3 forward",
                extend_by_shape())}
            del shapes
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(3):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                logits, diag = model(coords, values, nv)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            unfused_launches = counts()
            peak_unfused = torch.cuda.max_memory_allocated()
            profile_run(lambda: model(coords, values, nv),
                        "unfused config-3 forward", top=8)
    print(f"launches in 3 unfused forwards: {unfused_launches}")
    require(unfused_launches["halo26_fwd"] == 37 * 3,
            f"expected 37 halo26_fwd launches per unfused forward, got "
            f"{unfused_launches['halo26_fwd']} in 3")
    require(unfused_launches["halo_conv"] == 0
            and unfused_launches["halo_conv_dw"] == 0
            and unfused_launches["halo26_bwd"] == 0,
            "the unfused forward launched kernel B, C or E")
    diag = {k: int(v) for k, v in diag.items()}
    print(f"diag: {diag}")
    require(diag["overflow"] == 0, "graph overflow")
    require(tuple(logits.shape) == (BATCH, cfg.max_voxels, cfg.num_class)
            and bool(torch.isfinite(logits).all())
            and bool((logits[~valid] == 0).all()),
            "unfused logits: wrong shape, non-finite or nonzero padding")
    require_a(9 * 3, unfused_launches, "3 unfused forwards")
    compare_logits(logits, ref, valid, "unfused vs fused kernel logits")
    ms_unfused = sorted(times)[1]
    print(f"unfused forward (graph build included), 3 runs: "
          f"{', '.join(f'{t:.1f}' for t in times)} ms; median "
          f"{ms_unfused:.1f} ms = {BATCH / (ms_unfused / 1e3):.2f} events/s; "
          f"peak memory {peak_unfused / 2**30:.2f} GiB")
    del model, logits, ref
    torch.cuda.empty_cache()

    # float32 on the auto path: kernel B takes bf16 only, so the card runs
    # f32 through the unfused conv; held against the plain f32 path of the
    # fused conv (kernel B's plain version: no kernel D, no cuDNN NDHWC)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    model = construct("uresnet_sparse")(cfg32)
    load_jax_variables(model, variables3)
    with torch.no_grad():
        reset_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out32, _ = model(coords, values, nv)
        end.record()
        torch.cuda.synchronize()
        f32_launches = counts()
        with plain_versions(), fused(True):
            ref32, _ = model(coords, values, nv)
        torch.cuda.synchronize()
    print(f"launches in one f32 forward (auto): {f32_launches}, "
          f"{start.elapsed_time(end):.1f} ms (first call)")
    require(f32_launches["halo_conv"] == 0
            and f32_launches["halo26_fwd"] == 37,
            "the f32 forward did not take the unfused path")
    require(bool(torch.isfinite(out32).all()), "non-finite f32 logits")
    err32 = float((out32[valid] - ref32[valid]).abs().max())
    scale32 = float(ref32[valid].abs().max())
    print(f"f32 auto vs plain f32 logits: max|delta| {err32:.3e}, max|ref| "
          f"{scale32:.3e}")
    require(err32 <= 1e-4 * scale32, "f32 logits disagree with plain f32")
    require_a(9, f32_launches, "the f32 forward")
    del model, out32, ref32, coords, values, nv, valid
    torch.cuda.empty_cache()

    # -- phase 7: config-4 training on the unfused tile conv ---------------
    print(f"phase 7 at {time.perf_counter() - t_start:.1f} s")
    def fresh(c):
        tv_ = TrainVal(c)
        tv_.initialize(variables)
        return tv_

    loss_k, grads_k, stats_k = grads_and_stats(fresh(cfg4), blob)
    with fused(False):
        loss_u, grads_u, stats_u = grads_and_stats(fresh(cfg4), blob)
    with plain_versions(), fused(True):
        _, grads_f, _ = grads_and_stats(
            fresh(dataclasses.replace(cfg4, compute_dtype="float32")), blob)
    torch.cuda.synchronize()
    rel_loss = abs(loss_u - loss_k) / abs(loss_k)
    print(f"unfused vs fused kernel train step: loss {loss_u:.6f} vs "
          f"{loss_k:.6f} (rel {rel_loss:.3e})")
    require(rel_loss <= 1e-2, "unfused and fused losses disagree")
    names = sorted(grads_k)
    flat = [torch.cat([g[n].flatten() for n in names])
            for g in (grads_u, grads_k)]
    g_cos, g_rel = cos_rel(flat[0], flat[1])
    print(f"whole gradient, unfused vs fused kernels: cosine {g_cos:.6f}, "
          f"|delta|/|ref| {g_rel:.3e}")
    require(g_cos >= 0.99 and g_rel <= 5e-2,
            "unfused gradient disagrees with the fused kernel path")
    # per leaf: PR 2's rule, the fused kernel step K as the reference and
    # the plain f32 step F as the measure of bf16's own noise
    worst = []
    for n in names:
        u_cos, u_rel = cos_rel(grads_u[n], grads_k[n])
        f_rel = cos_rel(grads_k[n], grads_f[n])[1]
        worst.append((u_rel - 1.5 * f_rel, n, u_cos, u_rel, f_rel))
        require(u_rel <= 1.5 * f_rel + 0.05,
                f"gradient of {n}: unfused vs fused |delta|/|ref| "
                f"{u_rel:.3e} beyond the bf16 noise (fused vs f32 "
                f"{f_rel:.3e})")
    for _, n, u_cos, u_rel, f_rel in sorted(worst, reverse=True)[:3]:
        print(f"  closest to the bound: {n}: cosine {u_cos:.5f}, "
              f"|delta|/|ref| {u_rel:.3e}; fused vs f32 {f_rel:.3e}")
    worst_stat = 0.0
    for n, sk in stats_k.items():
        d = float(((stats_u[n] - sk).abs() / sk.abs().clamp(min=1.0)).max())
        require(d <= 1e-2, f"unfused batch stat {n} differs by {d:.3e}")
        worst_stat = max(worst_stat, d)
    print(f"{len(names)} gradients within the bf16 noise; {len(stats_k)} "
          f"running moments, worst rel {worst_stat:.3e}")
    del grads_k, grads_u, grads_f, stats_k, stats_u, flat

    with fused(False):
        tv = fresh(cfg4)
        torch.cuda.synchronize()
        reset_counts()
        shapes = {}
        with record_extend(shapes, "step"):
            losses, _, _ = timed_steps(tv, blob, 1, 0)
        unfused_train = counts()
        ext_runs["unfused_step"] = extend_per_run(
            shapes, device, "unfused config-4 step", extend_by_shape())
        del shapes
        print(f"launches in one unfused stage_dots step: {unfused_train}")
        require(unfused_train["halo26_fwd"] == 81,
                f"expected 81 halo26_fwd launches per step (41 forward + 40 "
                f"recomputed), got {unfused_train['halo26_fwd']}")
        require(unfused_train["halo26_bwd"] == 40,
                f"expected 40 halo26_bwd launches per step, got "
                f"{unfused_train['halo26_bwd']}")
        require(unfused_train["halo_conv"] == 0
                and unfused_train["halo_conv_dw"] == 0,
                "the unfused step launched kernel B or C")
        require_a(21, unfused_train, "the unfused step")
        torch.cuda.reset_peak_memory_stats()
        more, times, metrics = timed_steps(tv, blob, 1, 3)
        peak_u_dots = torch.cuda.max_memory_allocated()
        losses += more
        print(f"unfused losses of 5 steps on one batch: "
              f"{', '.join(f'{l:.6f}' for l in losses)}")
        require(all(np.isfinite(losses)) and losses[-1] < losses[0],
                "unfused training: non-finite loss, or it did not fall")
        require(int(metrics["overflow"]) == 0, "graph overflow in training")
        step_u = sorted(times)[1]
        print(f"unfused train step, 3 runs after 2 warm-ups: "
              f"{', '.join(f'{t:.1f}' for t in times)} ms; median "
              f"{step_u:.1f} ms = {BATCH4 / (step_u / 1e3):.3f} events/s; "
              f"peak memory {peak_u_dots / 2**30:.2f} GiB (stage_dots)")
        profile_run(lambda: tv.train_step(blob), "step")
        del tv
        torch.cuda.empty_cache()
        tv = fresh(dataclasses.replace(cfg4, remat_mode="none"))
        timed_steps(tv, blob, 1, 0)
        torch.cuda.reset_peak_memory_stats()
        _, none_times, _ = timed_steps(tv, blob, 0, 1)
        peak_u_none = torch.cuda.max_memory_allocated()
        print(f"unfused remat_mode none: step {none_times[0]:.1f} ms, peak "
              f"memory {peak_u_none / 2**30:.2f} GiB")
        del tv

    # -- phase 8: widths where the shape rule mixes the paths --------------
    print(f"phase 8 at {time.perf_counter() - t_start:.1f} s")
    width_launches = {}
    for name in WIDTH_CASES:
        width_launches.update(width_run(name, device, counts, reset_counts,
                                        require_a))
        torch.cuda.empty_cache()

    # -- phase 9: the CLI: train, restore, inference, iotest ---------------
    print(f"phase 9 at {time.perf_counter() - t_start:.1f} s")
    t9 = time.perf_counter()
    cli_launches = cli_phase(device, counts, reset_counts, require_a,
                             BATCH / (ms / 1e3), step_ms)
    print(f"phase 9: {time.perf_counter() - t9:.1f} s")

    # -- phase 10: the dense U-ResNet (configs 1 and 2) --------------------
    t10 = time.perf_counter()
    print(f"phase 10 at {t10 - t_start:.1f} s")
    dense_launches = dense_phase(device, counts, reset_counts)
    print(f"phase 10: {time.perf_counter() - t10:.1f} s")

    # -- phase 11: the row-gather engine against the tile engine -----------
    t11 = time.perf_counter()
    print(f"phase 11 at {t11 - t_start:.1f} s")
    gather_launches = gather_phase(device, counts, reset_counts, require_a,
                                   norm_launches)
    print(f"phase 11: {time.perf_counter() - t11:.1f} s")

    # -- phase 12: data parallel at config 5 ------------------------------
    t12 = time.perf_counter()
    print(f"phase 12 at {t12 - t_start:.1f} s")
    dp_launches = dp_phase(cfg4, variables, blob, step_ms)
    dp_launches.update(writer_phase(device, counts, reset_counts, require_a))
    print(f"phase 12: {time.perf_counter() - t12:.1f} s")

    # -- phase 13: the SCN layer API ---------------------------------------
    t13 = time.perf_counter()
    print(f"phase 13 at {t13 - t_start:.1f} s")
    scn_launches = scn_phase(device, counts, reset_counts)
    print(f"phase 13: {time.perf_counter() - t13:.1f} s")

    # -- phase 14: the eval pair (URESNET_EVAL_PAIR) at batch 16 -----------
    t14 = time.perf_counter()
    print(f"phase 14 at {t14 - t_start:.1f} s")
    pair_launches = eval_pair_phase(device, counts, reset_counts, require_a,
                                    ms, peak)
    print(f"phase 14: {time.perf_counter() - t14:.1f} s")

    # -- phase 15: the benchmark timer (utils/benchmark.py) ----------------
    t15 = time.perf_counter()
    print(f"phase 15 at {t15 - t_start:.1f} s")
    timer_phase(device, ms, step_ms)
    print(f"phase 15: {time.perf_counter() - t15:.1f} s")

    # -- phase 16: the BN kernels against their plain versions -------------
    t16 = time.perf_counter()
    print(f"phase 16 at {t16 - t_start:.1f} s")
    norm_res = norm_act_phase(cfg, device)
    print(f"phase 16: {time.perf_counter() - t16:.1f} s")

    paths = {"inference_3_forwards": infer_launches,
             "training_step": train_launches,
             "unfused_inference_3_forwards": unfused_launches,
             "f32_inference_forward": f32_launches,
             "unfused_training_step": unfused_train,
             **width_launches,
             **cli_launches, **dense_launches, **gather_launches,
             **dp_launches, **scn_launches, **pair_launches}

    def by_path(name):
        return {p: c[name] for p, c in paths.items()}

    def branch_checks(res):
        return {k: {"max_abs_err": r[0], "ms": r[1], "plain_ms": r[2],
                    "bound_ms": r[3]} for k, r in res.items()}

    def width_checks(res):
        return {k: {"max_abs_err": r[0], "ms": r[1], "plain_ms": r[2],
                    "bound_ms": r[3], "bound_by": r[4], "unfused_ms": r[5]}
                for k, r in res.items()}

    dw0 = dw_res["L0 t=4 16->16"]
    a0 = link_res["link1 assemble C=48"]
    b0 = halo_res["L0 t=4 16->16"]
    kernels = [
        {"name": "halo_conv", "route": "cuda",
         "source": "uresnet_pytorch_tpu_torch/csrc/halo_conv.cu",
         "replaces": "uresnet_pytorch_tpu/ops/pallas/halo_conv.py:1054",
         "also_replaces": ["uresnet_pytorch_tpu/ops/pallas/halo_conv.py:910",
                           "uresnet_pytorch_tpu/ops/pallas/halo_conv.py:942",
                           "uresnet_pytorch_tpu/ops/pallas/halo_conv.py:287",
                           "uresnet_pytorch_tpu/ops/pallas/halo_conv.py:1259"],
         "launches": train_launches["halo_conv"],
         "launches_by_path": by_path("halo_conv"),
         "max_abs_err": max(r[0] for r in (*halo_res.values(),
                                           *dx_res.values(),
                                           *b_branch.values(),
                                           *width_b.values(),
                                           *width_dx.values())),
         "ms": b0[1], "plain_ms": b0[2], "bound_ms": b0[3],
         "bound_by": b0[4], "library_ms": None,
         "ms_by_shape": {k: r[1] for k, r in (*halo_res.items(),
                                              *dx_res.items())},
         "launches_per_eval_forward": {
             mode: pair_launches[f"eval_{mode}_b16_3_forwards"]["halo_conv"]
             // 3 for mode in ("concat", "pair")},
         "branch_checks": branch_checks(b_branch),
         "width_checks": width_checks({**width_b, **width_dx})},
        {"name": "halo_conv_dw", "route": "cuda",
         "source": "uresnet_pytorch_tpu_torch/csrc/halo_conv_dw.cu",
         "replaces": "uresnet_pytorch_tpu/ops/pallas/halo_conv.py:1175",
         "also_replaces": ["uresnet_pytorch_tpu/ops/pallas/halo_conv.py:1144",
                           "uresnet_pytorch_tpu/ops/pallas/halo_conv.py:1259"],
         "launches": train_launches["halo_conv_dw"],
         "launches_by_path": by_path("halo_conv_dw"),
         "max_abs_err": max(r[0] for r in (*dw_res.values(),
                                           *dw_branch.values(),
                                           *width_dw.values())),
         "ms": dw0[1], "plain_ms": dw0[2], "bound_ms": dw0[3],
         "bound_by": dw0[4], "library_ms": None,
         "ms_by_shape": {k: r[1] for k, r in dw_res.items()},
         "by_shape": {name: {"ms": dw_res[name][1],
                             "plain_ms": dw_res[name][2],
                             "bound_ms": dw_res[name][3],
                             "launches": n}
                      for name, n in dw_per_step.items()},
         "ms_per_step": dw_step_ms,
         "branch_checks": branch_checks(dw_branch),
         "width_checks": width_checks(width_dw)},
        {"name": "windowed_gather", "route": "cuda",
         "source": "uresnet_pytorch_tpu_torch/csrc/windowed_gather.cu",
         "replaces":
             "uresnet_pytorch_tpu/ops/pallas/windowed_gather.py:104",
         "also_replaces": [
             "uresnet_pytorch_tpu/ops/tile_conv.py:305 _assemble_impl",
             "uresnet_pytorch_tpu/ops/tile_conv.py:322 _parent_corner_impl"],
         "launches": train_launches["windowed_gather"],
         "launches_by_path": by_path("windowed_gather"),
         "max_abs_err": max(r[0] for r in (*gather_res.values(),
                                           *link_res.values())),
         "ms": a0[1], "plain_ms": a0[2], "bound_ms": a0[3],
         "bound_by": a0[4], "library_ms": a0[5],
         "by_link": {k: {"ms": r[1], "plain_ms": r[2], "bound_ms": r[3],
                         "bound_by": r[4], "library_ms": r[5]}
                     for k, r in (*link_res.items(), *gather_res.items())}},
    ]
    # kernels D and E: launches on their main path (the unfused step),
    # times at config 3's L0 t=4 C=16 bf16 (device-only), the other shapes
    # and branches beside, and each run's ms x launches
    for name, key, line in (("halo26_fwd", "d", 455),
                            ("halo26_bwd", "e", 515)):
        r0 = ext_res["L0 t=4 C=16"][key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "uresnet_pytorch_tpu_torch/csrc/halo_extend.cu",
            "replaces": f"uresnet_pytorch_tpu/ops/pallas/halo_fused.py:{line}",
            "launches": unfused_train[name],
            "launches_by_path": by_path(name),
            "max_abs_err": max(r[key][0] for r in (*ext_res.values(),
                                                   *ext_branch.values())),
            "ms": r0[1], "plain_ms": r0[2], "bound_ms": r0[3],
            "bound_by": r0[4], "library_ms": r0[5],
            "by_shape": {k: {"ms": r[key][1], "plain_ms": r[key][2],
                             "bound_ms": r[key][3], "library_ms": r[key][5]}
                         for k, r in ext_res.items()},
            "branch_checks": {k: {"max_abs_err": r[key][0], "ms": r[key][1],
                                  "bound_ms": r[key][3]}
                              for k, r in ext_branch.items()},
            "ms_x_launches": {run: v[key.upper()][0]
                              for run, v in ext_runs.items()}})
    n0 = next(iter(norm_res.values()))   # level 0, C = 16, the main path
    kernels.append({
        "name": "norm_act", "route": "cuda",
        "source": "uresnet_pytorch_tpu_torch/csrc/norm_act.cu",
        "replaces": None,
        "why": "BN, its activation and re-mask: jnp code XLA fused on the "
               "TPU, a chain of torch ops on the card",
        "launches": train_norm, "launches_per_eval_forward":
            infer_norm["fwd"] // 3,
        "max_abs_err": max(max(r["apply"], r["bwd_apply"])
                           for r in norm_res.values()),
        "ms": n0["ms"], "bound_ms": n0["bound_ms"],
        "plain_ms": {"fwd": n0["chain_fwd_ms"],
                     "fwd_bwd": n0["chain_fwd_bwd_ms"]},
        "library_ms": None,
        "by_shape": norm_res})
    # -- phase 17: MinkUNet34C --------------------------------------------
    mink = mink_phase(device, counts)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels, "mink": mink}, default=str))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
