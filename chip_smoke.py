#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the port's CUDA kernels from `uresnet_pytorch_tpu_torch/csrc/`
   (nvcc, into build/torch_kernels/).
2. Holds each kernel against its plain torch version at the shapes the
   main path gives it, and times both with CUDA events.
3. Drives BASELINE config 3 (sparse U-ResNet inference, 512^3 events of
   ~1e5 voxels, batch 8, bf16, tile schedule (4,2,2,2,2); random weights
   from a seed) through `models.construct("uresnet_sparse")` for three
   forwards, counts the kernel launches of those forwards, and compares
   the logits with the same model on the plain versions.

Every check raises, so any failure exits nonzero. The last line is a JSON
object naming the device; the line before it lists each kernel's route,
launches, error and times. The script imports nothing of JAX or of the
JAX package: the port carries its own configuration and event generator.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

SEED = 0
BATCH = 8
N_VOXELS = 100_000      # per event, as bench.py
HALO_RTOL, HALO_ATOL = 2e-2, 1e-2   # bf16 bound of tests/test_tpu_gated.py


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


def events(cfg, device):
    """bench.py's batch: generator dedupe eats ~35%, so the target is 1.5x."""
    from uresnet_pytorch_tpu_torch.iotools.synthetic import generate_event
    coords = np.zeros((BATCH, cfg.max_voxels, 3), np.int32)
    values = np.zeros((BATCH, cfg.max_voxels), np.float32)
    nv = np.zeros((BATCH,), np.int32)
    for b in range(BATCH):
        c, v, _ = generate_event(SEED, b, cfg.spatial_size, 3,
                                 mean_voxels=int(N_VOXELS * 1.5))
        n = min(len(c), cfg.max_voxels)
        coords[b, :n], values[b, :n], nv[b] = c[:n], v[:n], n
    return tuple(torch.from_numpy(a).to(device)
                 for a in (coords, values, nv))


@contextlib.contextmanager
def plain_versions():
    """The model with each kernel's plain torch version in the kernel
    wrapper's place, on the same device: the reference the kernel path is
    held against. The wrappers themselves never fall back."""
    from uresnet_pytorch_tpu_torch.ops import tile_conv
    from uresnet_pytorch_tpu_torch.ops.cuda.halo_conv import halo_conv_plain
    from uresnet_pytorch_tpu_torch.ops.cuda.windowed_gather import (
        windowed_gather_plain)
    with mock.patch.object(tile_conv, "halo_conv", halo_conv_plain), \
            mock.patch.object(tile_conv, "windowed_gather",
                              windowed_gather_plain):
        yield


def time_ms(fn, iters: int = 5) -> float:
    """Mean device time of fn over `iters` runs after one warm-up."""
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


def check_halo_conv(name, level, t, cin, cout, rng, device):
    """Kernel B vs its plain version on one level's real halo maps, raw and
    with the epilogue. Returns (max_abs_err, kernel ms, plain ms) of the
    epilogue form."""
    from uresnet_pytorch_tpu_torch.ops.cuda.halo_conv import (
        halo_conv, halo_conv_plain)
    B, T = level.keys.shape
    cells = t ** 3
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
    plain_ms = time_ms(lambda: halo_conv_plain(x, w, level.halo, t, 3, **ep),
                       iters=2)
    print(f"halo_conv {name} bn_act: kernel {ms:.3f} ms, plain {plain_ms:.3f}"
          " ms")
    return worst, ms, plain_ms


def check_gather(name, spec, src_rows, feat, rng, device):
    """Kernel A vs its plain version on one real link spec: bitwise."""
    from uresnet_pytorch_tpu_torch.ops.cuda.windowed_gather import (
        windowed_gather, windowed_gather_plain)
    B = spec.idx.shape[0]
    src = torch.from_numpy(rng.standard_normal(
        (B, src_rows, feat), dtype=np.float32)).to(device, torch.bfloat16)
    got = windowed_gather(src, spec.idx, spec.ok)
    ref = windowed_gather_plain(src, spec.idx, spec.ok)
    torch.cuda.synchronize()
    same = torch.equal(got, ref)
    err = float((got.float() - ref.float()).abs().max())
    print(f"windowed_gather {name}: src {tuple(src.shape)} -> "
          f"{tuple(got.shape)}, rows served {int(spec.ok.sum())}, "
          f"bitwise equal: {same}")
    require(same, f"windowed_gather {name} is not bitwise equal to plain")
    ms = time_ms(lambda: windowed_gather(src, spec.idx, spec.ok))
    plain_ms = time_ms(lambda: windowed_gather_plain(src, spec.idx, spec.ok))
    print(f"windowed_gather {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f}"
          " ms")
    return err, ms, plain_ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    from uresnet_pytorch_tpu_torch.models import construct
    from uresnet_pytorch_tpu_torch.ops import cuda
    from uresnet_pytorch_tpu_torch.ops.cuda import halo_conv as hc_mod
    from uresnet_pytorch_tpu_torch.ops.cuda import windowed_gather as wg_mod
    from uresnet_pytorch_tpu_torch.ops.tile_graph import build_tile_graph
    from uresnet_pytorch_tpu_torch.utils.weights import (init_params,
                                                         load_jax_variables)

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

    t0 = time.perf_counter()
    lib = cuda.build()
    print(f"kernels built: {lib.name} in {time.perf_counter() - t0:.1f} s")

    cfg = config3()
    coords, values, nv = events(cfg, device)
    print(f"config 3: batch {BATCH}, voxels/event {nv.tolist()}")

    # -- phase 1: each kernel against its plain version ---------------------
    rng = np.random.default_rng(SEED)
    graph = build_tile_graph(coords, values, nv, cfg)
    lv = graph.levels
    print("tile rows per level:", [tuple(l.keys.shape) for l in lv],
          "live:", [int(l.num.max()) for l in lv])
    # every conv shape class of the path: the stem (Cin 1, scalar staging),
    # square blocks at t=4 and t=2, and the decoder's first conv after the
    # skip concat (Cin = 2 Cout; 27x128x64 is the largest weight stack)
    halo_res = [check_halo_conv("L0 t=4 16->16", lv[0], 4, 16, 16, rng,
                                device),
                check_halo_conv("stem L0 t=4 1->16", lv[0], 4, 1, 16, rng,
                                device),
                check_halo_conv("L2 t=2 48->48", lv[2], 2, 48, 48, rng,
                                device),
                check_halo_conv("dec L3 t=2 128->64", lv[3], 2, 128, 64, rng,
                                device),
                check_halo_conv("L4 t=2 80->80", lv[4], 2, 80, 80, rng,
                                device)]
    link = graph.links[1]      # levels 1 -> 2, a real link (link 0 is
    #                            the identity of the 4 -> 2 tile halving)
    Tf, Tc = lv[1].keys.shape[1], lv[2].keys.shape[1]
    gather_res = [check_gather("link1 child[0] F=48", link.children[0], Tf,
                               48, rng, device),
                  check_gather("link1 parent[0] F=48", link.parents[0],
                               Tc * 8, 48, rng, device)]
    del graph, lv, link

    # -- phase 2: config-3 inference through the model entry point ---------
    variables = init_params(cfg, torch.Generator().manual_seed(SEED))
    model = construct("uresnet_sparse")(cfg).to(device)
    load_jax_variables(model, variables)
    model(coords, values, nv)                     # warm-up
    torch.cuda.synchronize()
    hc_mod.launches = 0
    wg_mod.launches = 0
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
    launches = {"halo_conv": hc_mod.launches,
                "windowed_gather": wg_mod.launches}
    peak = torch.cuda.max_memory_allocated()
    print(f"launches in 3 forwards: {launches}")
    require(launches["halo_conv"] == 37 * 3,
            f"expected 37 halo_conv launches per forward, got "
            f"{launches['halo_conv']} in 3")
    require(launches["windowed_gather"] > 0, "no windowed_gather launch")
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
    with plain_versions():
        start.record()
        ref, _ = model(coords, values, nv)
        end.record()
        torch.cuda.synchronize()
    print(f"plain-path forward: {start.elapsed_time(end):.1f} ms")
    require((hc_mod.launches, wg_mod.launches)
            == (launches["halo_conv"], launches["windowed_gather"]),
            "the plain-path forward launched a kernel")
    valid = ~pad
    got, ref = logits[valid], ref[valid]
    rel = ((got - ref).abs() / ref.abs().clamp(min=1.0)).flatten()
    q99 = float(torch.quantile(rel, 0.99))
    q999 = float(torch.quantile(rel, 0.999))
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    print(f"kernel vs plain logits over {int(valid.sum())} voxels: p99 rel "
          f"{q99:.3e}, p99.9 rel {q999:.3e}, max abs "
          f"{float((got - ref).abs().max()):.3e}, argmax agreement "
          f"{agree:.5f}")
    require(q99 < 5e-2 and q999 < 0.15 and agree > 0.995,
            "kernel-path logits disagree with the plain path")

    kernels = [
        {"name": "halo_conv", "route": "cuda",
         "source": "uresnet_pytorch_tpu_torch/csrc/halo_conv.cu",
         "replaces": "uresnet_pytorch_tpu/ops/pallas/halo_conv.py:1054",
         "also_replaces": ["uresnet_pytorch_tpu/ops/pallas/halo_conv.py:910",
                           "uresnet_pytorch_tpu/ops/pallas/halo_conv.py:942",
                           "uresnet_pytorch_tpu/ops/pallas/halo_conv.py:287"],
         "launches": launches["halo_conv"],
         "max_abs_err": max(r[0] for r in halo_res),
         "ms": halo_res[0][1], "plain_ms": halo_res[0][2]},
        {"name": "windowed_gather", "route": "cuda",
         "source": "uresnet_pytorch_tpu_torch/csrc/windowed_gather.cu",
         "replaces":
             "uresnet_pytorch_tpu/ops/pallas/windowed_gather.py:104",
         "launches": launches["windowed_gather"],
         "max_abs_err": max(r[0] for r in gather_res),
         "ms": gather_res[0][1], "plain_ms": gather_res[0][2]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
