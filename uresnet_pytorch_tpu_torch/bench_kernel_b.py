"""Times kernel B (the fused halo conv), kernel C (its weight gradient),
kernel A (the link gathers) or kernels D and E (the halo extend and its
transpose) of several source trees in turns on one card, at the shapes
the config-3 forward and the config-4 step give it.

    python -m uresnet_pytorch_tpu_torch.bench_kernel_b \
        [--tree NAME=DIR ...] [--rounds 2] [--check NAME ...] [--dw]
        [--step] [--gather] [--extend] [--out FILE]

A tree is a directory holding a `uresnet_pytorch_tpu_torch` package (a
checkout, or a copy of the package with an edited `csrc/`); `this` is the
tree this module belongs to and is always timed. Each tree runs in a
process of its own, which imports that tree's package (and this tree's
`chip_smoke.py`), builds its kernels (all trees' builds start together; a
tree that does not build is reported, left out, and makes the run exit 1)
and times its `halo_conv` wrapper with CUDA events: the mean of 20
launches after 3 warm-ups, on random bf16 inputs made from one seed, on
the real halo maps of config 3 (batch 8), config 4 (batch 2, d_x on
flipped weights) and MinkUNet34C's 512^3 batch of 8 (its convs, forward
and d_x). `--dw` times its `halo_conv_dw` wrapper instead, at the
six weight-gradient shapes of a config-4 step. The trees run in the order
given and then in reverse, `rounds` times, so a drift of the card falls on
every tree alike. `--check NAME` holds that tree's kernel to its plain
version at every shape first (the bounds of `chip_smoke.py`: bf16 for B,
`DW_RTOL` for C). `--gather` instead times kernel A's one-octant gather at
link 1 against `torch.gather` with both timers (CUDA events around calls
from Python, and `chip_smoke.device_ms`, which replays a CUDA graph), the
nine link ops of a config-3 forward whole on the device-only timer, and
profiles one config-3 forward and one config-4 step (the link movement:
device time of the kernels inside the link ops). `--step` instead
profiles one config-4 training step per process (after two warm-ups;
`torch.profiler`, device time by kernel name) and lists the kernels whose
time differs most between the trees. `--extend` instead times kernels D
and E on the device-only timer at every shape an unfused config-3
forward (batch 8) and an unfused config-4 step (batch 2) launch them at,
on those launches' maps, weights each shape by its launches, times
`index_select` and `index_add_` of the same rows (in the first process
only), and profiles one unfused forward and step per process. The table
goes to stdout and every timing, as JSON, to `--out` (default
`build/bench_kernel_b.json`).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# name, config (3, 4 or "mink"), level, t, Cin, Cout, d_x (raw on flipped
# weights)
SHAPES = [("L0 t=4 16->16", 3, 0, 4, 16, 16, False),
          ("stem L0 t=4 1->16", 3, 0, 4, 1, 16, False),
          ("dec L0 t=4 32->16", 3, 0, 4, 32, 16, False),
          ("L1 t=2 32->32", 3, 1, 2, 32, 32, False),
          ("L2 t=2 48->48", 3, 2, 2, 48, 48, False),
          ("dec L3 t=2 128->64", 3, 3, 2, 128, 64, False),
          ("L4 t=2 80->80", 3, 4, 2, 80, 80, False),
          ("d_x L0 t=4 16->16", 4, 0, 4, 16, 16, True),
          ("d_x L4 t=2 80->80", 4, 4, 2, 80, 80, True)]
# MinkUNet34C's convs that keep the resident path (one Cout slice), beside
# those on the wide path (chip_smoke.MINK_B): name, level, t, Cin, Cout
MINK_RESIDENT = (("mink L1 t=2 32->32", 1, 2, 32, 32),
                 ("mink L2 t=2 32->64", 2, 2, 32, 64),
                 ("mink L1 dec t=2 32->96", 1, 2, 32, 96),
                 ("mink L0 dec t=4 32->96", 0, 4, 32, 96))


def shapes() -> list:
    """SHAPES, then MinkUNet34C's (MINK_RESIDENT, then chip_smoke.MINK_B)
    on its 512^3 batch-8 graph ("mink"), forward and d_x."""
    return SHAPES + [(pre + name, "mink", lvl, t,
                      *((co, ci) if dx else (ci, co)), dx)
                     for dx, pre in ((False, ""), (True, "d_x "))
                     for name, lvl, t, ci, co in MINK_RESIDENT
                     + _smoke().MINK_B]


# kernel C on config 4's maps: name, level, t, Cin, Cout (the decoder's
# first conv_a runs as a pair of convs against the halves of its stack)
DW_SHAPES = [("stem L0 t=4 1->16", 0, 4, 1, 16),
             ("L0 t=4 16->16", 0, 4, 16, 16),
             ("L1 t=2 32->32", 1, 2, 32, 32),
             ("L2 t=2 48->48", 2, 2, 48, 48),
             ("dec pair half L3 t=2 64->64", 3, 2, 64, 64),
             ("L4 t=2 80->80", 4, 2, 80, 80)]

# kernel A's link ops on config 3's graph, as a forward runs them: (link,
# op, channels); the graph build's occupancy assembles one channel, the
# encoder's down link and the decoder's up link the coarse level's width
LINK_OPS = [(l, op, c) for l, w in ((1, 48), (2, 64), (3, 80))
            for op, c in (("assemble", 1), ("assemble", w), ("parent", w))]


def _smoke():
    """This tree's `chip_smoke` (configurations, events, timers, profile),
    whichever tree's package is under test: a tree's own copy of the
    script would shadow it on sys.path."""
    import importlib.util
    if "chip_smoke" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", ROOT / "chip_smoke.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules["chip_smoke"] = mod
        spec.loader.exec_module(mod)
    return sys.modules["chip_smoke"]


def _time_ms(fn, iters: int = 20, warm: int = 3) -> float:
    import torch
    for _ in range(warm):
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


def _inputs(level, t, cin, cout, seed):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    B, T = level.keys.shape
    live = level.halo.blive[..., None, None].cpu().numpy()
    x = rng.standard_normal((B, T, t ** 3, cin), dtype=np.float32) * live
    w = rng.standard_normal((27, cin, cout), dtype=np.float32) \
        * np.float32((2.0 / (27 * cin)) ** 0.5)
    a = rng.standard_normal(cout, dtype=np.float32) * 0.2 + 1.0
    b = rng.standard_normal(cout, dtype=np.float32) * 0.2
    dev = level.keys.device
    x, w = (torch.from_numpy(v).to(dev, torch.bfloat16) for v in (x, w))
    a, b = (torch.from_numpy(v).to(dev) for v in (a, b))
    return x, w, dict(a=a, b=b, alpha=0.1,
                      mask=level.occ & level.halo.blive[..., None])


def _config4_graph(device):
    import torch

    chip_smoke = _smoke()
    from uresnet_pytorch_tpu_torch.ops.tile_graph import build_tile_graph
    blob = chip_smoke.event_blob(chip_smoke.config4(), chip_smoke.BATCH4)
    with torch.no_grad():
        return build_tile_graph(
            *(torch.from_numpy(blob[k]).to(device)
              for k in ("coords", "values", "n_voxels")), chip_smoke.config4())


def worker_dw(check: bool) -> dict:
    """Times this process's kernel C at DW_SHAPES on config 4's maps."""
    import numpy as np
    import torch

    chip_smoke = _smoke()
    from uresnet_pytorch_tpu_torch.ops.cuda import halo_conv_dw as dw
    device = torch.device("cuda", 0)
    graph = _config4_graph(device)
    out = {"package": dw.__file__, "shapes": {}, "errors": {}}
    for i, (name, lvl, t, cin, cout) in enumerate(DW_SHAPES):
        level = graph.levels[lvl]
        rng = np.random.default_rng(i)
        B, T = level.keys.shape
        live = level.halo.blive[..., None, None].cpu().numpy()
        x, g = (torch.from_numpy(rng.standard_normal(
            (B, T, t ** 3, c), dtype=np.float32) * live).to(
                device, torch.bfloat16) for c in (cin, cout))

        def run():
            return dw.halo_conv_dw(x, g, level.halo, t, 3)
        res = {}
        try:
            if check:
                ref = dw.halo_conv_dw_plain(x, g, level.halo, t, 3)
                err = float((run() - ref).abs().max())
                res["dw_max_abs_err"] = err
                res["dw_ok"] = err <= chip_smoke.DW_RTOL * float(
                    ref.abs().max())
            res["dw"] = _time_ms(run)
        except RuntimeError as e:             # a variant that cannot launch
            out["errors"][f"{name} dw"] = str(e)
            res["dw"] = None
        out["shapes"][name] = res
    return out


def worker_step() -> dict:
    """Device ms and calls by kernel name in one profiled config-4 training
    step of this process's package, after two warm-up steps. A user
    annotation's device row (the optimizer's span, gaps included) is not
    a kernel and is left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    chip_smoke = _smoke()
    from uresnet_pytorch_tpu_torch import trainval
    from uresnet_pytorch_tpu_torch.utils.weights import init_params
    cfg = chip_smoke.config4()
    blob = chip_smoke.event_blob(cfg, chip_smoke.BATCH4)
    tv = trainval.TrainVal(cfg)
    tv.initialize(init_params(cfg, torch.Generator().manual_seed(cfg.seed)))
    for _ in range(2):
        tv.train_step(blob)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tv.train_step(blob)
        torch.cuda.synchronize()
    rows = {e.key: [e.self_device_time_total / 1e3, e.count]
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not e.is_user_annotation
            and e.self_device_time_total > 0}
    return {"package": trainval.__file__, "kernels": rows}


def worker_gather() -> dict:
    """Kernel A and the link ops of this process's package on config 3's
    graph: the one-octant gather at link 1 (child and parent side) and
    `torch.gather` of the same rows, five times each with CUDA events
    around 20 calls from Python (`_time_ms`) and with the device-only
    timer (`device_ms`); each link op of LINK_OPS whole (kernel and torch
    passes), device-only; then one profiled config-3 forward and one
    profiled config-4 step (link movement and device work), and the host
    times of 5 forwards and 5 steps."""
    import numpy as np
    import torch

    smoke = _smoke()
    from uresnet_pytorch_tpu_torch.models import construct
    from uresnet_pytorch_tpu_torch.ops import tile_conv as tc
    from uresnet_pytorch_tpu_torch.ops.cuda.windowed_gather import (
        windowed_gather)
    from uresnet_pytorch_tpu_torch.ops.tile_graph import build_tile_graph
    from uresnet_pytorch_tpu_torch.trainval import TrainVal
    from uresnet_pytorch_tpu_torch.utils.weights import (init_params,
                                                         load_jax_variables)
    device = torch.device("cuda", 0)
    cfg = smoke.config3()
    coords, values, nv = smoke.events(cfg, device)
    with torch.no_grad():
        graph = build_tile_graph(coords, values, nv, cfg)
    lv = graph.levels
    rng = np.random.default_rng(0)
    out = {"package": tc.__file__, "single": {}, "links": {}}
    link = graph.links[1]
    for name, spec, rows in (
            ("link1 child[0]", link.children[0], lv[1].keys.shape[1]),
            ("link1 parent[0]", link.parents[0], lv[2].keys.shape[1] * 8)):
        src = torch.from_numpy(rng.standard_normal(
            (spec.idx.shape[0], rows, 48), dtype=np.float32)).to(
                device, torch.bfloat16)
        flat = torch.where(spec.ok, spec.idx, 0).long()[..., None]
        flat = flat.expand(*spec.idx.shape, 48).contiguous()
        fns = {"kernel": lambda: windowed_gather(src, spec.idx, spec.ok),
               "torch.gather": lambda: torch.gather(src, 1, flat)}
        res = {f"{k} {timer}": [] for k in fns for timer in ("events",
                                                            "device")}
        for _ in range(5):
            for k, fn in fns.items():
                res[f"{k} events"].append(_time_ms(fn))
                res[f"{k} device"].append(smoke.device_ms(fn))
        out["single"][name] = res
    with torch.no_grad():
        for l, op, c in LINK_OPS:
            link = graph.links[l]
            B, T = lv[l + (op == "parent")].keys.shape
            x = torch.from_numpy(rng.standard_normal(
                (B, T, 1 if op == "assemble" else 8, c),
                dtype=np.float32)).to(device, torch.bfloat16)
            fn = (tc._AssembleChildrenLink if op == "assemble"
                  else tc._ParentCornerLink).apply
            out["links"][f"link{l} {op} C={c}"] = [
                smoke.device_ms(lambda: fn(x, link, 2, 3)) for _ in range(3)]
    del graph, lv, link
    model = construct("uresnet_sparse")(cfg)
    load_jax_variables(model, init_params(cfg, torch.Generator().manual_seed(
        smoke.SEED)))
    with torch.no_grad():
        model(coords, values, nv)
        out["forward_profile"] = smoke.profile_run(
            lambda: model(coords, values, nv), "config-3 forward", top=0)
        out["forward_ms"] = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            model(coords, values, nv)
            end.record()
            torch.cuda.synchronize()
            out["forward_ms"].append(start.elapsed_time(end))
    del model, coords, values, nv
    torch.cuda.empty_cache()
    cfg4 = smoke.config4()
    blob = smoke.event_blob(cfg4, smoke.BATCH4)
    tv = TrainVal(cfg4)
    tv.initialize(init_params(cfg4, torch.Generator().manual_seed(cfg4.seed)))
    _, out["step_ms"], _ = smoke.timed_steps(tv, blob, 2, 5)
    out["step_profile"] = smoke.profile_run(lambda: tv.train_step(blob),
                                            "config-4 step", top=0)
    return out


def worker_extend(yardsticks: bool) -> dict:
    """Kernels D and E of this process's package at every shape that one
    unfused config-3 forward (batch 8) and one unfused config-4 step
    (batch 2) launch them at, with those launches' own maps: device-only
    ms (`device_ms`) on random inputs made from one seed, the launches,
    the bound; with `yardsticks`, `index_select` (D) and `index_add_` over
    the cells that have a source (E) of the same rows. Then one profiled
    unfused forward and step (D's and E's device time, device work) and
    the host-timed medians of 5 forwards and 3 steps."""
    import torch

    smoke = _smoke()
    from uresnet_pytorch_tpu_torch.models import construct
    from uresnet_pytorch_tpu_torch.ops.cuda import halo_extend as he
    from uresnet_pytorch_tpu_torch.ops.halo import Halo26Spec
    from uresnet_pytorch_tpu_torch.ops.tile_graph import build_tile_graph
    from uresnet_pytorch_tpu_torch.trainval import TrainVal
    from uresnet_pytorch_tpu_torch.utils.weights import (init_params,
                                                         load_jax_variables)
    device = torch.device("cuda", 0)
    out = {"package": he.__file__}
    shapes = {}
    cfg = smoke.config3()
    coords, values, nv = smoke.events(cfg, device)
    model = construct("uresnet_sparse")(cfg)
    load_jax_variables(model, init_params(cfg, torch.Generator().manual_seed(
        smoke.SEED)))
    with torch.no_grad():
        # phase 5's shapes of chip_smoke.py, on config 3's maps
        lv = build_tile_graph(coords, values, nv, cfg).levels
        out["phase5"] = {}
        gen = torch.Generator(device=device)
        for i, (name, level, t, C, dtype) in enumerate(smoke.EXTEND_SHAPES):
            halo = lv[level].halo
            B, _, T = halo.idx.shape
            res = {}
            gen.manual_seed(i)
            for kernel, fn, cells in (("D", he.halo26_fwd, t ** 3),
                                      ("E", he.halo26_bwd, (t + 2) ** 3)):
                a = torch.randn(B, T, cells, C, device=device,
                                generator=gen).to(dtype)
                res[kernel] = smoke.device_ms(
                    lambda: fn(a, halo, t, 3),
                    launches=smoke.graph_launches(fn(a, halo, t, 3)))
                res[f"{kernel} bound"] = smoke.bound(0, smoke.extend_bytes(
                    kernel.lower(), a, halo, t, 3))[0]
                del a
            out["phase5"][name] = res
        del lv, halo
        torch.cuda.empty_cache()
    with torch.no_grad(), smoke.fused(False):
        model(coords, values, nv)
        with smoke.record_extend(shapes, "forward"):
            model(coords, values, nv)
        out["forward_profile"] = smoke.profile_run(
            lambda: model(coords, values, nv), "unfused config-3 forward",
            top=0)
        out["forward_ms"] = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            model(coords, values, nv)
            end.record()
            torch.cuda.synchronize()
            out["forward_ms"].append(start.elapsed_time(end))
    del model, coords, values, nv
    torch.cuda.empty_cache()
    cfg4 = smoke.config4()
    blob = smoke.event_blob(cfg4, smoke.BATCH4)
    tv = TrainVal(cfg4)
    tv.initialize(init_params(cfg4, torch.Generator().manual_seed(cfg4.seed)))
    with smoke.fused(False):
        smoke.timed_steps(tv, blob, 1, 0)
        with smoke.record_extend(shapes, "step"):
            tv.train_step(blob)
        out["step_profile"] = smoke.profile_run(lambda: tv.train_step(blob),
                                                "unfused config-4 step",
                                                top=0)
        _, out["step_ms"], _ = smoke.timed_steps(tv, blob, 0, 3)
    del tv
    torch.cuda.empty_cache()
    out["shapes"] = smoke.time_recorded(shapes, device)
    for key, rec in shapes.items() if yardsticks else ():
        a = torch.randn(rec["shape"], device=device).to(rec["dtype"])
        C = a.shape[-1]
        rows = smoke.row_map(Halo26Spec(*rec["spec"], None, None), rec["t"],
                             device)
        if rec["kernel"] == "D":
            pad = torch.cat([a.reshape(-1, C), a.new_zeros(1, C)])
            lib = lambda: torch.index_select(pad, 0, rows)  # noqa: E731
        else:
            zero_row = a.shape[0] * a.shape[1] * rec["t"] ** 3  # no source
            has = (rows != zero_row).nonzero().squeeze(1)
            rows_e, g_e = rows[has], a.reshape(-1, C)[has]
            acc = a.new_zeros(zero_row + 1, C)
            lib = lambda: acc.index_add_(0, rows_e, g_e)  # noqa: E731
        out["shapes"][key]["library_ms"] = smoke.device_ms(lib, launches=4,
                                                           reps=3)
        del a, rows, lib
        torch.cuda.empty_cache()
    return out


def _extend_table(order: list, runs: dict) -> dict:
    """Prints, per shape, each tree's median device-only ms of D or E
    (over its processes), the bound and share of it, the launches and
    launches x (ms - bound); then each tree's summed ms x launches per
    path and kernel, D's and E's profiled device time and device work,
    and the host-timed medians; returns them."""
    first = order[0]
    shapes = runs[first][0]["shapes"]
    table = {"shapes": {}, "sums": {}, "profiles": {}}
    print(f"{'shape':44s} {'n':>3s} {'bound':>7s} " + " ".join(
        f"{n[:12]:>20s}" for n in order) + "  library  (device-only ms, "
        "share of bound, n x (ms - bound))")
    for key, base in shapes.items():
        meds = {n: statistics.median(r["shapes"][key]["ms"]
                                     for r in runs[n]) for n in order}
        lib = [r["shapes"][key]["library_ms"] for n in order
               for r in runs[n] if "library_ms" in r["shapes"][key]]
        b, k = base["bound_ms"], base["launches"]
        table["shapes"][key] = {"launches": k, "bound_ms": b,
                                "ms": meds, "library_ms":
                                    statistics.median(lib) if lib else None}
        print(f"{key:44s} {k:3d} {b:7.4f} " + " ".join(
            f"{m:7.4f} {b / m:4.0%} {k * (m - b):6.3f}"
            for m in meds.values())
            + (f" {statistics.median(lib):8.4f}" if lib else ""))
    print(f"{'phase-5 shape':30s} " + " ".join(
        f"{n[:12]:>28s}" for n in order) + "  (D | E device-only ms, share "
        "of bound)")
    table["phase5"] = {}
    for name, base in runs[first][0]["phase5"].items():
        row = {n: {k: statistics.median(r["phase5"][name][k]
                                        for r in runs[n])
                   for k in ("D", "E")} for n in order}
        table["phase5"][name] = {"ms": row, "bound_ms": {
            k: base[f"{k} bound"] for k in ("D", "E")}}
        print(f"{name:30s} " + " ".join(
            f"{m['D']:7.4f} {base['D bound'] / m['D']:4.0%} "
            f"{m['E']:7.4f} {base['E bound'] / m['E']:4.0%}"
            for m in row.values()))
    for n in order:
        sums = {}
        for key, v in table["shapes"].items():
            base = shapes[key]
            tag = f"{base['path']} {base['kernel']}"
            sums[tag] = sums.get(tag, 0.0) + v["launches"] * v["ms"][n]
        table["sums"][n] = sums
        prof = {}
        for key in ("forward", "step"):
            ps = [r[f"{key}_profile"] for r in runs[n]]
            ts = [v for r in runs[n] for v in r[f"{key}_ms"]]
            prof[key] = {"D_ms": [p["kinds"]["kernel D"] for p in ps],
                         "E_ms": [p["kinds"]["kernel E"] for p in ps],
                         "busy_ms": [p["busy_ms"] for p in ps],
                         "host_ms": ts}
            print(f"{n}: unfused {key}: summed ms x launches "
                  + ", ".join(f"{k} {v:.3f}" for k, v in sums.items()
                              if k.startswith(key))
                  + "; profiled D " + ", ".join(
                      f"{v:.3f}" for v in prof[key]["D_ms"])
                  + ", E " + ", ".join(f"{v:.3f}" for v in prof[key]["E_ms"])
                  + ", device work " + ", ".join(
                      f"{v:.1f}" for v in prof[key]["busy_ms"])
                  + f" ms; host-timed median {statistics.median(ts):.1f} "
                  f"ms [{min(ts):.1f}, {max(ts):.1f}]")
        table["profiles"][n] = prof
    return table


def _gather_table(order: list, runs: dict) -> dict:
    """Prints, per tree, the medians and ranges of worker_gather's timings
    (each process's median of its five repeats for the single-spec
    gather), and returns them."""
    def med(vals):
        return statistics.median(vals) if vals else None

    table = {}
    for n in order:
        rs = runs[n]
        t = {"single": {}, "links": {}}
        for name, res in rs[0]["single"].items():
            for key in res:
                per_proc = [statistics.median(r["single"][name][key])
                            for r in rs]
                t["single"][f"{name} {key}"] = per_proc
        for op in rs[0]["links"]:
            t["links"][op] = med([v for r in rs for v in r["links"][op]])
        for key in ("forward", "step"):
            prof = [r[f"{key}_profile"] for r in rs]
            t[f"{key}_link_ms"] = [p["link_ms"] for p in prof]
            t[f"{key}_link_torch_ms"] = [p["link_torch_ms"] for p in prof]
            t[f"{key}_busy_ms"] = [p["busy_ms"] for p in prof]
            t[f"{key}_kernel_a_ms"] = [p["kinds"]["kernel A"] for p in prof]
            t[f"{key}_ms"] = [v for r in rs for v in r[f"{key}_ms"]]
        table[n] = t
        print(f"{n}: single-spec gather, median per process (ms):")
        for k, v in t["single"].items():
            print(f"  {k:40s} " + " ".join(f"{x:.4f}" for x in v)
                  + f"  spread x{max(v) / min(v):.2f}")
        print(f"{n}: link ops, device-only median (ms): " + "; ".join(
            f"{k} {v:.4f}" for k, v in t["links"].items())
            + f"; sum {sum(t['links'].values()):.4f}")
        for key in ("forward", "step"):
            print(f"{n}: profiled {key}: link movement "
                  + ", ".join(f"{v:.3f}" for v in t[f"{key}_link_ms"])
                  + " ms (kernel A " + ", ".join(
                      f"{v:.3f}" for v in t[f"{key}_kernel_a_ms"])
                  + "; torch passes " + ", ".join(
                      f"{v:.3f}" for v in t[f"{key}_link_torch_ms"])
                  + "), device work " + ", ".join(
                      f"{v:.1f}" for v in t[f"{key}_busy_ms"])
                  + f" ms; {key} host-timed median "
                  f"{med(t[f'{key}_ms']):.1f} ms [{min(t[f'{key}_ms']):.1f}"
                  f", {max(t[f'{key}_ms']):.1f}]")
    return table


def _step_table(order: list, runs: dict, top: int = 15) -> dict:
    """Prints each tree's device ms per step (median of its runs) and the
    kernels whose median ms differs most from the first tree's; returns
    the medians by tree and kernel."""
    med = {}
    for n in order:
        keys = {k for r in runs[n] for k in r["kernels"]}
        med[n] = {k: statistics.median(r["kernels"].get(k, [0.0, 0])[0]
                                       for r in runs[n]) for k in keys}
        totals = [sum(v[0] for v in r["kernels"].values()) for r in runs[n]]
        print(f"{n}: device ms per step {statistics.median(totals):.3f} "
              f"(runs {', '.join(f'{v:.3f}' for v in totals)})")
    first = order[0]
    keys = set().union(*(med[n] for n in order))
    diff = sorted(keys, key=lambda k: -max(
        abs(med[n].get(k, 0.0) - med[first].get(k, 0.0)) for n in order))
    print(f"kernels by the largest change against {first} (median ms): "
          + " | ".join(order))
    for k in diff[:top]:
        print("  " + " | ".join(f"{med[n].get(k, 0.0):9.3f}" for n in order)
              + f"  {k[:110]}")
    return med


def worker(check: bool) -> dict:
    """Times this process's package (the first on sys.path)."""
    import torch

    chip_smoke = _smoke()
    from uresnet_pytorch_tpu_torch.ops.cuda import halo_conv as hc
    from uresnet_pytorch_tpu_torch.ops.tile_graph import build_tile_graph
    device = torch.device("cuda", 0)
    graphs = {4: _config4_graph(device)}
    with torch.no_grad():
        coords, values, nv = chip_smoke.events(chip_smoke.config3(), device)
        graphs[3] = build_tile_graph(coords, values, nv, chip_smoke.config3())
        cfg = chip_smoke.config_mink(chip_smoke.BATCH)
        blob = chip_smoke.event_blob(cfg, chip_smoke.BATCH)
        graphs["mink"] = build_tile_graph(
            *(torch.from_numpy(blob[k]).to(device)
              for k in ("coords", "values", "n_voxels")), cfg)
    out = {"package": hc.__file__, "shapes": {}, "errors": {}}
    for i, (name, cfg, lvl, t, cin, cout, dx) in enumerate(shapes()):
        level = graphs[cfg].levels[lvl]
        x, w, ep = _inputs(level, t, cin, cout, seed=i)
        if dx:
            # the d_x kernel (Cin, Cout) on the flipped stencil of a conv
            # Cout -> Cin: flip_weights of w's transpose
            w, ep = w.flip(0).contiguous(), None
        forms = {"raw": {}} if dx else {"bn_act": ep, "raw": {}}
        res = {}
        for form, kw in forms.items():
            def run():
                return hc.halo_conv(x, w, level.halo, t, 3, **kw)
            try:
                if check:
                    got = run().float()
                    ref = hc.halo_conv_plain(x, w, level.halo, t, 3,
                                             **kw).float()
                    scale = max(float(ref.abs().max()), 1e-30)
                    err = (got - ref).abs()
                    ok = bool((err / scale <= chip_smoke.HALO_ATOL
                               + chip_smoke.HALO_RTOL * ref.abs() / scale)
                              .all())
                    res[form + "_max_abs_err"] = float(err.max())
                    res[form + "_ok"] = ok
                res[form] = _time_ms(run)
            except RuntimeError as e:         # a variant that cannot launch
                out["errors"][f"{name} {form}"] = str(e)
                res[form] = None
        out["shapes"][name] = res
    return out


def _build(trees: dict) -> list:
    """Builds every tree's kernel library at once, one process each;
    prints each failed build's log and returns those trees' names."""
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", "from uresnet_pytorch_tpu_torch.ops import "
         "cuda; print(cuda.build())"], cwd=d, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name, d in trees.items()}
    failed = []
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            print(f"tree {name}: build failed\n{log}", flush=True)
            failed.append(name)
    return failed


def _run(tree: Path, check: bool, gather: bool, dw: bool,
         step: bool, extend: bool) -> dict:
    """One worker process: this file run as a script, with `tree` first on
    sys.path so that the package under test is that tree's."""
    res = subprocess.run([sys.executable, __file__, "--worker", str(tree)]
                         + ["--check", "this"] * check + ["--gather"] * gather
                         + ["--dw"] * dw + ["--step"] * step
                         + ["--extend"] * extend,
                         cwd=ROOT, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"tree {tree}: worker failed\n{res.stdout}"
                           f"{res.stderr}")
    line = [l for l in res.stdout.splitlines() if l.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", action="append", default=[],
                   help="NAME=DIR, a tree to time beside this one")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--check", action="append", default=[])
    p.add_argument("--gather", action="store_true",
                   help="time kernel A and the link ops instead, and "
                   "profile their share of a forward and a step")
    p.add_argument("--dw", action="store_true",
                   help="time kernel C (d_W) instead of kernel B")
    p.add_argument("--step", action="store_true",
                   help="profile a config-4 step instead, by kernel name")
    p.add_argument("--extend", action="store_true",
                   help="time kernels D and E instead, at the shapes of an "
                   "unfused config-3 forward and config-4 step")
    p.add_argument("--out", type=Path,
                   default=Path("build/bench_kernel_b.json"))
    p.add_argument("--worker", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        sys.path[:1] = [args.worker, str(ROOT)]
        res = worker_extend(bool(args.check)) if args.extend else \
            worker_step() if args.step else \
            worker_gather() if args.gather else \
            worker_dw(bool(args.check)) if args.dw else \
            worker(bool(args.check))
        print("RESULT", json.dumps(res))
        return 0
    trees = {"this": ROOT}
    for spec in args.tree:
        name, _, d = spec.partition("=")
        trees[name] = Path(d).resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    broken = _build(trees)
    order = [n for n in trees if n not in broken]
    runs = {name: [] for name in order}
    for r in range(args.rounds):
        for name in order + order[::-1]:
            # --extend: the yardsticks in the first process only
            check = (name == order[0] and not runs[name]) if args.extend \
                else name in args.check and r == 0
            res = _run(trees[name], check, args.gather, args.dw, args.step,
                       args.extend)
            runs[name].append(res)
            print(f"round {r} {name}: done", flush=True)
    if args.gather:
        table = _gather_table(order, runs)
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(
            {"device": smi, "trees": {n: str(d) for n, d in trees.items()},
             "gather": table, "runs": runs}, indent=1))
        return 1 if broken else 0
    if args.extend:
        table = _extend_table(order, runs)
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(
            {"device": smi, "trees": {n: str(d) for n, d in trees.items()},
             "extend": table, "runs": runs}, indent=1))
        return 1 if broken else 0
    if args.step:
        table = _step_table(order, runs)
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(
            {"device": smi, "trees": {n: str(d) for n, d in trees.items()},
             "step_ms_by_kernel": table, "runs": runs}, indent=1))
        return 1 if broken else 0
    first = order[0]
    print(f"{'shape':24s} {'form':6s} " + " ".join(
        f"{n[:14]:>16s}" for n in order) + "  (median ms of "
        f"{2 * args.rounds} runs, x{first} = ratio to {first})")
    table = {}
    forms = ("dw",) if args.dw else ("bn_act", "raw")
    for name, *_ in DW_SHAPES if args.dw else shapes():
        for form in forms:
            cells = {}
            for n in order:
                vals = [r["shapes"][name].get(form) for r in runs[n]]
                vals = [v for v in vals if v is not None]
                cells[n] = statistics.median(vals) if vals else None
            if all(v is None for v in cells.values()):
                continue
            table[f"{name} {form}"] = cells
            base = cells[first]
            print(f"{name:24s} {form:6s} " + " ".join(
                "            n/a " if v is None else
                f"{v:8.3f} x{v / base:5.2f} " if base else f"{v:8.3f}       "
                for v in cells.values()))
    for n in order:
        errors = sorted({k for r in runs[n] for k in r["errors"]})
        if errors:
            print(f"{n}: no launch at {', '.join(errors)}")
        checks = [(s, form, res[form + "_ok"], res[form + "_max_abs_err"])
                  for r in runs[n] for s, res in r["shapes"].items()
                  for form in forms if form + "_ok" in res]
        if checks:
            bad = [c for c in checks if not c[2]]
            print(f"{n}: {len(checks) - len(bad)} of {len(checks)} checks "
                  f"within the bound, max|err| "
                  f"{max(c[3] for c in checks):.3e}"
                  + "".join(f"; FAILED {s} {form}" for s, form, *_ in bad))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(
        {"device": smi, "trees": {n: str(d) for n, d in trees.items()},
         "table": table, "runs": runs}, indent=1))
    failed = [(n, s) for n in args.check if n in runs for r in runs[n]
              for s, res in r["shapes"].items()
              if any(res.get(f + "_ok") is False for f in forms)]
    if failed:
        print(f"checks failed: {failed}")
    if broken:
        print(f"not built: {broken}")
    return 1 if failed or broken else 0


if __name__ == "__main__":
    sys.exit(main())
