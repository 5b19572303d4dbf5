"""The benchmark of the PyTorch/CUDA port (`uresnet_pytorch_tpu_torch`).

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

runs one cell of `BENCHMARK.json`: set-up (events, weights, the program,
warm-up), the measured window, then the comparison with the plain
reference. A cell on one card runs in this process; a cell over several
runs one rank process a card (`core/ranks.py`), and this process, the
parent, prints the result and runs the reference once they have exited.
It prints the port's launch and tile-engine counters and
the card's state, then, as its last line on standard output, one JSON
object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with `--trace 1` its per-layer ones), `device`,
with `--trace 1` a `breakdown`, and last `checks`, each compared number
with its limit, which also end standard error.

It exits non-zero, printing no result, where there is no CUDA card or
fewer cards than the cell asks for, and where JAX or the JAX package has
been loaded by the time the window closes, in this process or in a rank
(`core/guard.py`).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# every build and kernel cache inside the checkout, at fixed paths
_CACHE = ROOT / "build" / "perfbench_cache"
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(_CACHE / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(_CACHE / "triton"))
os.environ.setdefault("USE_FLAX", "0")

from perfbench.core.guard import ForbiddenModules, forbidden_modules  # noqa: E402,F401

# the host's torch threads: load from one process with few threads
HOST_THREADS = 4


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(args, device="cuda", model_overrides=None, traffic_overrides=None,
            t_start=None, log=print, root=ROOT, rank_setup=None) -> dict:
    """One run of the cell as the files under `root` define it; returns
    the result object (the last line's content). `rank_setup` runs first
    in each rank process of a cell over several cards."""
    import torch
    from perfbench.core import check, harness, peaks
    from perfbench.core.cells import load_cell

    cell = load_cell(args.workload, root=root,
                     model_overrides=model_overrides,
                     traffic_overrides=traffic_overrides)
    torch.set_num_threads(HOST_THREADS)
    run = harness.Run(cell, args.seed, device,
                      T_START if t_start is None else t_start)
    trace = bool(args.trace)
    seconds = args.seconds
    if trace:
        seconds = min(seconds, float(cell.traffic["trace_seconds"]))
    w = harness.measure(run, seconds, trace, rank_setup)

    cuda = run.cuda
    log(f"card: {peaks.card_state() if cuda else 'none (cpu)'}")
    if getattr(w, "phases", None):
        log("seconds of the run's phases: " + ", ".join(
            f"{k} {v:.1f}" for k, v in w.phases.items()))
    if cuda:
        log(f"device: {torch.cuda.get_device_name(run.device)}, "
            f"{torch.cuda.device_count()} visible, {cell.chips} used")
    unit = "batch" if cell.mode == "infer" else "step"
    if getattr(w, "launches", None) is not None:
        log(f"port kernel launches per {unit}: " + ", ".join(
            f"{k} {v:.2f}" for k, v in w.launches.items()))
    log(f"tile-engine counters over the window ({w.batches} {unit}es): "
        + ", ".join(f"{k} {v}" for k, v in w.counters.items()))
    if w.times:
        third = max(1, len(w.times) // 3)
        log(f"mean batch ms, first and last third of the window: "
            f"{1e3 * sum(w.times[:third]) / third:.2f}, "
            f"{1e3 * sum(w.times[-third:]) / third:.2f}")

    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(run.device) if cuda
              else "cpu", "count": cell.chips,
              "memory_peak_bytes": int(w.peak_bytes)}
    result = {"attempted": w.batches * run.batch, "failed": w.failed}
    if trace:
        metrics, busy_s, window_s, breakdown = w.layers
        device.update(busy_s=busy_s, window_s=window_s)
    else:
        metrics = harness.end_to_end(cell, w, w.setup_s)
        breakdown = None
    w.prof = None

    run.free_program()
    t_ref = time.perf_counter()
    numbers = run.numbers(run.reference_run())
    log(f"reference and comparison: {time.perf_counter() - t_ref:.1f} s")
    log("not compared: " + ", ".join(f"{k} {v:.4g}" for k, v in
                                     numbers.items() if k not in cell.limits))
    correct, shown = check.judge(numbers, cell.limits)
    result.update(correct=correct, metrics=metrics, device=device)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = shown
    return result


def main(argv=None) -> int:
    args = parse(argv)
    import torch
    from perfbench.core.cells import load_cell
    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark measures the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    try:
        result = execute(args)
    except ForbiddenModules as e:
        print(f"forbidden modules loaded in a rank: {e}", file=sys.stderr)
        return 3
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k} = {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
