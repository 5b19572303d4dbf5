"""One traced window of a cell, broken down by the program's spans:

    python3 perfbench/breakdown.py --workload <name> --seed <n>
        [--seconds 4] [--out chiprun_out/breakdown.jsonl]

Set-up and the window as `run.py --trace 1` makes them (no comparison with
the reference), then `core/spans.py`'s attribution: device ms and idle ms
per batch or step by leaf bucket (the innermost span, or `outside`), and
the check that the buckets add up to the window's device rows and to its
idle time; then the tile engine's live, active and capacity counts per
level. One JSON line goes to `--out`.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--out", default="chiprun_out/breakdown.jsonl")
    args = ap.parse_args(argv)

    import torch
    from perfbench.core import harness, peaks, spans
    from perfbench.core.cells import load_cell
    from perfbench.core.trace import Trace
    from uresnet_pytorch_tpu_torch.utils import timing

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    torch.set_num_threads(4)
    run = harness.Run(cell, args.seed)
    run.setup()
    seconds = args.seconds or float(cell.traffic["trace_seconds"])
    w = run.window(seconds, True)
    t0 = time.perf_counter()
    tr = Trace(w.prof)
    att = spans.attribute(*spans.records(w.prof), tr.w0, tr.w1,
                          tr.busy_intervals())
    build_s = time.perf_counter() - t0
    n = w.batches
    dev, idle = att.leaves("device"), att.leaves("idle")
    rows_us = sum(b - a for _, a, b in tr.dev)
    idle_us = 1e6 * (tr.window_s - tr.busy_s())
    unit = "batch" if cell.mode == "infer" else "step"
    print(f"{cell.name} seed {args.seed}: {n} x {unit} in "
          f"{tr.window_s:.3f} s; {torch.cuda.get_device_name()}; "
          f"{peaks.card_state()}")
    print(f"{'leaf bucket':40s} {'device ms':>10s} {'idle ms':>9s} "
          f"(per {unit})")
    for k in sorted(set(dev) | set(idle), key=lambda k: -dev.get(k, 0)):
        print(f"{k:40s} {dev.get(k, 0) / 1e3 / n:10.3f} "
              f"{idle.get(k, 0) / 1e3 / n:9.3f}")
    print(f"device: buckets {sum(dev.values()):.1f} us, rows "
          f"{rows_us:.1f} us; idle: buckets {sum(idle.values()):.1f} us, "
          f"window - busy {idle_us:.1f} us; attribution {build_s:.2f} s")
    counts = timing.counters() if hasattr(timing, "counters") else {}
    for k, v in counts.items():
        print(f"{k}: {v}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as f:
        f.write(json.dumps({
            "workload": cell.name, "seed": args.seed, "steps": n,
            "window_s": tr.window_s, "busy_s": tr.busy_s(),
            "device_us": dev, "idle_us": idle, "rows_us": rows_us,
            "idle_total_us": idle_us, "attribution_s": build_s,
            "device_paths": [[list(p), us] for p, us in sorted(
                att.device_us.items(), key=lambda kv: -kv[1])],
            "idle_paths": [[list(p), us] for p, us in sorted(
                att.idle_us.items(), key=lambda kv: -kv[1])],
            "counters": counts}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
