"""The readings a cell's limits are set from (`perfbench/limits/`), on the
card at the cell's own size, many seeds in one process:

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,3
        [--control-seeds 4,5,6] [--fault-seeds 7,8,9]
        [--exchange-seeds 10,11,12] [--seconds 3]
        [--out chiprun_out/calibrate.jsonl]

- program: the cell's timed path (a short window at the cell's own load
  for inference; the first training steps, which need no window) against
  the float32 reference: the lower readings;
- control: the reference computed in float8 e4m3 (the precision below the
  configurations' bfloat16) in the program's place: the upper readings
  (no program runs, so one card serves a cell over several: the
  reference runs the global batch);
- faults (training cells): the reference with half of each batch left
  out, the loss's mean over the rest; over several cards, the reference
  with the exchange between cards left out: rank 0's shard of each batch
  alone (its BN moments, loss and gradient over its own events); a step
  that leaves the state unchanged reads 1 by the gradient and change gaps
  and needs no run.

One JSON line per reading goes to `--out`; the benchmark's own runs never
run the control or the faults.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _seeds(s: str) -> list:
    return [int(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--fault-seeds", type=_seeds, default=[])
    ap.add_argument("--exchange-seeds", type=_seeds, default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="chiprun_out/calibrate.jsonl")
    args = ap.parse_args(argv)

    import torch
    from perfbench.core import harness
    from perfbench.core.cells import load_cell
    from perfbench.reference.common import Quant

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    out = open(args.out, "a")

    def emit(kind, seed, numbers, t0, detail=None):
        row = {"workload": cell.name, "kind": kind, "seed": seed,
               "numbers": numbers, "seconds": time.perf_counter() - t0,
               "detail": detail}
        print(json.dumps(row), flush=True)
        out.write(json.dumps(row) + "\n")
        out.flush()

    jobs = ([("program", s) for s in args.seeds]
            + [("control", s) for s in args.control_seeds]
            + [("half_batch", s) for s in args.fault_seeds]
            + [("exchange", s) for s in args.exchange_seeds])
    for kind, seed in jobs:
        t0 = time.perf_counter()
        run = harness.Run(cell, seed, "cuda")
        if kind == "program":
            harness.measure(run, args.seconds, trace=False)
            run.free_program()
            detail = {}
            emit(kind, seed, run.numbers(run.reference_run(), detail), t0,
                 detail)
        elif cell.mode == "train":
            # the reference in the program's place: no program runs
            run.make_inputs()
            n = harness.CHECKED_STEPS
            ref = run.reference_run_steps(n)
            if kind == "exchange":
                rows = run.batch // cell.chips
                run.blobs = [{k: v[:rows] for k, v in b.items()}
                             for b in run.blobs]
            bad = run.reference_run_steps(
                n, quant=Quant("fp8") if kind == "control" else None,
                half_batch=kind == "half_batch")
            run.prog_train = bad
            detail = {}
            emit(kind, seed, run.numbers(ref, detail), t0, detail)
        else:
            run.make_inputs()
            run.kept = [(i, None) for i in range(
                int(cell.traffic["checked_batches"]))]
            ref = run.reference_run()
            run.kept = run.served_as(run.reference_run(Quant("fp8")))
            emit(kind, seed, run.numbers(ref), t0)
        del run
        torch.cuda.empty_cache()
    out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
