"""A model family added as files only: a checkout of its own (a
temporary root) holds a manifest, a configuration that names its own
reference file, that file, a traffic mix, limits and a per-layer
metric's reader, and nothing of `perfbench/` is edited. The cell runs
through `run.execute` on the CPU, is correct, and reads its work from
its own reference's `work`.

The toy is the port's row-gather engine (`sparse_engine: gather`), which
no cell runs and whose model has the sparse U-ResNet's mathematics; its
reference counts a forward's work as its stem's alone, a count no other
module gives."""

import json

from perfbench import run
from perfbench.core import harness
from perfbench.core.cells import load_cell
from perfbench.tests import tiny

TOY_REFERENCE = '''
"""The toy family's plain reference: the sparse U-ResNet's mathematics;
its work is the stem's alone."""
from perfbench.reference.sparse import (SparseUResNet, infer,  # noqa: F401
                                        loss_and_grads, param_spec)


def net(model, quant=None):
    return SparseUResNet(model, quant)


def work(model, coords):
    voxels = sum(len(c) for c in coords)
    return {"flops": 2.0 * 27 * voxels * model["uresnet_filters"],
            "sm_bound_s": 0.0, "dense_conv_bound_s": 0.0}
'''

TOY_READER = '''
def read(ctx):
    return ctx.work["flops"] / ctx.steps
'''


def _toy_root(tmp_path):
    base = load_cell("sparse16_train_b8")
    model = dict(base.model, **tiny.SPARSE, sparse_engine="gather")
    files = {
        "BENCHMARK.json": {
            "command": ["python3", "perfbench/run.py"],
            "paths": ["perfbench"], "run_seconds": 1,
            "configs": [{"name": "toy", "source": "a test's own",
                         "file": "perfbench/configs/toy.json",
                         "reduced": [], "why": "a toy family"}],
            "workloads": [{"name": "toy.train", "config": "toy",
                           "traffic": "toy_train", "chips": 1,
                           "why": "a toy cell"}],
            "end_to_end": [
                {"name": "toy_train_events_per_s", "unit": "events/s",
                 "better": "higher", "bound": 0.05, "source": "host_clock"},
                {"name": "setup_s", "unit": "s", "better": "lower",
                 "bound": 0.25, "source": "host_clock"}],
            "per_layer": [
                {"name": "toy_flops_per_step", "unit": "FLOP",
                 "better": "higher", "source": "program_counter",
                 "layer": "whole step", "moves": "toy_train_events_per_s"}]},
        "perfbench/configs/toy.json": {
            "reference": "perfbench/reference/toy.py", "model": model},
        "perfbench/traffic/toy_train.json": dict(
            base.traffic, **tiny.overrides("sparse16_train_b8")[1]),
        "perfbench/limits/toy.train.json": {
            k: {"limit": v} for k, v in base.limits.items()},
        "perfbench/reference/toy.py": TOY_REFERENCE,
        "perfbench/metrics/toy_flops_per_step.py": TOY_READER,
    }
    for name, body in files.items():
        path = tmp_path / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(body if isinstance(body, str) else json.dumps(body))
    return tmp_path


def test_family_of_files_runs_and_is_correct(tmp_path):
    root = _toy_root(tmp_path)
    cell = load_cell("toy.train", root=root)
    assert cell.reference.__file__ == str(root / "perfbench/reference/toy.py")
    args = run.parse(["--workload", "toy.train", "--seed", "3000000031",
                      "--seconds", "1", "--trace", "1"])
    res = run.execute(args, device="cpu", root=root, log=lambda *a: None)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    # the toy's own count, three forwards a step
    r = harness.Run(cell, 3000000031, "cpu")
    r.make_events()
    per_step = 3 * 2.0 * 27 * cell.model["uresnet_filters"] * sum(
        int(n) for n in r.blobs[0]["n_voxels"])
    assert r.work([0])["flops"] == per_step
    assert res["metrics"]["toy_flops_per_step"]["value"] > 0
    args.trace = 0
    res = run.execute(args, device="cpu", root=root, log=lambda *a: None)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"toy_train_events_per_s", "setup_s"}
