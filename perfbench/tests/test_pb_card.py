"""On the card: one short run of each cell through the entry point, as
BENCHMARK.json's command runs it. Skips without a CUDA card, or with
fewer cards than the cell takes."""

import json
import subprocess
import sys

import pytest

from perfbench.core.cells import ROOT, load_cell, manifest


@pytest.mark.card
@pytest.mark.parametrize("workload",
                         [w["name"] for w in manifest()["workloads"]])
def test_cell_runs_on_the_card(card, workload):
    import torch
    chips = load_cell(workload).chips
    if torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} cards")
    res = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", workload,
         "--seed", "2147483999", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=1200, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
