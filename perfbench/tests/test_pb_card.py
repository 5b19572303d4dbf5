"""On the card: one short run of each cell through the entry point, as
the driver runs it. Skips without a CUDA card."""

import json
import subprocess
import sys

import pytest

from perfbench.core.cells import ROOT, manifest


@pytest.mark.card
@pytest.mark.parametrize("workload",
                         [w["name"] for w in manifest()["workloads"]
                          if w["chips"] == 1])
def test_cell_runs_on_the_card(card, workload):
    res = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", workload,
         "--seed", "2147483999", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=1200, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
