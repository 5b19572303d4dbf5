"""The comparison that decides `correct`, on the CPU at tiny sizes:
a sound run passes each cell's limits; the run with the timed path broken
underneath fails them, once for each fault the cell can have; and the
control, the reference in float8 in the program's place, fails them."""

import numpy as np
import pytest
import torch

from perfbench.core import harness
from perfbench.core.cells import load_cell
from perfbench.reference.common import Quant
from perfbench.tests import tiny

TRAIN = ["sparse16_train_b8", "dense16_train_b8"]
INFER = ["sparse16_infer_b8"]


@pytest.mark.parametrize("workload", INFER + TRAIN)
def test_sound_run_is_correct(workload):
    res = tiny.execute(workload)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0


def _half_batch(monkeypatch):
    """Half of each batch left out: the second half's events lose their
    voxels, so the loss is the mean over the rest."""
    from uresnet_pytorch_tpu_torch.trainval import TrainVal
    orig = TrainVal._batch

    def half(self, blob):
        batch = orig(self, blob)
        n = batch["n_voxels"].clone()
        n[len(n) // 2:] = 0
        batch["n_voxels"] = n
        return batch
    monkeypatch.setattr(TrainVal, "_batch", half)


def _unchanged_state(monkeypatch):
    """A step that returns its state unchanged."""
    from uresnet_pytorch_tpu_torch import trainval
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    monkeypatch.setattr(trainval, "commit_batch_moments", lambda m: None)


def _altered_answer(monkeypatch):
    """One event's answer altered where it is produced: its classes
    rotated."""
    from uresnet_pytorch_tpu_torch.trainval import TrainVal
    orig = TrainVal.forward

    def altered(self, blob):
        out = orig(self, blob)
        sm = out["softmax"].clone()
        sm[0] = sm[0].roll(1, dims=-1)
        out["softmax"] = sm
        return out
    monkeypatch.setattr(TrainVal, "forward", altered)


FAULTS = ([(w, f) for w in TRAIN for f in (_half_batch, _unchanged_state)]
          + [(w, f) for w in INFER for f in (_half_batch, _altered_answer)])


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w}-{f.__name__.strip('_')}"
                              for w, f in FAULTS])
def test_fault_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch)
    res = tiny.execute(workload)
    assert not res["correct"], res["checks"]


def _control_numbers(workload):
    mo, to = tiny.overrides(workload)
    cell = load_cell(workload, model_overrides=mo, traffic_overrides=to)
    run = harness.Run(cell, 3000000007, "cpu")
    run.make_inputs()
    if cell.mode == "train":
        ref = run.reference_run_steps(3)
        run.prog_train = run.reference_run_steps(3, Quant("fp8"))
    else:
        run.kept = [(i, None) for i in range(2)]
        ref = run.reference_run()
        run.kept = run.served_as(run.reference_run(Quant("fp8")))
    return cell, run.numbers(ref)


@pytest.mark.parametrize("workload", INFER + TRAIN)
def test_control_is_not_correct(workload):
    cell, numbers = _control_numbers(workload)
    broken = [k for k, lim in cell.limits.items()
              if not np.isfinite(numbers[k]) or numbers[k] > lim]
    assert broken, (numbers, cell.limits)
