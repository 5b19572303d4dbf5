"""The cell over four cards on the CPU, at tiny sizes: four gloo ranks
through the port's `parallel.launch`, each a `TrainVal` on its data
mesh, against the reference over the global batch. A sound run is
correct; a rank fault planted in every rank, the reference given only
rank 0's events, and the float8 control are not; a rank that loads JAX
gives no result. The cell runs from a checkout whose manifest adds its
entries (`tiny.dp4_root`)."""

import numpy as np
import pytest

from perfbench import reference
from perfbench.core import harness
from perfbench.core.cells import load_cell
from perfbench.core.guard import ForbiddenModules
from perfbench.reference.common import Quant
from perfbench.tests import rank_faults, tiny

DP4 = tiny.DP4
RANKS = 4


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.dp4_root(tmp_path_factory.mktemp("dp4"))


def test_sound_run_is_correct(root):
    res = tiny.execute(DP4, root=root)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0
    assert res["device"]["count"] == RANKS
    # every rank's events: whole global batches
    batch = tiny.overrides(DP4, root)[1]["batch"]
    assert res["attempted"] > 0 and res["attempted"] % batch == 0
    assert set(res["metrics"]) == {"dp4_train_events_per_s", "peak_mem_gib",
                                   "setup_s"}


FAULTS = [rank_faults.skip_gradient_allreduce, rank_faults.half_batch,
          rank_faults.unchanged_state]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_rank_fault_is_not_correct(root, fault):
    res = tiny.execute(DP4, rank_setup=fault, root=root)
    assert not res["correct"], res["checks"]


def test_rank_that_loads_jax_gives_no_result(root):
    with pytest.raises(ForbiddenModules, match="jax"):
        tiny.execute(DP4, rank_setup=rank_faults.load_jax, root=root)


def test_reference_of_rank0_events_alone_is_not_correct(root, monkeypatch):
    """The reference fed only rank 0's shard of each global batch (its
    BN moments and loss over those events) disagrees with the mesh."""
    orig = reference.train_steps

    def rank0(mod, model, params, blobs, *a, **k):
        per = len(blobs[0]["n_voxels"]) // RANKS
        return orig(mod, model, params,
                    [{key: v[:per] for key, v in b.items()} for b in blobs],
                    *a, **k)
    monkeypatch.setattr(reference, "train_steps", rank0)
    res = tiny.execute(DP4, root=root)
    assert not res["correct"], res["checks"]


def test_control_is_not_correct(root):
    """The reference in float8 in the program's place, over the global
    batch: no rank runs."""
    mo, to = tiny.overrides(DP4, root)
    cell = load_cell(DP4, root=root, model_overrides=mo,
                     traffic_overrides=to)
    run = harness.Run(cell, 3000000007, "cpu")
    run.make_inputs()
    ref = run.reference_run_steps(3)
    run.prog_train = run.reference_run_steps(3, Quant("fp8"))
    numbers = run.numbers(ref)
    broken = [k for k, lim in cell.limits.items()
              if not np.isfinite(numbers[k]) or numbers[k] > lim]
    assert broken, (numbers, cell.limits)
