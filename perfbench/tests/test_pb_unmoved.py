"""The cells that were there before configurations could name their own
reference read as they did: each one's parameter tree (at its own
size), the work of its batches at tiny sizes, its limits and its metric
lists equal what the harness gave before (recorded from it)."""

import hashlib
import json

import pytest

from perfbench.core import harness
from perfbench.core.cells import load_cell
from perfbench.tests import tiny

SPARSE_INFER = ["device_idle_pct.infer", "mfu_pct.infer",
                "graph_build_ms.infer", "subm_conv_roofline_pct.infer",
                "torch_kernels_ms.infer", "span_graph_build_ms.infer",
                "span_norm_ms.infer", "idle_graph_build_ms.infer",
                "idle_forward_ms.infer", "cell_fill_pct.infer"]
SPARSE_TRAIN = ["device_idle_pct.train", "mfu_pct.train",
                "graph_build_ms.train", "subm_conv_roofline_pct.train",
                "torch_kernels_ms.train", "span_graph_build_ms.train",
                "span_norm_ms.train", "span_recompute_ms.train",
                "idle_graph_build_ms.train", "idle_forward_ms.train",
                "idle_backward_ms.train", "cell_fill_pct.train"]
DENSE_TRAIN = ["device_idle_pct.dense", "mfu_pct.dense",
               "torch_kernels_ms.dense", "dense_conv_roofline_pct",
               "span_norm_ms.dense"]
# workload: (parameter tree's digest, its leaves, work of batches
# [0, 1, 2, 0] of seed 3000000021 at tiny sizes, limits, end-to-end and
# per-layer metrics)
RECORDED = {
    "sparse16_infer_b8": (
        "5303fb2b7d66590c", 231,
        {"flops": 283915072.0, "sm_bound_s": 1.5079922388059699e-06,
         "dense_conv_bound_s": 0.0},
        {"logit_rel": 0.02, "event_rel_max": 0.025},
        ["infer_events_per_s", "infer_batch_p95_ms", "peak_mem_gib",
         "setup_s"], SPARSE_INFER),
    "sparse16_train_b8": (
        "5303fb2b7d66590c", 231,
        {"flops": 851745216.0, "sm_bound_s": 4.52397671641791e-06,
         "dense_conv_bound_s": 0.0},
        {"grad_cos_gap": 0.0007, "grad_gap_median": 0.015,
         "change_gap_median": 0.01},
        ["train_events_per_s", "peak_mem_gib", "setup_s"], SPARSE_TRAIN),
    "dense16_train_b8": (
        "f3b9f192a01a723b", 231,
        {"flops": 1246298112.0, "sm_bound_s": 0.0,
         "dense_conv_bound_s": 8.039699104477615e-06},
        {"grad_cos_gap": 0.002, "grad_gap_median": 0.015,
         "change_gap_median": 0.015},
        ["dense_train_events_per_s", "peak_mem_gib", "setup_s"],
        DENSE_TRAIN),
}


@pytest.mark.parametrize("workload", sorted(RECORDED))
def test_cell_reads_as_recorded(workload):
    digest, leaves, work, limits, e2e, per_layer = RECORDED[workload]
    cell = load_cell(workload)
    spec = cell.reference.param_spec(cell.model)
    got = hashlib.sha256(json.dumps(
        [[n, list(s), k] for n, s, k in spec]).encode()).hexdigest()[:16]
    assert (got, len(spec)) == (digest, leaves)
    assert cell.limits == limits
    assert [m["name"] for m in cell.end_to_end] == e2e
    assert [m["name"] for m in cell.per_layer] == per_layer
    mo, to = tiny.overrides(workload)
    run = harness.Run(load_cell(workload, model_overrides=mo,
                                traffic_overrides=to), 3000000021, "cpu")
    run.make_inputs()
    assert run.work([0, 1, 2, 0]) == pytest.approx(work, rel=1e-12)
    assert run.sparse == workload.startswith("sparse")
