"""The cell `mink34c_train_b8` (MinkUNet34C, `configs/minkunet34c_512.json`)
on the CPU at a tiny size: its own files through `run.execute` at the
model's five levels, a sound run correct and the half-batch fault not,
each of its readers with a number to read, and the reference's `work`
counting the stem over 125 offsets."""

import itertools
from types import SimpleNamespace

import pytest

from perfbench.core import harness, peaks
from perfbench.core.cells import load_cell
from perfbench.core.spans import Attribution
from perfbench.tests import tiny
from perfbench.tests.test_pb_faults import _half_batch

CELL = "mink34c_train_b8"
LEVELS = dict(uresnet_num_strides=5, tile_sizes=[4, 2, 2, 2, 2])
READERS = ["mfu_pct.mink", "device_idle_pct.mink",
           "subm_conv_roofline_pct.mink", "norm_act_roofline_pct.mink",
           "span_norm_ms.mink", "span_shortcut_ms.mink",
           "cell_fill_pct.mink", "span_recompute_ms.mink",
           "torch_kernels_ms.mink"]


def test_cell_reports_its_metrics():
    cell = load_cell(CELL)
    assert cell.reference.__file__.endswith("perfbench/reference/"
                                            "minkunet34c.py")
    assert [m["name"] for m in cell.end_to_end] == [
        "train_events_per_s", "peak_mem_gib", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == READERS
    assert cell.traffic["batch"] == 8 and cell.traffic_name == \
        "train_b8_v150k"


def test_sound_traced_run_is_correct_and_reads_the_tile_engine():
    from uresnet_pytorch_tpu_torch.utils import timing
    timing.reset_counters()
    res = tiny.execute(CELL, trace=1, **LEVELS)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    # a CPU window has no device time: only the counter's reader reads
    assert set(res["metrics"]) == {"cell_fill_pct.mink"}
    assert len(timing.counters()["active_cells"]) == 5


def test_half_batch_is_not_correct(monkeypatch):
    _half_batch(monkeypatch)
    res = tiny.execute(CELL, **LEVELS)
    assert not res["correct"], res["checks"]


class _Trace:
    """A traced window of one second with device rows by kernel name."""
    window_s = 1.0
    ROWS = {"void (anonymous namespace)::norm_act_apply_kernel<bf16>": 0.02,
            "void halo_conv_kernel<128>": 0.30,
            "void (anonymous namespace)::halo_extend_kernel<2, 8, 1>": 0.01,
            "sm90_xmma_wgrad_implicit_gemm": 0.02,
            "elementwise_kernel": 0.10}

    def busy_s(self):
        return sum(self.ROWS.values())

    def kernel_s(self, match):
        return sum(s for n, s in self.ROWS.items() if match(n))


def test_each_reader_reads_a_traced_window():
    """Every reader returns a number on a window with device rows in it
    (the kernels' names as the card's trace gives them, the spans'
    attribution, the work of real tiny batches and the tile engine's
    counters of a real traced tiny run)."""
    from uresnet_pytorch_tpu_torch.utils import timing
    timing.reset_counters()
    tiny.execute(CELL, trace=1, **LEVELS)
    mo, to = tiny.overrides(CELL, **LEVELS)
    run = harness.Run(load_cell(CELL, model_overrides=mo,
                                traffic_overrides=to), 3000000021, "cpu")
    run.make_inputs()
    spans = Attribution(
        device_us={("uresnet.step", "uresnet.stage.enc1", "uresnet.norm"):
                   4000.0,
                   ("uresnet.step", "uresnet.recompute.stage.enc1",
                    "uresnet.recompute.shortcut"): 1000.0,
                   ("uresnet.step", "uresnet.stage.dec0",
                    "uresnet.shortcut"): 2000.0},
        main_thread=1)
    ctx = SimpleNamespace(mode="train", batch=2, steps=2, trace=_Trace(),
                          prof=None, spans=spans, work=run.work([0, 1]),
                          graph_build_ms=None, peak_flops=peaks.PEAK_FLOPS,
                          peak_bytes=peaks.PEAK_BYTES)
    got = {m: harness.load_reader(m)(ctx) for m in READERS}
    assert all(isinstance(v, float) and v > 0 for v in got.values()), got
    assert got["span_norm_ms.mink"] == pytest.approx(2.0)
    assert got["span_shortcut_ms.mink"] == pytest.approx(1.5)
    assert got["device_idle_pct.mink"] == pytest.approx(55.0)
    assert got["span_recompute_ms.mink"] == pytest.approx(0.5)
    # glue: the elementwise kernel alone, not norm_act, B, D or cuDNN
    assert got["torch_kernels_ms.mink"] == pytest.approx(50.0)
    for m in READERS:
        if "roofline" in m or "mfu" in m:
            assert got[m] < 100.0, (m, got[m])


def _pairs(sites, k):
    h = k // 2
    offs = list(itertools.product(range(-h, h + 1), repeat=3))
    return sum((b, x + o[0], y + o[1], z + o[2]) in sites
               for (b, x, y, z) in sites for o in offs)


def test_work_counts_the_stem_over_125_offsets():
    """The reference's `work` against a brute-force count: sites and
    (site, neighbour) pairs by sets of coordinates, 125 offsets for the
    stem and 27 for every block's conv, a stride-2 conv and a transposed
    one 2 Cin Cout a fine site, a projection and the head 2 Cin Cout a
    site. And the batch norm's bytes at level 0 alone."""
    mo, to = tiny.overrides(CELL, **LEVELS)
    cell = load_cell(CELL, model_overrides=mo, traffic_overrides=to)
    ref = cell.reference
    run = harness.Run(cell, 3000000021, "cpu")
    run.make_events()
    blob = run.blobs[0]
    coords = [blob["coords"][b, :int(n)]
              for b, n in enumerate(blob["n_voxels"])]
    import torch
    got = ref.work(cell.model, [torch.as_tensor(c) for c in coords])
    levels = [{(b, *(int(v) >> l for v in c)) for b, cs in enumerate(coords)
               for c in cs} for l in range(5)]
    sites = [len(s) for s in levels]
    stem_pairs = _pairs(levels[0], 5)
    assert stem_pairs > _pairs(levels[0], 3)
    flops = 0.0
    for name, l, cin, cout in ref.blocks():
        if name == "stem":
            flops += 2.0 * stem_pairs * cin * cout
        elif name.startswith("down"):
            flops += 2.0 * sites[l - 1] * cin * cout
        elif name.startswith("up"):
            flops += 2.0 * sites[l] * cin * cout
        elif name == "head":
            flops += 2.0 * sites[0] * cin * cell.model["num_class"]
        else:
            p = _pairs(levels[l], 3)
            flops += 2.0 * p * (cin * cout + cout * cout)
            if cin != cout:
                flops += 2.0 * sites[l] * cin * cout
    assert got["flops"] == pytest.approx(flops, rel=1e-12)
    assert got["sm_bound_s"] > 0 and got["dense_conv_bound_s"] == 0.0
    # level 0: the stem's BN (32), up0's (96), and two blocks at 96 (the
    # first with a projection): 8 elements a channel, 12 with the residual
    assert ref.norm_bytes([1, 0, 0, 0, 0]) == 2 * (
        32 * 8 + 96 * 8 + 96 * 8 + 2 * (96 * 8 + 96 * 12))
