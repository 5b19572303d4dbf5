"""The port's spans and counters (`uresnet_pytorch_tpu_torch/utils/timing.py`)
on the CPU: with no profiler a span makes no dispatcher call and the
counters stay empty; under a profiler a step has one graph build, one
`uresnet.norm` per BN call, recompute spans exactly where the remat mode
recomputes; tracing leaves the step's numbers bitwise as they were; and
the tile engine's fill counters equal brute-force counts."""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from uresnet_pytorch_tpu_torch.config import URESNetConfig as TConfig
from uresnet_pytorch_tpu_torch.models import uresnet_dense
from uresnet_pytorch_tpu_torch.models import uresnet_sparse_tiled as tiled
from uresnet_pytorch_tpu_torch.ops.tile_graph import (tile_capacity_at,
                                                      tile_size_at)
from uresnet_pytorch_tpu_torch.trainval import TrainVal
from uresnet_pytorch_tpu_torch.utils import timing
from tests.test_torch_model import one_torch_thread  # noqa: F401
from tests.test_torch_train import _KW, _blob

MODELS = {"sparse": dict(_KW, compute_dtype="float32"),
          "dense": dict(_KW, model_name="uresnet_dense",
                        compute_dtype="float32")}
BNACT = {"sparse": tiled.BNAct, "dense": uresnet_dense.BNAct}


def _trainval(model, **kw):
    cfg = TConfig(**dict(MODELS[model], **kw))
    tv = TrainVal(cfg, device="cpu")
    tv.initialize()
    return tv, _blob(cfg)


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, Counter(e.name for e in prof.events()
                        if e.name.startswith(timing.PREFIX))


@pytest.fixture(autouse=True)
def fresh_counters():
    timing.reset_counters()
    yield
    timing.reset_counters()


@pytest.fixture
def enter_calls(monkeypatch):
    """The program's calls of the op every `record_function` enters by
    (torch's optimizer makes its own, profiler or not)."""
    ns = torch.ops.profiler
    real = ns._record_function_enter_new
    calls = []

    def counted(*a, **k):
        if a[0].startswith(timing.PREFIX):
            calls.append(a[0])
        return real(*a, **k)
    monkeypatch.setattr(ns, "_record_function_enter_new", counted)
    return calls


@pytest.mark.parametrize("model", ["sparse", "dense"])
def test_no_profiler_no_span_no_count(model, enter_calls):
    tv, blob = _trainval(model, remat_mode="stage_dots")
    tv.train_step(blob)
    tv.forward(blob)
    assert enter_calls == []
    assert timing.counters() == {}
    # the same calls under a profiler do enter (the patch sees them)
    _traced(lambda: tv.forward(blob))
    assert "uresnet.step" in enter_calls


def test_span_is_a_shared_null_context_when_off():
    assert not timing.tracing()
    assert timing.span("norm") is timing.span("conv")


def _bn_calls(model, tv):
    """BNAct forwards, by whether autograd's engine ran them (recompute)."""
    calls = Counter()

    def hook(*_):
        calls[torch._C._current_graph_task_id() != -1] += 1
    for m in tv.model.modules():
        if isinstance(m, BNACT[model]):
            m.register_forward_hook(hook)
    return calls


@pytest.mark.parametrize("model,remat", [("sparse", "stage_dots"),
                                         ("sparse", "stage"),
                                         ("sparse", "none"),
                                         ("dense", "none")])
def test_traced_train_step_spans(model, remat):
    tv, blob = _trainval(model, remat_mode=remat)
    tv.train_step(blob)
    calls = _bn_calls(model, tv)
    _, spans = _traced(lambda: tv.train_step(blob))
    for name in ("step", "h2d", "loss", "backward", "optimizer",
                 "stage.stem", "stage.head", "reorder"):
        assert spans[timing.PREFIX + name] == 1, name
    assert spans["uresnet.graph_build"] == (model == "sparse")
    assert spans["uresnet.norm"] == calls[False] > 0
    assert spans["uresnet.recompute.norm"] == calls[True]
    recomputed = sum(v for k, v in spans.items() if ".recompute." in k)
    # the dense model recomputes every block whatever remat_mode says
    if model == "sparse" and remat == "none":
        assert recomputed == 0 and calls[True] == 0
    else:
        assert calls[True] > 0
        assert spans["uresnet.recompute.stage.head" if model == "sparse"
                     else "uresnet.recompute.stage.enc0_block0"] == 1


@pytest.mark.parametrize("model", ["sparse", "dense"])
def test_traced_eval_forward_spans(model):
    tv, blob = _trainval(model)
    calls = _bn_calls(model, tv)
    _, spans = _traced(lambda: tv.forward(blob))
    assert spans["uresnet.step"] == spans["uresnet.loss"] == 1
    assert spans["uresnet.graph_build"] == (model == "sparse")
    assert spans["uresnet.norm"] == calls[False] > 0
    assert not [k for k in spans if ".recompute." in k]
    if model == "sparse":
        assert spans["uresnet.conv"] > 0 and spans["uresnet.resample"] > 0


@pytest.mark.parametrize("model,remat", [("sparse", "stage_dots"),
                                         ("dense", "none")])
def test_traced_step_is_bitwise_the_untraced_step(model, remat):
    (a, blob), (b, _) = (_trainval(model, remat_mode=remat)
                         for _ in range(2))
    ma = a.train_step(blob)
    mb, _ = _traced(lambda: b.train_step(blob))
    assert torch.equal(ma["loss"], mb["loss"])
    pa, pb = dict(a.model.named_parameters()), dict(b.model.named_parameters())
    for k in pa:
        assert torch.equal(pa[k].grad, pb[k].grad), k
        assert torch.equal(pa[k], pb[k]), k
    ba, bb = dict(a.model.named_buffers()), dict(b.model.named_buffers())
    assert ba and all(torch.equal(ba[k], bb[k]) for k in ba)


def _brute_fill(cfg, blob):
    """Per level: live tiles and active cells from the coordinates, and
    capacity cells B x T_l x t_l^d."""
    live, active, cap = [], [], []
    T = tile_capacity_at(cfg, 0)
    B = len(blob["n_voxels"])
    for l in range(cfg.uresnet_num_strides):
        t = tile_size_at(cfg, l)
        if l:
            T = min(tile_capacity_at(cfg, l), T)
        cells = tiles = 0
        for b in range(B):
            c = blob["coords"][b, :blob["n_voxels"][b]] >> l
            cells += len(np.unique(c, axis=0))
            tiles += len(np.unique(c // t, axis=0))
        live.append(tiles)
        active.append(cells)
        cap.append(B * T * t ** cfg.data_dim)
    return {"live_tiles": live, "active_cells": active,
            "capacity_cells": cap}


@pytest.mark.parametrize("calls", [1, 2])
def test_fill_counters_match_brute_force(calls):
    tv, blob = _trainval("sparse")
    for _ in range(calls):
        out, _ = _traced(lambda: tv.forward(blob))
        assert int(out["tile_spill"]) == 0
    want = _brute_fill(tv.cfg, blob)
    assert timing.counters() == {k: [calls * x for x in v]
                                 for k, v in want.items()}
