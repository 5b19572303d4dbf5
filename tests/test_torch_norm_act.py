"""The BN operator (`uresnet_pytorch_tpu_torch/ops/cuda/norm_act.py`) on the
CPU, held to the chain of torch ops that the models ran before it (copied
below as `_chain`, the masked BN of `MaskedBatchNorm` with `BNAct`'s
activation and `_bn_flat`'s re-mask, and the dense `BatchNorm` with its
`BNAct`):

- the models' CPU path (`norm_act` on a CPU tensor) equals the chain
  bitwise: output, recorded moments, and the gradients autograd takes;
- the four kernels' math in plain torch (`stats_plain`, `apply_plain`,
  `bwd_reduce_plain`, `bwd_apply_plain`, composed by the registered
  operator's forward and backward) equals the chain's autograd in f64 and
  f32: output, moments, d_x, d_scale, d_bias; over masked (with and
  without the re-mask) and dense rows, single tensors and pairs, slopes 0
  and 0.1, train and eval, a constant channel (the variance's clamp at 0)
  and an all-false mask (the count's clamp at 1), C in {12, 16, 80};
- a CPU tensor launches no kernel; moments recorded under recompute
  (`torch.utils.checkpoint`) are committed once.

The kernels themselves are held to these plain versions on the card by
chip_smoke.py (phase 16)."""

import pytest
import torch
from torch.utils.checkpoint import checkpoint

from uresnet_pytorch_tpu_torch.config import URESNetConfig as TConfig
from uresnet_pytorch_tpu_torch.models import uresnet_dense
from uresnet_pytorch_tpu_torch.models import uresnet_sparse_tiled as tiled
from uresnet_pytorch_tpu_torch.models.norm import commit_batch_moments
from uresnet_pytorch_tpu_torch.ops.cuda import norm_act as na
from uresnet_pytorch_tpu_torch.trainval import TrainVal
from tests.test_torch_model import one_torch_thread  # noqa: F401
from tests.test_torch_train import _KW, _blob

EPS = 1e-4


# -- the chain as the models ran it -----------------------------------------

def _act(v, s):
    return torch.where(v >= 0, v, s * v) if s > 0 else torch.relu(v)


def _chain(x, mask, scale, bias, mean, var, *, train, remask, folded, slope,
           dtype):
    """(y, moments): the masked BN with act, cast and re-mask, or the
    dense flax BN over (B, C, *S) with act and cast."""
    moments = None
    if folded:
        pair = isinstance(x, tuple)
        parts = x if pair else (x,)
        if train:
            acc = torch.float64 if parts[0].dtype == torch.float64 \
                else torch.float32
            m = mask[..., None].to(acc)
            red = tuple(range(parts[0].dim() - 1))
            xfs = [p.to(acc) * m for p in parts]
            s1 = torch.cat([xf.sum(red) for xf in xfs])
            s2 = torch.cat([(xf * xf).sum(red) for xf in xfs])
            count = m.sum().clamp(min=1.0)
            mean = s1 / count
            var = torch.maximum(s2 / count - mean * mean,
                                torch.zeros_like(mean))
            moments = (mean.detach(), var.detach())
        inv = torch.rsqrt(var + EPS)
        a = (scale * inv).to(parts[0].dtype)
        b = (bias - mean * scale * inv).to(parts[0].dtype)
        out, lo = [], 0
        for p in parts:
            hi = lo + p.shape[-1]
            out.append(_act(p * a[lo:hi] + b[lo:hi], slope).to(dtype))
            lo = hi
        if remask:
            out = [o * mask[..., None].to(o.dtype) for o in out]
        return (tuple(out) if pair else out[0]), moments
    red = (0,) + tuple(range(2, x.dim()))
    xf = x.float()
    if train:
        mean = xf.mean(red)
        var = ((xf * xf).mean(red) - mean * mean).clamp(min=0.0)
        moments = (mean.detach(), var.detach())
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mul = torch.rsqrt(var + EPS) * scale
    y = (xf - mean.view(shape)) * mul.view(shape) + bias.view(shape)
    return _act(y, slope).to(dtype), moments


# -- cases --------------------------------------------------------------------

def _cases():
    out = []
    for flavour in ("remask", "rows", "dense"):
        for C in (12, 16, 80):
            for slope in (0.0, 0.1):
                for train in (True, False):
                    out.append((flavour, (C,), slope, train, None))
    for flavour in ("remask", "rows"):
        for halves in ((6, 6), (16, 16), (40, 40)):
            for train in (True, False):
                out.append((flavour, halves, 0.1, train, None))
    for flavour in ("remask", "rows", "dense"):
        out.append((flavour, (16,), 0.1, True, "constant"))
    for flavour in ("remask", "rows"):
        out.append((flavour, (16,), 0.0, True, "empty"))
    return out


CASES = _cases()


def _case_id(c):
    flavour, halves, slope, train, special = c
    return (f"{flavour}-{'+'.join(map(str, halves))}-s{slope}-"
            f"{'train' if train else 'eval'}" + (f"-{special}" if special
                                                 else ""))


def _inputs(case, dtype, seed=0):
    """Rows (2, 4, 16, C_i) (the dense flavour (2, C, 4, 4, 8) in
    channels-last memory), a mask with 32 active rows (none for "empty"),
    parameters, running moments and output gradients. "constant" sets
    channel 3 to 0.5 on the rows that count: with a power-of-two count the
    variance is exactly 0."""
    flavour, halves, slope, train, special = case
    g = torch.Generator().manual_seed(seed)
    C = sum(halves)
    pdt = torch.float64 if dtype == torch.float64 else torch.float32
    if flavour == "dense":
        xs = [(torch.randn((2, 4, 4, 8, C), generator=g) * 1.5 + 0.3).to(
            dtype)]
        mask = None
    else:
        xs = [(torch.randn((2, 4, 16, c), generator=g) * 1.5 + 0.3).to(dtype)
              for c in halves]
        order = torch.randperm(128, generator=g)
        mask = torch.zeros(128, dtype=torch.bool)
        if special != "empty":
            mask[order[:32]] = True
        mask = mask.reshape(2, 4, 16)
    if special == "constant":
        xs[0][..., 3] = 0.5
    scale = (torch.rand(C, generator=g) + 0.5).to(pdt)
    bias = (torch.randn(C, generator=g) * 0.5).to(pdt)
    run_mean = (torch.randn(C, generator=g) * 0.2).to(pdt)
    run_var = (torch.rand(C, generator=g) + 0.5).to(pdt)
    dys = [torch.randn(x.shape, generator=g).to(dtype) for x in xs]
    return xs, mask, scale, bias, run_mean, run_var, dys


def _run(fn, case, dtype, xs, mask, scale, bias, run_mean, run_var, dys):
    """fn's output, moments and gradients (x halves, scale, bias), each
    output's gradient dy (dense: the chain's (B, C, *S) view)."""
    flavour, halves, slope, train, _ = case
    leaves = [x.clone().requires_grad_() for x in xs]
    sc = scale.clone().requires_grad_()
    bi = bias.clone().requires_grad_()
    dense = flavour == "dense"
    x = leaves[0].movedim(-1, 1) if dense else (
        tuple(leaves) if len(leaves) > 1 else leaves[0])
    kw = dict(train=train, remask=flavour == "remask", folded=not dense,
              slope=slope, dtype=dtype)
    y, moments = fn(x, mask, sc, bi, run_mean, run_var, **kw)
    ys = y if isinstance(y, tuple) else (y,)
    grads = torch.autograd.grad(
        ys, leaves + [sc, bi],
        [d.movedim(-1, 1) if dense else d for d in dys])
    return ys, moments, grads


def _cpu_path(x, mask, scale, bias, mean, var, **kw):
    return na.norm_act(x, mask, scale, bias, mean, var, eps=EPS,
                       cdim=1 if not kw["folded"] else -1, **kw)


def _op_path(x, mask, scale, bias, mean, var, **kw):
    return na.norm_act_via_op(x, mask, scale, bias, mean, var, eps=EPS,
                              cdim=1 if not kw["folded"] else -1, **kw)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_path_is_the_chain_bitwise(case, dtype):
    inputs = _inputs(case, dtype)
    ref = _run(_chain, case, dtype, *inputs)
    got = _run(_cpu_path, case, dtype, *inputs)
    for a, b in zip(ref[0], got[0]):
        assert torch.equal(a, b)
    if case[3]:
        assert all(torch.equal(a, b) for a, b in zip(ref[1], got[1]))
    else:
        assert ref[1] is None and got[1] is None
    for a, b in zip(ref[2], got[2]):
        assert torch.equal(a, b)


# the chain computes the flax BN in f32 whatever the input (its
# `dtype=float32`), so f64 inputs meet it at f32's rounding
TOL = {torch.float64: dict(rtol=1e-10, atol=1e-10),
       torch.float32: dict(rtol=1e-4, atol=1e-5)}


@pytest.mark.parametrize("case", CASES, ids=_case_id)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_plain_kernels_equal_the_chains_autograd(case, dtype):
    inputs = _inputs(case, dtype)
    ref = _run(_chain, case, dtype, *inputs)
    got = _run(_op_path, case, dtype, *inputs)
    tol = TOL[torch.float32 if case[0] == "dense" else dtype]
    scale = max(1.0, max(float(g.abs().max()) for g in ref[2]))
    for a, b in zip(ref[0], got[0]):
        torch.testing.assert_close(b, a, **tol)
    if case[3]:
        for a, b in zip(ref[1], got[1]):
            torch.testing.assert_close(b, a.to(b.dtype), **tol)
    else:
        assert got[1] is None
    for a, b in zip(ref[2], got[2]):
        torch.testing.assert_close(b, a, rtol=tol["rtol"],
                                   atol=tol["atol"] * scale)


@pytest.mark.parametrize("flavour,tie", [("remask", 0.5), ("dense", 1.0)])
def test_constant_channel_hits_the_variance_clamp(flavour, tie):
    """The "constant" cases reach var = 0 exactly (channel 3 only), where
    the masked BN's maximum passes half the variance's gradient and the
    dense BN's clamp all of it."""
    case = (flavour, (16,), 0.1, True, "constant")
    xs, mask, scale, *_ = _inputs(case, torch.float64)
    stats = na.stats_plain(xs[0], None, mask)
    mean, var, raw, cnt = na.moments_plain(stats, None, None, True)
    assert float(raw[3]) == 0.0
    assert bool((raw[torch.arange(16) != 3] > 0).all())
    grads = torch.ones(2, 16, dtype=torch.float64)
    inv = torch.rsqrt(var + EPS)
    above = raw.clone()
    above[3] = 1e-300
    folded = flavour == "remask"
    at = na.stat_grads_plain(grads, scale, mean, raw, cnt, inv, True,
                             folded)[1]
    off = na.stat_grads_plain(grads, scale, mean, above, cnt, inv, True,
                              folded)[1]
    assert float(off[3]) != 0.0
    assert float(at[3]) == tie * float(off[3])


def test_cpu_tensor_launches_nothing():
    na.launches_fwd = na.launches_bwd = 0
    for model in ("uresnet_sparse", "uresnet_dense"):
        cfg = TConfig(**dict(_KW, model_name=model, compute_dtype="float32",
                             remat_mode="stage_dots"))
        tv = TrainVal(cfg, device="cpu")
        tv.initialize()
        blob = _blob(cfg)
        tv.train_step(blob)
        tv.forward(blob)
    case = ("remask", (16, 16), 0.1, True, None)
    _run(_op_path, case, torch.float32, *_inputs(case, torch.float32))
    assert (na.launches_fwd, na.launches_bwd) == (0, 0)


@pytest.mark.parametrize("path", ["cpu", "op"])
def test_moments_recorded_under_recompute_commit_once(path, monkeypatch):
    """A BNAct recomputed in backward records the same moments twice and
    `commit_batch_moments` folds them in once: the running moments move
    by (1 - momentum) of the batch's, as after a plain forward."""
    if path == "op":
        monkeypatch.setattr(tiled, "norm_act", na.norm_act_via_op)
    cfg = TConfig(**dict(_KW, compute_dtype="float32"))
    case = ("remask", (16,), 0.1, True, None)
    xs, mask, *_ = _inputs(case, torch.float32)
    results = []
    for recompute in (False, True):
        bn = tiled.BNAct(cfg, 16)
        with torch.no_grad():
            bn.MaskedBatchNorm_0.mean.fill_(0.25)
        x = xs[0].clone().requires_grad_()

        def fwd(x):
            return tiled._bn_flat(bn, x, mask, True)
        y = checkpoint(fwd, x, use_reentrant=False) if recompute else fwd(x)
        calls = []
        orig = bn.forward
        monkeypatch.setattr(bn, "forward",
                            lambda *a, **k: calls.append(1) or orig(*a, **k))
        y.sum().backward()
        assert len(calls) == int(recompute)
        batch_mean = bn.MaskedBatchNorm_0.batch_moments[0].clone()
        commit_batch_moments(bn)
        assert bn.MaskedBatchNorm_0.batch_moments is None
        commit_batch_moments(bn)     # nothing left to apply
        results.append((bn.MaskedBatchNorm_0.mean.clone(), batch_mean))
    for running, batch in results:
        torch.testing.assert_close(running, 0.9 * 0.25 + 0.1 * batch,
                                   rtol=1e-6, atol=1e-7)
    assert torch.equal(results[0][0], results[1][0])


def test_dense_channels_last_and_other_layouts():
    """The operator takes the dense model's channels-last volume as rows
    and refuses a layout whose channels are not contiguous."""
    cfg = TConfig(**dict(_KW, model_name="uresnet_dense",
                         compute_dtype="float32"))
    bn = uresnet_dense.BNAct(cfg, 8)
    x = torch.randn(2, 8, 4, 4, 4)
    p = bn.BatchNorm_0
    kw = dict(train=True, remask=False, folded=False, slope=0.0, eps=EPS,
              dtype=torch.float32, cdim=1)
    cl = x.contiguous(memory_format=torch.channels_last_3d)
    y, _ = na.norm_act_via_op(cl, None, p.scale, p.bias, p.mean, p.var, **kw)
    ref, _ = na.chain_plain(cl, None, p.scale, p.bias, p.mean, p.var, **kw)
    assert y.is_contiguous(memory_format=torch.channels_last_3d)
    torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="contiguous"):
        na.norm_act_via_op(x, None, p.scale, p.bias, p.mean, p.var, **kw)


# -- a residual operand: act(BN(x) + r) [* mask] -----------------------------

def _residual_chain(x, r, mask, scale, bias, mean, var, *, train, remask,
                    folded, slope, dtype):
    """act(BN(x) + r) [* mask] in torch ops, each BN as `_chain` takes it:
    the reference the residual's gradients d_x, d_r, d_scale, d_bias come
    from by autograd. x and r are rows (..., C) or, unfolded, (B, C, *S)."""
    moments = None
    red = tuple(range(x.dim() - 1)) if folded else \
        (0,) + tuple(range(2, x.dim()))
    shape = (-1,) if folded else (1, -1) + (1,) * (x.dim() - 2)
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    if train:
        m = mask[..., None].to(acc) if mask is not None \
            else torch.ones((), dtype=acc)
        n = (m.sum() if mask is not None
             else torch.tensor(float(x.numel() // x.shape[-1 if folded
                                                          else 1])))
        xf = x.to(acc) * m
        mean = xf.sum(red) / n.clamp(min=1.0)
        var = ((xf * xf).sum(red) / n.clamp(min=1.0)
               - mean * mean).clamp(min=0.0)
        moments = (mean.detach(), var.detach())
    inv = torch.rsqrt(var + EPS)
    v = (x.to(acc) - mean.view(shape)) * (inv * scale).view(shape) \
        + bias.view(shape) + r.to(acc)
    y = _act(v, slope).to(dtype)
    if remask:
        y = y * mask[..., None].to(y.dtype)
    return y, moments


def _residual_cases():
    return [(flavour, slope, train) for flavour in ("remask", "rows", "dense")
            for slope in (0.0, 0.1, 1.0) for train in (True, False)]


@pytest.mark.parametrize("path", ["cpu", "op"])
@pytest.mark.parametrize("case", _residual_cases(),
                         ids=lambda c: f"{c[0]}-s{c[1]}-"
                         f"{'train' if c[2] else 'eval'}")
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_residual_matches_a_torch_chain(case, dtype, path):
    """`norm_act(..., residual=r)`: the models' CPU path (the chain with
    the residual) and the operator's plain kernels give act(BN(x) + r)
    [* mask], its moments, and d_x, d_r, d_scale and d_bias as autograd
    takes them through the torch chain above; slope 1 is a projection's
    BN, with no activation. f64 agrees to 1e-10 (the dense flavour, whose
    BN runs in f32, to f32's 1e-4), f32 to 1e-4 relative and 1e-5
    absolute."""
    flavour, slope, train = case
    xs, mask, scale, bias, run_mean, run_var, dys = _inputs(
        (flavour, (16,), slope, train, None), dtype, seed=5)
    r = torch.randn(xs[0].shape, generator=torch.Generator().manual_seed(6),
                    dtype=torch.float64).to(dtype) * 0.8
    dense = flavour == "dense"
    leaves = [xs[0].clone().requires_grad_(), r.clone().requires_grad_(),
              scale.clone().requires_grad_(), bias.clone().requires_grad_()]
    view = (lambda t: t.movedim(-1, 1)) if dense else (lambda t: t)
    kw = dict(train=train, remask=flavour == "remask", folded=not dense,
              slope=slope, dtype=dtype)
    fn = na.norm_act if path == "cpu" else na.norm_act_via_op
    y, moments = fn(view(leaves[0]), mask, leaves[2], leaves[3], run_mean,
                    run_var, eps=EPS, cdim=1 if dense else -1,
                    residual=view(leaves[1]), **kw)
    got = torch.autograd.grad(y, leaves, view(dys[0]))
    ref_leaves = [t.detach().clone().requires_grad_() for t in leaves]
    y_ref, m_ref = _residual_chain(view(ref_leaves[0]), view(ref_leaves[1]),
                                   mask, ref_leaves[2], ref_leaves[3],
                                   run_mean, run_var, **kw)
    want = torch.autograd.grad(y_ref, ref_leaves, view(dys[0]))
    tol = TOL[torch.float32 if dense else dtype]
    torch.testing.assert_close(y, y_ref.to(y.dtype), **tol)
    if train:
        for a, b in zip(moments, m_ref):
            torch.testing.assert_close(a, b.to(a.dtype), **tol)
    else:
        assert moments is None
    scale_g = max(1.0, max(float(g.abs().max()) for g in want))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b.to(a.dtype), rtol=tol["rtol"],
                                   atol=tol["atol"] * scale_g)
    if flavour == "remask":     # an inactive row passes no gradient to r
        assert not bool(got[1][~mask].any())


def test_residual_refuses_a_pair():
    case = ("remask", (16, 16), 0.1, True, None)
    xs, mask, scale, bias, run_mean, run_var, _ = _inputs(case,
                                                          torch.float32)
    for fn in (na.norm_act, na.norm_act_via_op):
        with pytest.raises(ValueError, match="residual"):
            fn(tuple(xs), mask, scale, bias, run_mean, run_var, train=True,
               remask=True, folded=True, slope=0.0, eps=EPS,
               dtype=torch.float32, residual=xs[0])
