"""The plain references against the port's CPU path (its plain torch
versions) at tiny sizes, in float32: a forward, and three training steps
(losses, first gradients, state after the steps)."""

import pytest
import torch

from perfbench import reference
from perfbench.core.events import blob_of, make_pool
from perfbench.core.weights import as_variables, make_params
from perfbench.tests import tiny

CASES = {
    "sparse": (dict(model_name="uresnet_sparse", num_class=5, reps=2,
                    data_dim=3, capacity_factor=0.5, tile_size=4,
                    tile_occupancy=4.5, learning_rate=1e-3,
                    remat_mode="stage_dots", **tiny.SPARSE), 1500, None),
    "dense": (dict(model_name="uresnet_dense", num_class=5, reps=2,
                   data_dim=3, weight_key="weight", learning_rate=1e-3,
                   **tiny.DENSE), 300, [0.5, 1, 1, 1, 1]),
}


def _setup(kind):
    from uresnet_pytorch_tpu_torch.config import URESNetConfig
    from uresnet_pytorch_tpu_torch.trainval import TrainVal
    model, mean, cw = CASES[kind]
    cfg = URESNetConfig(**model, batch_size=2)
    pool = make_pool(7, 6, model["spatial_size"], 3, mean)
    blobs = [blob_of(pool[i:i + 2], model["max_voxels"], 3, cw)
             for i in (0, 2, 4)]
    mod = reference.BY_MODEL[model["model_name"]]
    params = make_params(mod.param_spec(model), 9, "cpu")
    tv = TrainVal(cfg, device="cpu")
    tv.initialize(as_variables(params))
    return model, mod, blobs, params, tv


@pytest.mark.parametrize("kind", sorted(CASES))
def test_forward_matches_port(kind):
    model, mod, blobs, params, tv = _setup(kind)
    blob = blobs[0]
    got = tv.forward(blob)["softmax"]
    n = blob["n_voxels"]
    got = torch.cat([got[b, :n[b]] for b in range(len(n))])
    want = torch.softmax(mod.infer(model, params, blob, "cpu"), -1)
    assert (got - want).abs().max() < 1e-5


@pytest.mark.parametrize("kind", sorted(CASES))
def test_training_steps_match_port(kind):
    model, mod, blobs, params, tv = _setup(kind)
    losses = []
    for i, blob in enumerate(blobs):
        losses.append(float(tv.train_step(blob)["loss"]))
        if i == 0:
            first = {k: tv.optimizer.state[p]["exp_avg"] / 0.1
                     for k, p in tv.model.named_parameters()}
    ref = reference.train_steps(mod, model, params, blobs, "cpu")
    assert losses == pytest.approx(ref["losses"], rel=1e-5)
    for k, g in ref["grads"].items():
        assert (first[k] - g).norm() <= 1e-4 * g.norm() + 1e-8, k
    # Adam divides by the root of the second moment, so an element whose
    # gradient is near zero can turn its float32 round-off into a step of
    # the learning rate: the state is held as a whole, to 1e-2 of its change
    state = dict(tv.model.named_parameters())
    state.update(dict(tv.model.named_buffers()))
    diff = sum(float((state[k].detach() - v).norm()) ** 2
               for k, v in ref["state"].items()) ** 0.5
    change = sum(float((v - params[k]).norm()) ** 2
                 for k, v in ref["state"].items()) ** 0.5
    assert diff <= 1e-2 * change
