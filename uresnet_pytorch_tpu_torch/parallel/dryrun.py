"""A data-parallel dry run on the CPU: the port's counterpart of the
reference's `__graft_entry__.dryrun_multichip`.

    python -c "from uresnet_pytorch_tpu_torch.parallel.dryrun import \\
        dryrun_multichip; dryrun_multichip(2)"

`dryrun_multichip(n)` runs n gloo ranks on the CPU through
`parallel.launch`, at the reference's tiny configuration there (4 filters,
two strides, 16^3, 128 voxels, tiles (4, 2), f32, batch n, one event a
rank), takes one data-parallel step and holds it to one process's step on
the whole batch: the loss at rtol 1e-5 and every summed gradient at rtol
1e-4 with atol 1e-4 * max|ref|, the running moments at 1e-5. It prints the
reference's `ok, loss=` line.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from uresnet_pytorch_tpu_torch.config import URESNetConfig
from uresnet_pytorch_tpu_torch.iotools.synthetic import generate_event
from uresnet_pytorch_tpu_torch.parallel.mesh import launch
from uresnet_pytorch_tpu_torch.trainval import TrainVal


def dryrun_config(n: int) -> URESNetConfig:
    return URESNetConfig(
        model_name="uresnet_sparse", num_class=5, uresnet_filters=4,
        uresnet_num_strides=2, spatial_size=16, data_dim=3, reps=1,
        max_voxels=128, min_level_capacity=32, batch_size=n,
        tile_sizes=(4, 2), learning_rate=0.01, compute_dtype="float32")


def example_blob(cfg: URESNetConfig, batch: int, mean_voxels: int,
                 seed: int = 0) -> dict:
    """The reference's `_example_blob`: events 0..batch-1 of `seed`."""
    V, dim = cfg.max_voxels, cfg.data_dim
    blob = {"coords": np.zeros((batch, V, dim), np.int32),
            "values": np.zeros((batch, V), np.float32),
            "label": np.zeros((batch, V), np.int32),
            "n_voxels": np.zeros((batch,), np.int32)}
    for b in range(batch):
        c, v, l = generate_event(seed, b, cfg.spatial_size, dim, mean_voxels)
        n = min(len(c), V)
        blob["coords"][b, :n], blob["values"][b, :n] = c[:n], v[:n]
        blob["label"][b, :n], blob["n_voxels"][b] = l[:n], n
    return blob


def step_result(tv: TrainVal, blob: dict) -> dict:
    """One train step: its loss, the gradients Adam took (summed over the
    ranks) and the new running moments, as numpy."""
    loss = float(tv.train_step(blob)["loss"])
    return {"loss": loss,
            "grads": {k: p.grad.detach().cpu().numpy().copy()
                      for k, p in tv.model.named_parameters()},
            "stats": {k: b.detach().cpu().numpy().copy()
                      for k, b in tv.model.named_buffers()}}


def _rank(cfg: URESNetConfig, blob: dict, out_dir: str) -> None:
    torch.set_num_threads(1)
    tv = TrainVal(cfg, device="cpu")
    tv.initialize()
    res = step_result(tv, blob)
    torch.save(res, os.path.join(out_dir, f"rank{tv.mesh.rank}.pt"))


def dryrun_multichip(n_devices: int) -> None:
    cfg = dryrun_config(n_devices)
    blob = example_blob(cfg, n_devices, 60)
    tv = TrainVal(cfg, device="cpu")
    tv.initialize()
    ref = step_result(tv, blob)
    with tempfile.TemporaryDirectory() as tmp:
        launch(_rank, n_devices, args=(cfg, blob, tmp))
        # the ranks' own files: trusted pickles
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(n_devices)]
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5,
                                   err_msg=f"rank {r} loss")
        for k, want in ref["grads"].items():
            np.testing.assert_allclose(
                got["grads"][k], want, rtol=1e-4,
                atol=1e-4 * float(np.abs(want).max()),
                err_msg=f"rank {r} gradient {k}")
        for k, want in ref["stats"].items():
            np.testing.assert_allclose(got["stats"][k], want, rtol=1e-5,
                                       atol=1e-5,
                                       err_msg=f"rank {r} moment {k}")
    loss = ranks[0]["loss"]
    if not np.isfinite(loss):
        raise RuntimeError(f"dryrun_multichip({n_devices}): loss {loss}")
    print(f"dryrun_multichip({n_devices}): ok, loss={loss:.4f}")


if __name__ == "__main__":
    import sys
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
