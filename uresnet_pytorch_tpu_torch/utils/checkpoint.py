"""Checkpoint save/restore, in the reference's file names and tree.

Port of `uresnet_pytorch_tpu/utils/checkpoint.py`. A checkpoint is one
``{weight_prefix}-{iteration}.ckpt`` file holding the reference's tree
``{step, params, batch_stats, opt_state}``, where ``opt_state`` is
optax.adam's ``{"0": {count, mu, nu}, "1": {}}`` with ``mu`` and ``nu``
nested like ``params``. Torch's Adam maps onto it as ``exp_avg`` = ``mu``,
``exp_avg_sq`` = ``nu`` and its ``step`` = ``count``.

The port writes that tree of CPU tensors with ``torch.save``, atomically
(temp file, fsync, rename). It reads its own files and the reference's
flax-msgpack ones, told apart by content: a torch file is a zip archive
(``PK``), a msgpack map never starts so. Reading the reference's format
needs ``msgpack``, imported only then; flax's array extension (code 1, and
3 for a numpy scalar) is a packed ``(shape, dtype name, bytes)`` and is
decoded here without flax. Writing the reference's format is not ported.
"""

from __future__ import annotations

import glob
import io
import os
import re
from collections.abc import Mapping
from typing import Optional

import numpy as np
import torch
from torch import nn

from uresnet_pytorch_tpu_torch.utils.weights import (_flatten, _nest,
                                                     export_variables,
                                                     load_jax_variables)


def save_checkpoint(path: str, tree: Mapping) -> str:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.save(tree, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def _unpack_flax_array(payload: bytes) -> np.ndarray:
    import msgpack
    shape, dtype, buf = msgpack.unpackb(payload, raw=True)
    if dtype == b"bfloat16":      # numpy has no bfloat16: widen the bits
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(dtype.decode())).reshape(shape)


def _read_msgpack(data: bytes) -> dict:
    try:
        import msgpack
    except ImportError as e:
        raise ImportError(
            "this checkpoint is the reference's flax msgpack format; reading "
            "it needs the msgpack package, which is not installed") from e

    def ext_hook(code, payload):
        if code == 1:
            return _unpack_flax_array(payload)
        if code == 3:
            return _unpack_flax_array(payload)[()]
        raise ValueError(f"unsupported msgpack extension type {code}")
    return msgpack.unpackb(data, ext_hook=ext_hook, raw=False)


def _to_numpy(tree):
    if isinstance(tree, Mapping):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def restore_checkpoint(path: str) -> dict:
    """The checkpoint's tree, with numpy leaves, from either format."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"PK":
        tree = torch.load(io.BytesIO(data), map_location="cpu",
                          weights_only=True)
    else:
        tree = _read_msgpack(data)
    return _to_numpy(tree)


def checkpoint_path(weight_prefix: str, iteration: int) -> str:
    return f"{weight_prefix}-{iteration}.ckpt"


def latest_checkpoint(weight_prefix: str) -> Optional[str]:
    """Highest-iteration ``{prefix}-{i}.ckpt`` on disk, or None."""
    best, best_it = None, -1
    for p in glob.glob(f"{weight_prefix}-*.ckpt"):
        m = re.search(r"-(\d+)\.ckpt$", p)
        if m and int(m.group(1)) > best_it:
            best, best_it = p, int(m.group(1))
    return best


def train_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                step: int) -> dict:
    """The reference's checkpoint tree of `model` and its Adam, as CPU
    tensors. Before Adam's first step its moments are zeros, as optax's
    init."""
    def tensors(tree):
        return {k: tensors(v) if isinstance(v, Mapping)
                else torch.from_numpy(v) for k, v in tree.items()}
    variables = tensors(export_variables(model))
    params = dict(model.named_parameters())
    mu, nu, count = {}, {}, 0
    for name, p in params.items():
        st = optimizer.state.get(p, {})
        mu[name] = st["exp_avg"].detach().float().cpu().clone() if st \
            else torch.zeros(p.shape)
        nu[name] = st["exp_avg_sq"].detach().float().cpu().clone() if st \
            else torch.zeros(p.shape)
        if st:
            count = int(st["step"])
    return {"step": torch.tensor(step, dtype=torch.int32),
            "params": variables["params"],
            "batch_stats": variables["batch_stats"],
            "opt_state": {"0": {"count": torch.tensor(count,
                                                      dtype=torch.int32),
                                "mu": _nest(mu), "nu": _nest(nu)},
                          "1": {}}}


def load_train_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                     tree: Mapping) -> int:
    """Fill `model` and its Adam from a checkpoint tree (either format's)
    and return its step. Raises KeyError where the tree lacks a tensor
    the model has, or has one it lacks."""
    load_jax_variables(model, tree)
    adam_state = tree["opt_state"]["0"]
    mu, nu = dict(_flatten(adam_state["mu"])), dict(_flatten(adam_state["nu"]))
    names = [n for n, _ in model.named_parameters()]
    if set(mu) != set(names) or set(nu) != set(names):
        raise KeyError("the checkpoint's Adam moments do not name the "
                       "model's parameters")
    count = float(np.asarray(adam_state["count"]))
    sd = optimizer.state_dict()
    sd["state"] = {
        i: {"step": torch.tensor(count, dtype=torch.float32),
            "exp_avg": torch.from_numpy(np.array(mu[n], np.float32)),
            "exp_avg_sq": torch.from_numpy(np.array(nu[n], np.float32))}
        for i, n in enumerate(names)}
    optimizer.load_state_dict(sd)
    return int(np.asarray(tree["step"]))
