"""Upstream PyTorch checkpoint import and export, by name.

Port of `uresnet_pytorch_tpu/utils/torch_import.py`: the same numpy
mapping between a flat torch `state_dict` (dotted names, conv kernels in
torch's `(O, I, *k)` layout, BN as `weight`, `bias`, `running_mean`,
`running_var`) and a reference-style `{params, batch_stats}` tree, which
`utils/weights.load_jax_variables` then loads into a port model.

As in the reference, `import_state_dict` transposes every `kernel` leaf of
three or more dimensions from `(O, I, *k)` to `(*k, I, O)`, the dense
model's `up{l}_deconv` kernels included, although an upstream
`ConvTranspose` weight is `(I, O, *k)` and flax's kernel is that weight
with its spatial axes flipped; `export_state_dict` does the inverse, so
the two round-trip.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Tuple

import numpy as np
import torch


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A `torch.save`d checkpoint's state dict (its `state_dict` entry, or
    the payload itself) as numpy arrays, DataParallel `module.` prefixes
    stripped."""
    payload = torch.load(path, map_location="cpu", weights_only=False)
    state = payload.get("state_dict", payload)
    out = {}
    for k, v in state.items():
        if k.startswith("module."):
            k = k[len("module."):]
        out[k] = (v.detach().cpu().numpy() if hasattr(v, "detach")
                  else np.asarray(v))
    return out


def global_step_of(path: str) -> int:
    payload = torch.load(path, map_location="cpu", weights_only=False)
    return int(payload.get("global_step", 0))


def dense_kernel_to_flax(w: np.ndarray) -> np.ndarray:
    """torch ConvNd weight (O, I, *spatial) -> flax (*spatial, I, O)."""
    nd = w.ndim - 2
    return np.transpose(w, tuple(range(2, 2 + nd)) + (1, 0))


def dense_kernel_to_torch(w: np.ndarray) -> np.ndarray:
    nd = w.ndim - 2
    return np.transpose(w, (nd + 1, nd) + tuple(range(nd)))


def scn_kernel_to_stack(w: np.ndarray, data_dim: int) -> np.ndarray:
    """A SparseConvNet weight as the (K, Cin, Cout) stack the sparse
    models hold (SCN stores one GEMM matrix per offset already)."""
    if w.ndim == 3:
        return np.ascontiguousarray(w)
    if w.ndim == 2:
        raise ValueError(
            "flat SCN weight needs K to disambiguate; reshape to (K,Cin,Cout)")
    raise ValueError(f"unexpected SCN weight shape {w.shape}")


def bn_to_flax(prefix: str, sd: Mapping[str, np.ndarray]
               ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    params = {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}
    stats = {"mean": sd[f"{prefix}.running_mean"],
             "var": sd[f"{prefix}.running_var"]}
    return params, stats


def _stats_name(name: str) -> str:
    return name.replace(".mean", ".running_mean").replace(
        ".var", ".running_var")


def export_state_dict(params: Any, batch_stats: Any) -> Dict[str, np.ndarray]:
    """Flatten a `{params, batch_stats}` tree into a torch-style flat state
    dict: dotted names, `kernel` leaves of 3+ dimensions in torch layout,
    moments named `running_mean` / `running_var`."""
    out = {}

    def walk(tree, prefix, is_stats):
        for k, v in tree.items():
            name = f"{prefix}.{k}" if prefix else k
            if isinstance(v, Mapping):
                walk(v, name, is_stats)
                continue
            arr = np.asarray(v)
            if not is_stats and arr.ndim >= 3 and k == "kernel":
                arr = dense_kernel_to_torch(arr)
            out[_stats_name(name) if is_stats else name] = arr
    walk(params, "", False)
    walk(batch_stats, "", True)
    return out


def import_state_dict(target_params: Any, target_stats: Any,
                      sd: Mapping[str, np.ndarray]):
    """New (params, batch_stats) trees shaped like the targets, filled
    from a flat state dict as `export_state_dict` writes it. Raises
    KeyError for a missing name and ValueError for a shape that does not
    match after the layout change."""
    def walk(tree, prefix, is_stats):
        new = {}
        for k, v in tree.items():
            name = f"{prefix}.{k}" if prefix else k
            if isinstance(v, Mapping):
                new[k] = walk(v, name, is_stats)
                continue
            arr = np.asarray(sd[_stats_name(name) if is_stats else name])
            tgt = np.asarray(v)
            if not is_stats and tgt.ndim >= 3 and k == "kernel":
                arr = dense_kernel_to_flax(arr)
            if arr.shape != tgt.shape:
                raise ValueError(
                    f"{name}: shape {arr.shape} != target {tgt.shape}")
            new[k] = arr.astype(tgt.dtype)
        return new
    return (walk(target_params, "", False),
            walk(target_stats, "", True))
