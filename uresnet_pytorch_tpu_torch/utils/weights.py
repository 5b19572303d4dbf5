"""Weights between the reference's flax `variables` tree and the port.

`load_jax_variables(module, variables)` takes the JAX variables as nested
dicts of arrays (numpy, or anything `np.asarray` accepts) and fills the
port's parameters (`params` collection) and buffers (`batch_stats`) by
dotted name, e.g. `params/enc0_block0/conv_a/w` -> `enc0_block0.conv_a.w`.
`export_variables(module)` is the inverse: the module's state as such a
tree of numpy arrays. `load_flax_compact(module, variables)` loads a tree
whose names flax's compact modules gave (`SubmanifoldConvolution_0`, ...):
the SCN layer API's (`uresnet_pytorch_tpu_torch/scn.py`). `init_params(cfg, generator)` makes a tree from the
reference's initializers without JAX.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from uresnet_pytorch_tpu_torch.config import URESNetConfig

_COLLECTIONS = ("params", "batch_stats")


def _flatten(tree: Mapping, prefix: str = ""):
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            yield from _flatten(v, name)
        else:
            yield name, v


@torch.no_grad()
def load_jax_variables(module: nn.Module, variables: Mapping) -> None:
    """Copy every `params` and `batch_stats` leaf into `module`.

    Raises KeyError for a leaf the module lacks or a module tensor the
    tree lacks, ValueError for a shape mismatch. Other collections (the
    reference's `diag` outputs) are not state and are skipped."""
    targets = {"params": dict(module.named_parameters()),
               "batch_stats": dict(module.named_buffers())}
    for coll in _COLLECTIONS:
        filled = set()
        for name, value in _flatten(variables.get(coll, {})):
            if name not in targets[coll]:
                raise KeyError(f"{coll}.{name}: no such tensor in "
                               f"{type(module).__name__}")
            dst = targets[coll][name]
            src = torch.from_numpy(np.array(value, dtype=np.float32))
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{coll}.{name}: shape {tuple(src.shape)}, "
                                 f"module has {tuple(dst.shape)}")
            dst.copy_(src)
            filled.add(name)
        missing = sorted(set(targets[coll]) - filled)
        if missing:
            raise KeyError(f"{coll}: no entry for {missing}")


_TRANSPARENT = (nn.Sequential, nn.ModuleList, nn.ModuleDict)


def _flax_names(module: nn.Module, tprefix: str, fprefix: str,
                out: dict) -> dict:
    """{flax module path: torch module path} under `module`: flax names a
    compact module's children `{Class}_{i}`, counting each class in
    creation order, here registration order (torch containers add no
    level)."""
    counts: dict = {}

    def walk(mod, tpre):
        for name, child in mod.named_children():
            if isinstance(child, _TRANSPARENT):
                walk(child, f"{tpre}{name}.")
                continue
            cls = type(child).__name__
            i = counts[cls] = counts.get(cls, -1) + 1
            out[f"{fprefix}{cls}_{i}"] = f"{tpre}{name}"
            _flax_names(child, f"{tpre}{name}.", f"{fprefix}{cls}_{i}.", out)
    walk(module, tprefix)
    return out


def load_flax_compact(module: nn.Module, variables: Mapping) -> None:
    """`load_jax_variables` for a tree that flax compact modules made (the
    SCN layers of `uresnet_pytorch_tpu_torch.scn` composed in a module):
    each of `module`'s submodules takes the flax name of the same class at
    the same place in creation order, so the torch module registers its
    layers in the order the flax one creates them."""
    names = _flax_names(module, "", "", {})
    tree = {}
    for coll in _COLLECTIONS:
        flat = {}
        for path, value in _flatten(variables.get(coll, {})):
            owner, _, leaf = path.rpartition(".")
            if owner and owner not in names:
                raise KeyError(f"{coll}.{path}: no module of "
                               f"{type(module).__name__} takes the flax "
                               f"name {owner}")
            flat[f"{names[owner]}.{leaf}" if owner else leaf] = value
        tree[coll] = _nest(flat)
    load_jax_variables(module, tree)


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for name, value in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def export_variables(module: nn.Module) -> dict:
    """The module's parameters and buffers as a `{"params": ...,
    "batch_stats": ...}` tree of f32 numpy arrays (copies, on the host)."""
    def host(t):
        return t.detach().float().cpu().numpy().copy()
    return {
        "params": _nest({n: host(p) for n, p in module.named_parameters()}),
        "batch_stats": _nest({n: host(b)
                              for n, b in module.named_buffers()}),
    }


def init_params(cfg: URESNetConfig, generator: torch.Generator) -> dict:
    """A fresh `{"params": ..., "batch_stats": ...}` tree of numpy arrays
    for `cfg.model_name` (and, for the sparse model, `cfg.sparse_engine`:
    both engines draw the same tree), drawn from `generator` with the
    reference's initializers: for the sparse model He normal for conv
    stacks and lecun_normal for the head, for the dense model flax's
    lecun_normal kernels and zero biases; BN scale 1 / bias 0 / mean 0 /
    var 1."""
    from uresnet_pytorch_tpu_torch.models import construct
    return export_variables(construct(cfg.model_name)(
        cfg, generator=generator, device="cpu"))
