"""The weights of a run, made on the device from the seed.

One `torch.Generator` on the run's device draws one normal sample for the
whole tree in one call; each leaf is a slice of it, scaled by its kind:
weights to variance 1 / fan-in (taps times input channels; one parent row
for an up weight), BN scales 1 + 0.1 z, biases and running means 0.1 z,
running variances 1 + 0.1 |z|. Scales, biases and moments away from
their defaults make the BN affine and the re-masking after it do work.
The same tree is handed to the program and to the reference.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

SEED_MASK = (1 << 63) - 1


def make_params(spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on `device`} for every (name, shape, kind) of
    `spec`."""
    sizes = [math.prod(shape) for _, shape, _ in spec]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & SEED_MASK)
    z = torch.randn(sum(sizes), generator=gen, device=device)
    out, off = {}, 0
    for (name, shape, kind), n in zip(spec, sizes):
        v = z[off:off + n].view(shape)
        off += n
        if kind == "conv":
            v = v * (1.0 / math.sqrt(math.prod(shape[:-1])))
        elif kind == "up":
            v = v * (1.0 / math.sqrt(shape[-2]))
        elif kind == "head":
            v = v * (1.0 / math.sqrt(shape[0]))
        elif kind == "scale":
            v = 1.0 + 0.1 * v
        elif kind in ("bias", "mean"):
            v = 0.1 * v
        elif kind == "var":
            v = 1.0 + 0.1 * v.abs()
        else:
            raise ValueError(f"{name}: unknown kind {kind!r}")
        out[name] = v.contiguous()
    return out


def as_variables(params: Dict[str, torch.Tensor]) -> dict:
    """The program's `{"params": ..., "batch_stats": ...}` tree of numpy
    arrays for `TrainVal.initialize`: running moments are batch stats."""
    tree: dict = {"params": {}, "batch_stats": {}}
    for name, v in params.items():
        coll = "batch_stats" if name.endswith((".mean", ".var")) \
            else "params"
        node = tree[coll]
        *path, leaf = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v.detach().float().cpu().numpy()
    return tree
