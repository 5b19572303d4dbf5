"""Model factory, under the reference's names (construct, register_model)."""

from __future__ import annotations

from typing import Callable, Dict

_MODELS: Dict[str, Callable] = {}


def register_model(name: str):
    def deco(fn):
        _MODELS[name] = fn
        return fn
    return deco


def construct(name: str):
    """name -> model builder taking a URESNetConfig and returning an
    nn.Module whose forward(coords, values, n_voxels) gives
    ((B, V, num_class) per-voxel logits, diag counters)."""
    # import for registration side effects
    import uresnet_pytorch_tpu_torch.models.minkunet_tiled  # noqa: F401
    import uresnet_pytorch_tpu_torch.models.uresnet_dense  # noqa: F401
    import uresnet_pytorch_tpu_torch.models.uresnet_sparse  # noqa: F401
    if name not in _MODELS:
        raise ValueError(f"unknown model {name!r}; have {sorted(_MODELS)}")
    return _MODELS[name]
