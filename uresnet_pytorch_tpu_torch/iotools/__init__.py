"""IO tools: the loader factory. Port of `uresnet_pytorch_tpu/iotools/`.
`io_h5` (and with it h5py) is imported only for `io_type="h5"`."""

from __future__ import annotations

from uresnet_pytorch_tpu_torch.config import URESNetConfig
from uresnet_pytorch_tpu_torch.iotools.io_base import IOBase  # noqa: F401


def io_factory(cfg: URESNetConfig, **kwargs) -> IOBase:
    if cfg.io_type == "h5":
        from uresnet_pytorch_tpu_torch.iotools.io_h5 import IOH5
        return IOH5(cfg)
    if cfg.io_type == "synthetic":
        from uresnet_pytorch_tpu_torch.iotools.io_synthetic import IOSynthetic
        return IOSynthetic(cfg, **kwargs)
    if cfg.io_type in ("larcv_sparse", "larcv_dense"):
        raise NotImplementedError(
            "larcv requires ROOT, unavailable in this environment; convert "
            "files to the HDF5 schema (uresnet_pytorch_tpu_torch/iotools/"
            "h5_io.py) and use --io-type h5. The blob contract is identical.")
    raise ValueError(f"unknown io_type {cfg.io_type!r}")
