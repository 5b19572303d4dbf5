"""Data parallel over torch.distributed. Port of
`uresnet_pytorch_tpu/parallel/`."""

from uresnet_pytorch_tpu_torch.parallel.mesh import (  # noqa: F401
    DataMesh, all_reduce_sum, broadcast_, gather_rows, launch, make_mesh,
    shard_batch)
