"""The data-parallel mesh: the ranks of one torch.distributed group.

Port of `uresnet_pytorch_tpu/parallel/mesh.py`. The reference's mesh is a
1-D ('data',) jax Mesh: the batch shards on axis 0, parameters replicate,
and GSPMD derives every collective from those shardings. In the port each
rank is a process on one device, and the collectives are written out:

- `make_mesh` reads the rank and the world size from the initialized
  default process group (a world of one without a group) and gives each
  rank its device (`device_ids` is `--gpus`: rank r on cuda:device_ids[r]);
- `shard_batch` takes rank r's contiguous rows of a global blob, the
  layout of the reference's `P("data")`;
- `broadcast_` copies rank 0's tensors into every rank: what the
  reference's `replicated_sharding` gives its parameters;
- `all_reduce_sum` sums tensors over the ranks in one collective, where the
  reference's XLA inserts a psum: the masked BN's sums (models/norm.py),
  the loss's weight sum and the metrics' counts (models/losses.py), and
  the gradients (trainval.py). Its differentiable form's backward sums the
  cotangents over the ranks (`torch.distributed.nn`), which is SyncBN's
  mathematics;
- `gather_rows` hands rank 0 every rank's copy of fixed-shape tensors in
  one collective: the prediction writer's rows (main_funcs.py), where the
  reference's one process holds the global batch.

Without a process group (`DataMesh.group is None`) nothing is reduced and
every number is the one-process number, bit for bit.

`launch(fn, n, device_ids)` starts the ranks. The backend follows the
devices: NCCL for ranks on distinct cards, gloo on the CPU or where two
ranks share a card (NCCL refuses two ranks on one device; gloo reduces
CUDA tensors through the host).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Callable, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """This process's place in the data mesh: `size` ranks, this one
    `rank`, on `device`; `group` is the process group the collectives run
    over, None where there is none (one process, or a mesh built by hand)."""
    size: int = 1
    rank: int = 0
    device: torch.device = torch.device("cpu")
    group: Optional[Any] = None


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank(), dist.group.WORLD
    return 1, 0, None


def make_mesh(devices=None, device_ids: Sequence[int] = ()) -> DataMesh:
    """The mesh over every rank of the default process group.

    devices: one device for every rank, or a sequence of one per rank;
    else cuda:device_ids[rank], else the current CUDA device where there
    is one, else the CPU. device_ids mirrors the reference's --gpus: it
    names one CUDA ordinal per rank."""
    size, rank, group = _world()
    if len(device_ids) > 1 and len(device_ids) != size:
        raise ValueError(
            f"gpus={tuple(device_ids)} names {len(device_ids)} CUDA "
            f"ordinals for a world of {size} process(es): start one rank "
            "per ordinal with uresnet_pytorch_tpu_torch.parallel.launch "
            "(bin/uresnet_torch.py train/inference --gpus does so)")
    if devices is None:
        if device_ids:
            devices = [torch.device("cuda", i) for i in device_ids]
        elif torch.cuda.is_available():
            devices = torch.device("cuda", torch.cuda.current_device())
        else:
            devices = torch.device("cpu")
    if isinstance(devices, (str, torch.device)):
        devices = [devices] * size
    if len(devices) != size:
        raise ValueError(f"{len(devices)} devices for {size} ranks")
    return DataMesh(size, rank, torch.device(devices[rank]), group)


def shard_batch(blob: Mapping[str, Any], mesh: DataMesh) -> dict:
    """Rank r's rows [r*B/n, (r+1)*B/n) of every array of a global blob of
    B events."""
    if mesh.size == 1:
        return dict(blob)
    B = len(blob["n_voxels"])
    if B % mesh.size:
        raise ValueError(f"a batch of {B} events is not divisible by "
                         f"{mesh.size} ranks")
    k = B // mesh.size
    return {key: v[mesh.rank * k:(mesh.rank + 1) * k]
            for key, v in blob.items()}


def all_reduce_sum(mesh: Optional[DataMesh], *tensors: torch.Tensor,
                   grad: bool = False):
    """The tensors, each summed over the mesh's ranks, in one collective
    (packed into one buffer of the first tensor's dtype, then cast back).
    With `grad` the sum is differentiable and its backward sums the
    cotangents over the ranks. Without a process group the tensors come
    back as they are."""
    if mesh is None or mesh.group is None:
        return tensors
    flat = torch.cat([t.reshape(-1).to(tensors[0].dtype) for t in tensors])
    if grad:
        flat = dist_nn.all_reduce(flat, group=mesh.group)
    else:
        flat = flat.detach()
        dist.all_reduce(flat, group=mesh.group)
    parts = flat.split([t.numel() for t in tensors])
    return tuple(p.view(t.shape).to(t.dtype) for p, t in zip(parts, tensors))


@torch.no_grad()
def gather_rows(mesh: Optional[DataMesh], *tensors: torch.Tensor):
    """Every rank's `tensors` on rank 0, in one collective: on rank 0 a
    tuple holding, for each tensor, the ranks' copies stacked on a new
    leading axis (rank r's at index r); None on every other rank. Each
    tensor has the same shape and dtype on every rank, on any device. They
    travel as the bytes of one buffer, on the mesh's device under NCCL and
    through the host under gloo, and come back there. Without a process
    group the tuple holds each tensor as it is, with a leading axis of
    one."""
    if mesh is None or mesh.group is None:
        return tuple(t[None] for t in tensors)
    nccl = dist.get_backend(mesh.group) == "nccl"
    dev = mesh.device if nccl else torch.device("cpu")
    parts = [t.detach().to(dev).contiguous().reshape(-1).view(torch.uint8)
             for t in tensors]
    flat = torch.cat(parts)
    bufs = ([torch.empty_like(flat) for _ in range(mesh.size)]
            if mesh.rank == 0 else None)
    dist.gather(flat, bufs, dst=0, group=mesh.group)
    if mesh.rank != 0:
        return None
    sizes = [p.numel() for p in parts]
    ranks = [buf.split(sizes) for buf in bufs]
    # each slice copied out first: a view as a wider dtype needs an
    # aligned offset, which the packing does not give
    return tuple(torch.stack([r[i].clone().view(t.dtype).view(t.shape)
                              for r in ranks])
                 for i, t in enumerate(tensors))


@torch.no_grad()
def broadcast_(mesh: DataMesh, tensors: Sequence[torch.Tensor]) -> None:
    """Copy rank 0's values into each of the tensors on every rank, one
    collective per dtype."""
    if mesh.group is None:
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.broadcast(flat, src=0, group=mesh.group)
        for t, f in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(f.view(t.shape))


def _rank_main(rank: int, fn: Callable, n: int, device_ids: tuple,
               backend: str, store: str, args: tuple) -> None:
    if device_ids:
        torch.cuda.set_device(device_ids[rank])
    dist.init_process_group(backend, store=dist.FileStore(store, n),
                            rank=rank, world_size=n)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, n: int, device_ids: Sequence[int] = (),
           args: tuple = ()) -> None:
    """Run `fn(*args)` in n new processes joined in one process group (a
    FileStore in a temporary directory), rank r on cuda:device_ids[r], or
    on the CPU without device_ids. The backend is NCCL where every rank
    has a card of its own, else gloo. Returns when every rank has
    returned; a rank's exception is raised here
    (`torch.multiprocessing.ProcessRaisedException`, with its traceback),
    after the other ranks are stopped. fn must be importable by name: the
    ranks are spawned."""
    if device_ids and len(device_ids) != n:
        raise ValueError(f"{len(device_ids)} device ids for {n} ranks")
    distinct = len(set(device_ids)) == len(device_ids)
    backend = "nccl" if device_ids and distinct else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.start_processes(
            _rank_main, nprocs=n, join=True, start_method="spawn",
            args=(fn, n, tuple(device_ids), backend,
                  os.path.join(tmp, "store"), tuple(args)))
