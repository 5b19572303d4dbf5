"""The CLI's flags. Port of `uresnet_pytorch_tpu/flags.py`: the same
``train`` / ``inference`` / ``iotest`` subcommands with the same flag
spellings (``--model-name/-mn`` etc.), parsed into the port's
:class:`URESNetConfig`, whose UPPERCASE attributes answer as in the
reference.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from uresnet_pytorch_tpu_torch.config import URESNetConfig


def _add_shared(p: argparse.ArgumentParser) -> None:
    d = URESNetConfig.__dataclass_fields__
    # model
    p.add_argument("--model-name", "-mn", type=str, default=d["model_name"].default,
                   help="uresnet_sparse | uresnet_dense | minkunet34c")
    p.add_argument("--num-class", "-nc", type=int, default=d["num_class"].default)
    p.add_argument("--uresnet-filters", "-uf", type=int, default=d["uresnet_filters"].default)
    p.add_argument("--uresnet-num-strides", "-uns", type=int, default=d["uresnet_num_strides"].default)
    p.add_argument("--spatial-size", "-ss", type=int, default=d["spatial_size"].default)
    p.add_argument("--data-dim", "-dd", type=int, default=d["data_dim"].default)
    p.add_argument("--reps", type=int, default=d["reps"].default)
    p.add_argument("--width-ramp", type=str, default=d["width_ramp"].default)
    # sparse capacity
    p.add_argument("--max-voxels", type=int, default=0, help="0 = auto from spatial size")
    p.add_argument("--capacity-factor", type=float, default=d["capacity_factor"].default)
    # io
    p.add_argument("--io-type", "-io", type=str, default=d["io_type"].default,
                   help="h5 | synthetic | larcv_sparse | larcv_dense")
    p.add_argument("--input-file", "-if", type=str, default="",
                   help="comma-separated list of input files")
    p.add_argument("--output-file", "-of", type=str, default="")
    p.add_argument("--data-keys", "-dkeys", type=str, default="data,label",
                   help="comma list, e.g. data,label[,weight]")
    p.add_argument("--batch-size", "-bs", type=int, default=d["batch_size"].default)
    p.add_argument("--minibatch-size", "-mbs", type=int, default=d["minibatch_size"].default,
                   help="per-device slice of the batch; -1 = batch_size / n_devices")
    p.add_argument("--shuffle", "-sh", type=int, default=1)
    p.add_argument("--limit-num-files", "-lnf", type=int, default=0)
    p.add_argument("--num-threads", "-nt", type=int, default=d["num_threads"].default)
    # train / restore
    p.add_argument("--learning-rate", "-lr", type=float, default=d["learning_rate"].default)
    p.add_argument("--iteration", "-it", type=int, default=d["iteration"].default)
    p.add_argument("--report-step", "-rs", type=int, default=d["report_step"].default)
    p.add_argument("--checkpoint-step", "-chks", type=int, default=d["checkpoint_step"].default)
    p.add_argument("--weight-prefix", "-wp", type=str, default=d["weight_prefix"].default)
    p.add_argument("--log-dir", "-ld", type=str, default=d["log_dir"].default)
    p.add_argument("--seed", type=int, default=d["seed"].default)
    p.add_argument("--weight-key", "-wk", type=str, default="")
    p.add_argument("--model-path", "-mp", type=str, default="")
    p.add_argument("--gpus", type=str, default="",
                   help="CUDA ordinals, comma-separated; several start "
                        "one data-parallel rank each")
    p.add_argument("--resume", action="store_true")
    # precision, memory and tile schedule
    p.add_argument("--compute-dtype", type=str, default=d["compute_dtype"].default)
    p.add_argument("--remat-mode", type=str, default=d["remat_mode"].default,
                   help="training remat: stage | stage_dots | none")
    p.add_argument("--tile-sizes", type=str, default="",
                   help="per-level tile-edge schedule for the tile engine, "
                        "e.g. 4,2,2,2,2 (t may stay or halve per level; "
                        "see config.tile_sizes). Empty = tile_size "
                        "everywhere")
    p.add_argument("--profile-dir", type=str, default="")


def _split_csv(s: str) -> tuple:
    return tuple(x for x in (t.strip() for t in s.split(",")) if x)


def _to_config(ns: argparse.Namespace, train: bool) -> URESNetConfig:
    return URESNetConfig(
        model_name=ns.model_name,
        num_class=ns.num_class,
        uresnet_filters=ns.uresnet_filters,
        uresnet_num_strides=ns.uresnet_num_strides,
        spatial_size=ns.spatial_size,
        data_dim=ns.data_dim,
        reps=ns.reps,
        width_ramp=ns.width_ramp,
        max_voxels=ns.max_voxels,
        capacity_factor=ns.capacity_factor,
        io_type=ns.io_type,
        input_file=_split_csv(ns.input_file),
        output_file=ns.output_file,
        data_keys=_split_csv(ns.data_keys) or ("data", "label"),
        batch_size=ns.batch_size,
        minibatch_size=ns.minibatch_size,
        shuffle=bool(ns.shuffle),
        limit_num_files=ns.limit_num_files,
        num_threads=ns.num_threads,
        remat_mode=ns.remat_mode,
        tile_sizes=tuple(int(t) for t in _split_csv(ns.tile_sizes)) or None,
        train=train,
        learning_rate=ns.learning_rate,
        iteration=ns.iteration,
        report_step=ns.report_step,
        checkpoint_step=ns.checkpoint_step,
        weight_prefix=ns.weight_prefix,
        log_dir=ns.log_dir,
        seed=ns.seed,
        weight_key=ns.weight_key,
        model_path=ns.model_path,
        gpus=tuple(int(g) for g in _split_csv(ns.gpus)),
        resume=ns.resume,
        compute_dtype=ns.compute_dtype,
        profile_dir=ns.profile_dir,
    )


def parse_args(argv: Optional[Sequence[str]] = None):
    """Parse CLI args. Returns (mode, URESNetConfig) with mode in
    {train, inference, iotest}."""
    parser = argparse.ArgumentParser(
        prog="uresnet_torch",
        description="sparse U-ResNet for LArTPC semantic segmentation "
                    "(PyTorch/CUDA)")
    sub = parser.add_subparsers(dest="mode", required=True)
    for mode in ("train", "inference", "iotest"):
        _add_shared(sub.add_parser(mode))
    ns = parser.parse_args(argv)
    cfg = _to_config(ns, train=(ns.mode == "train"))
    return ns.mode, cfg


class URESNET_FLAGS:
    """Reference-API shim: ``URESNET_FLAGS().parse_args()`` returns a config
    whose UPPERCASE attributes match the upstream convention."""

    def parse_args(self, argv: Optional[Sequence[str]] = None) -> URESNetConfig:
        mode, cfg = parse_args(argv)
        return cfg
