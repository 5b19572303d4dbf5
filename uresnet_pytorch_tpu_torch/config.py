"""Typed configuration of the port's sparse U-ResNet.

Port of `uresnet_pytorch_tpu/config.py`. Every field keeps the
reference's name, default and checks, and the derived sizes (`n_planes`,
`level_capacity`, `tile_occupancy_at`) are computed the same way, so one
set of keyword arguments builds the same model in both packages, and the
CLI (`flags.py`) fills the same fields from the same flags. As in the
reference, `cfg.BATCH_SIZE` reads `batch_size`. The reference's
correction-budget field (`corr_scale`) sizes TPU window lists the port's
exact maps do not have, and is left out.
"""

from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class URESNetConfig:
    # ---- model ----
    # {uresnet_sparse, uresnet_dense, minkunet34c}; the last is the port's
    # own (MinkowskiEngine's MinkUNet34C, models/minkunet_tiled.py)
    model_name: str = "uresnet_sparse"
    num_class: int = 5
    uresnet_filters: int = 16           # base filter count m
    uresnet_num_strides: int = 5        # resolution levels
    spatial_size: int = 192             # cube edge, padded to a power of two
    data_dim: int = 3                   # 2 or 3
    reps: int = 2                       # residual blocks per level
    width_ramp: str = "linear"          # {linear, geometric}
    leaky_relu_slope: float = 0.0
    bn_momentum: float = 0.9            # running = momentum*running + (1-momentum)*batch
    bn_eps: float = 1e-4
    input_merge_mode: str = "sum"       # duplicate-coordinate merge: {sum, mean, max, last}

    # ---- sparse capacity (static shapes) ----
    max_voxels: int = 0                 # level-0 rows per event; 0 => auto
    capacity_factor: float = 1.0        # cap[l+1] = cap[l] * factor
    min_level_capacity: int = 256

    # ---- tile engine ----
    sparse_engine: str = "tile"         # {tile, gather}: tiled-dense or row-gather engine
    tile_size: int = 4                  # tile edge t (power of two)
    tile_occupancy: float = 4.5         # voxels per occupied tile (capacity divisor)
    tile_sizes: Optional[Tuple[int, ...]] = None   # per-level t; stays or halves
    tile_occupancies: Optional[Tuple[float, ...]] = None
    min_tiles: int = 64                 # floor on per-level tile capacity
    # training recompute: "stage" checkpoints whole encoder/decoder stages,
    # "stage_dots" also saves their halo-conv outputs, "stage_dots_deep"
    # does that except at level 0, "none" saves everything
    remat_mode: str = "stage"    # {stage, stage_dots, stage_dots_deep, none}

    # ---- io ----
    io_type: str = "h5"                 # {h5, larcv_sparse, larcv_dense, synthetic}
    input_file: Tuple[str, ...] = ()
    output_file: str = ""               # non-empty => inference writes predictions
    data_keys: Tuple[str, ...] = ("data", "label")  # optional 3rd key = weight
    batch_size: int = 1
    minibatch_size: int = -1            # per-device slice; -1 => batch_size
    shuffle: bool = True
    limit_num_files: int = 0
    num_threads: int = 1                # prefetch threads
    prefetch_depth: int = 2

    # ---- training ----
    train: bool = True
    learning_rate: float = 0.001        # Adam (b1 0.9, b2 0.999, eps 1e-8)
    iteration: int = 10000
    report_step: int = 1
    checkpoint_step: int = 500
    weight_prefix: str = "./weights/snapshot"
    log_dir: str = "./log"
    seed: int = 0                       # parameter init
    weight_key: str = ""                # non-empty => per-voxel loss weights

    # ---- restore / inference ----
    model_path: str = ""                # checkpoint path or glob
    gpus: Tuple[int, ...] = ()          # CUDA ordinal per rank; () = current
    resume: bool = False                # restore the latest {weight_prefix}-*.ckpt

    # ---- precision / profiling ----
    compute_dtype: str = "bfloat16"     # {bfloat16, float32}
    param_dtype: str = "float32"        # unused, as in the reference
    profile_dir: str = ""               # non-empty => torch.profiler trace here

    def __post_init__(self):
        if self.data_dim not in (2, 3):
            raise ValueError(f"data_dim must be 2 or 3, got {self.data_dim}")
        if self.model_name not in ("uresnet_sparse", "uresnet_dense",
                                   "minkunet34c"):
            raise ValueError(f"unknown model_name {self.model_name!r}")
        if self.remat_mode not in ("stage", "stage_dots",
                                   "stage_dots_deep", "none"):
            raise ValueError(f"unknown remat_mode {self.remat_mode!r}")
        if self.width_ramp not in ("linear", "geometric"):
            raise ValueError(f"unknown width_ramp {self.width_ramp!r}")
        if self.input_merge_mode not in ("sum", "mean", "max", "last"):
            raise ValueError(
                f"unknown input_merge_mode {self.input_merge_mode!r}")
        if self.spatial_size & (self.spatial_size - 1):
            rounded = 1 << (self.spatial_size - 1).bit_length()
            warnings.warn(
                f"spatial_size {self.spatial_size} is not a power of two; "
                f"padding the compute grid to {rounded} (voxel coordinates "
                "are unchanged)", stacklevel=2)
            object.__setattr__(self, "spatial_size", rounded)
        if self.uresnet_num_strides < 1:
            raise ValueError("uresnet_num_strides must be >= 1")
        if (self.spatial_size >> (self.uresnet_num_strides - 1)) < 1:
            raise ValueError("too many strides for spatial_size")
        if self.sparse_engine not in ("tile", "gather"):
            raise ValueError(f"unknown sparse_engine {self.sparse_engine!r}")
        if self.tile_size & (self.tile_size - 1) or self.tile_size < 2:
            raise ValueError("tile_size must be a power of two >= 2")
        if self.tile_sizes is not None:
            ts = tuple(int(t) for t in self.tile_sizes)
            if len(ts) != self.uresnet_num_strides:
                raise ValueError("tile_sizes must have one entry per level")
            for i, t in enumerate(ts):
                if t & (t - 1) or t < 2:
                    raise ValueError("tile_sizes entries must be powers of "
                                     "two >= 2")
                if i and ts[i] not in (ts[i - 1], ts[i - 1] // 2):
                    raise ValueError(
                        "tile_sizes may only stay or halve between levels "
                        f"(got {ts[i - 1]} -> {ts[i]} at level {i})")
            object.__setattr__(self, "tile_sizes", ts)
        if self.tile_occupancies is not None:
            to = tuple(float(o) for o in self.tile_occupancies)
            if len(to) != self.uresnet_num_strides:
                raise ValueError(
                    "tile_occupancies must have one entry per level")
            object.__setattr__(self, "tile_occupancies", to)
        if (self.sparse_engine == "tile"
                and (self.spatial_size >> (self.uresnet_num_strides - 1)) < 2):
            raise ValueError(
                "tile engine needs spatial_size >= 2 at the deepest level; "
                "reduce uresnet_num_strides")
        if self.max_voxels == 0:
            # ~1e5 active voxels at 512^3, scaled by volume, 2x headroom
            frac = 1e5 / float(512 ** 3)
            auto = int(frac * self.spatial_size ** self.data_dim * 2)
            object.__setattr__(
                self, "max_voxels",
                max(self.min_level_capacity, _round_up(auto, 128)))

    def __getattr__(self, name: str):
        """UPPERCASE access as in the reference: cfg.BATCH_SIZE."""
        if name.isupper():
            try:
                return object.__getattribute__(self, name.lower())
            except AttributeError:
                pass
        raise AttributeError(name)

    @property
    def dim(self) -> int:
        return self.data_dim

    @property
    def n_planes(self) -> Tuple[int, ...]:
        m, s = self.uresnet_filters, self.uresnet_num_strides
        if self.width_ramp == "linear":
            return tuple(m * (i + 1) for i in range(s))
        return tuple(m * (2 ** i) for i in range(s))

    def level_spatial_size(self, level: int) -> int:
        return max(1, self.spatial_size >> level)

    def tile_occupancy_at(self, level: int) -> float:
        """Capacity divisor at `level`: tile_occupancies if given, else
        tile_occupancy scaled by t_l / t_0 under a tile_sizes schedule (it
        ignores the spatial clamp, as the reference does)."""
        if self.tile_occupancies is not None:
            return self.tile_occupancies[level]
        if self.tile_sizes is None:
            return self.tile_occupancy
        return max(1.0, self.tile_occupancy
                   * self.tile_sizes[level] / self.tile_sizes[0])

    def level_capacity(self, level: int) -> int:
        """Static active-site capacity (padded rows) at resolution `level`."""
        cap = self.max_voxels * (self.capacity_factor ** level)
        cap = max(self.min_level_capacity, int(cap))
        cells = self.level_spatial_size(level) ** self.data_dim
        return _round_up(min(cap, cells), 8)

    def replace(self, **kw) -> "URESNetConfig":
        return dataclasses.replace(self, **kw)
