"""Cells at a size a CPU test can hold: the cell's own files, with the
model and the traffic cut down. float32 compute, so that a sound run
agrees with the reference to rounding."""

SPARSE = dict(uresnet_filters=8, uresnet_num_strides=3, spatial_size=64,
              max_voxels=2048, min_level_capacity=256, tile_sizes=[4, 2, 2],
              compute_dtype="float32")
DENSE = dict(uresnet_filters=4, uresnet_num_strides=3, spatial_size=16,
             max_voxels=512, compute_dtype="float32")


def overrides(workload: str, **model):
    dense = workload.startswith("dense")
    mo = dict(DENSE if dense else SPARSE, **model)
    to = dict(batch=2, pool_events=6, mean_voxels=300 if dense else 1500,
              pool_workers=0, trace_seconds=1, checked_batches=2)
    return mo, to


def execute(workload: str, seed: int = 3000000001, seconds: float = 1.0,
            trace: int = 0, **model):
    import time
    from perfbench import run
    mo, to = overrides(workload, **model)
    args = run.parse(["--workload", workload, "--seed", str(seed),
                      "--seconds", str(seconds), "--trace", str(trace)])
    return run.execute(args, device="cpu", model_overrides=mo,
                       traffic_overrides=to, t_start=time.perf_counter(),
                       log=lambda *a: None)
