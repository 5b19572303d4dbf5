"""Cells at a size a CPU test can hold: the cell's own files, with the
model and the traffic cut down. float32 compute, so that a sound run
agrees with the reference to rounding."""

SPARSE = dict(uresnet_filters=8, uresnet_num_strides=3, spatial_size=64,
              max_voxels=2048, min_level_capacity=256, tile_sizes=[4, 2, 2],
              compute_dtype="float32")
DENSE = dict(uresnet_filters=4, uresnet_num_strides=3, spatial_size=16,
             max_voxels=512, compute_dtype="float32")


def overrides(workload: str, root=None, **model):
    """Two events a card, three batches an epoch."""
    from perfbench.core.cells import ROOT, load_cell
    dense = workload.startswith("dense")
    chips = load_cell(workload, root=root or ROOT).chips
    mo = dict(DENSE if dense else SPARSE, **model)
    to = dict(batch=2 * chips, pool_events=6 * chips,
              mean_voxels=300 if dense else 1500,
              pool_workers=0, trace_seconds=1, checked_batches=2)
    return mo, to


def execute(workload: str, seed: int = 3000000001, seconds: float = 1.0,
            trace: int = 0, rank_setup=None, root=None, **model):
    import time
    from perfbench import run
    mo, to = overrides(workload, root, **model)
    args = run.parse(["--workload", workload, "--seed", str(seed),
                      "--seconds", str(seconds), "--trace", str(trace)])
    return run.execute(args, device="cpu", model_overrides=mo,
                       traffic_overrides=to, t_start=time.perf_counter(),
                       log=lambda *a: None, rank_setup=rank_setup,
                       root=root or run.ROOT)


# The cell over four cards, which BENCHMARK.json leaves out until its
# rate's spread between runs is understood: its manifest entries, for a
# checkout of its own (`dp4_root`). Its files (traffic, limits, readers)
# are under perfbench/.
DP4 = "sparse16_dp4_train_b32"
DP4_ENTRIES = {
    "workloads": [
        {"name": DP4, "config": "uresnet_sparse_m16_512",
         "traffic": "train_b32_v150k_dp4", "chips": 4,
         "why": "data-parallel training on 4 cards, 8 ~1e5-voxel events a "
                "rank: batch-global BN moments and gradients all-reduced "
                "over NCCL, the collectives' share of a step"}],
    "end_to_end": [
        {"name": "dp4_train_events_per_s", "unit": "events/s",
         "better": "higher", "bound": 0.25, "source": "host_clock",
         "workloads": [DP4]}],
    "per_layer": [
        {"name": "device_idle_pct.dp4", "unit": "%", "better": "lower",
         "source": "device_trace", "layer": "device",
         "moves": "dp4_train_events_per_s", "workloads": [DP4]},
        {"name": "mfu_pct.dp4", "unit": "%", "better": "higher",
         "source": "device_trace", "layer": "whole step",
         "moves": "dp4_train_events_per_s", "workloads": [DP4]},
        {"name": "allreduce_ms.dp4", "unit": "ms", "better": "lower",
         "source": "device_trace", "layer": "collectives",
         "moves": "dp4_train_events_per_s", "workloads": [DP4]}],
}


def dp4_root(path):
    """A checkout at `path` whose manifest is BENCHMARK.json with the
    four-card cell's entries added; `perfbench/` is the repo's own."""
    import json
    from perfbench.core.cells import BENCH, manifest
    man = manifest()
    for section, entries in DP4_ENTRIES.items():
        man[section] = man[section] + entries
    (path / "BENCHMARK.json").write_text(json.dumps(man))
    (path / "perfbench").symlink_to(BENCH, target_is_directory=True)
    return path
