"""Rank 0's share of one card's bfloat16 peak: the sparse-ideal FLOPs of
rank 0's events (its shard of each global step; active (site, neighbour)
pairs from the events' coordinates), three forwards' work a step, the
recompute not counted, over its traced window, as `mfu_pct.train`
reckons them on one card."""

from perfbench.core.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx)
