"""MinkUNet34C's whole training step as a share of the card's bfloat16
peak: the sparse-ideal FLOPs of the traced steps (the configuration's
reference, `reference/minkunet34c.py:work`: active (site, neighbour) pairs
over 125 offsets for the stem and 27 for the blocks, the stride-2 convs,
the 1x1 projections and the head), three forwards a step, the recompute
not counted, over the traced window."""

from perfbench.core.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx)
