"""The whole step's share of the card's bfloat16 peak: the model's FLOPs
over the traced window. Sparse cells count the sparse-ideal FLOPs (active
(site, neighbour) pairs from the events' coordinates), the dense cell
every cell of the volume. Training: three forwards' work a step,
the recompute not counted."""

from perfbench.core.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx)
