"""Device idle share of rank 0's traced window: 1 minus the union of its
card's kernel, copy and set intervals, over the window (torch.profiler
CUDA activity). Time rank 0 waits on the other ranks inside a collective
is busy here: an NCCL kernel runs while it waits."""

from perfbench.core.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
