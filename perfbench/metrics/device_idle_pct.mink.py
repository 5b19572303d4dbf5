"""Device idle share of the MinkUNet34C training cell's traced window: 1
minus the union of the device's kernel, copy and set intervals, over the
window (torch.profiler CUDA activity)."""

from perfbench.core.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
