"""Share of the tile engine's capacity cells (batch x tiles x t^d, every
level) that hold an active voxel, over every forward of the traced
MinkUNet34C window: the program's counters, read after the window."""

from perfbench.core.spans import cell_fill_pct


def read(ctx):
    return cell_fill_pct()
