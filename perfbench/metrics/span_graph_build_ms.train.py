"""Device ms per batch under the program's span `uresnet.graph_build`
(`build_tile_graph`, the tile counters' sums and the masks) inside the
traced window (`core/spans.py`)."""

from perfbench.core.spans import device_ms


def read(ctx):
    return device_ms(ctx, lambda leaf: leaf == "uresnet.graph_build")
