"""Device idle ms per batch while the host was in the program's span
`uresnet.graph_build`: the idle gaps of the traced window whose midpoint
falls in it on the step's thread (`core/spans.py`)."""

from perfbench.core.spans import idle_ms


def read(ctx):
    return idle_ms(ctx, lambda path: "uresnet.graph_build" in path)
