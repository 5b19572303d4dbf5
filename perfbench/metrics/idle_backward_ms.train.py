"""Device idle ms per step while the host was in the program's span
`uresnet.backward` (`core/spans.py`)."""

from perfbench.core.spans import idle_ms


def read(ctx):
    return idle_ms(ctx, lambda path: "uresnet.backward" in path)
