"""Device idle ms per batch while the host was in `uresnet.step` but in
none of its graph build, host-to-device copies, backward and optimizer
spans: the forward's launch gaps (`core/spans.py`)."""

from perfbench.core.spans import idle_ms

NOT_FORWARD = ("uresnet.graph_build", "uresnet.h2d", "uresnet.backward",
               "uresnet.optimizer")


def read(ctx):
    return idle_ms(ctx, lambda path: "uresnet.step" in path
                   and not any(p in path for p in NOT_FORWARD))
