"""Device ms per batch or step under the program's span `uresnet.norm`
(BN, its activation and the re-mask): the forward, its recompute and its
backward (`core/spans.py`)."""

from perfbench.core.spans import device_ms

NORM = ("uresnet.norm", "uresnet.recompute.norm")


def read(ctx):
    return device_ms(ctx, lambda leaf: leaf in NORM)
