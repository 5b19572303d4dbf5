"""Device ms per MinkUNet34C training step under the program's span
`uresnet.norm` (BN, the residual, the activation and the re-mask): the
forward, its recompute and its backward (`core/spans.py`). The
projections' BN runs under `uresnet.shortcut` instead."""

from perfbench.core.spans import device_ms

NORM = ("uresnet.norm", "uresnet.recompute.norm")


def read(ctx):
    return device_ms(ctx, lambda leaf: leaf in NORM)
