"""Device ms per MinkUNet34C training step under the program's span
`uresnet.shortcut`: the BasicBlocks' 1x1 projection shortcuts and their
BN, forward, recompute and backward (`core/spans.py`)."""

from perfbench.core.spans import device_ms

SHORTCUT = ("uresnet.shortcut", "uresnet.recompute.shortcut")


def read(ctx):
    return device_ms(ctx, lambda leaf: leaf in SHORTCUT)
