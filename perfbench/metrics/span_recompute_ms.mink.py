"""Device ms per MinkUNet34C training step under the program's
`uresnet.recompute.*` spans: what `torch.utils.checkpoint` runs again in
backward under `stage_dots`, every stage's (`core/spans.py`)."""

from perfbench.core.spans import RECOMPUTE, device_ms


def read(ctx):
    return device_ms(ctx, lambda leaf: leaf.startswith(RECOMPUTE))
