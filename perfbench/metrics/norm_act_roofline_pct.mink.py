"""The batch-norm kernels (`norm_act_*`: BN, the residual, the activation
and the re-mask) as a share of their roofline in the traced MinkUNet34C
training steps: the bytes they must move, worked out from the window's
`active_cells` counter by the configuration's reference
(`reference/minkunet34c.py:norm_bytes`: each active row once a pass, 8
elements a channel, 12 with the residual, in bfloat16), at the card's
HBM rate, over the device time of every `norm_act_*` kernel (recompute
included). None where the program keeps no such counter or no such kernel
ran."""

from pathlib import Path

from perfbench.core.cells import load_module
from perfbench.core.readers import matcher

REFERENCE = Path(__file__).resolve().parents[1] / "reference" / \
    "minkunet34c.py"
NORM_KERNELS = ("norm_act_",)


def read(ctx):
    from uresnet_pytorch_tpu_torch.utils import timing
    counters = getattr(timing, "counters", None)
    active = (counters() if counters is not None else {}).get("active_cells")
    t = ctx.trace.kernel_s(matcher(NORM_KERNELS))
    if not active or t <= 0:
        return None
    ref = load_module(REFERENCE, "perfbench_reference_")
    return 100.0 * ref.norm_bytes(active) / ctx.peak_bytes / t
