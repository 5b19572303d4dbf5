"""The dense model's convolutions' share of their roofline in the traced
training steps: three times each forward convolution's max(FLOPs / peak,
bytes / peak bandwidth), from the shapes (every cell of the volume; input,
output and weights once, in bfloat16), over the device time of cuDNN's
convolution kernels."""

from perfbench.core.readers import matcher, roofline_pct

CUDNN_CONV = ("cudnn", "fprop", "dgrad", "wgrad", "convolve", "implicit")


def read(ctx):
    return roofline_pct(ctx, "dense_conv_bound_s", matcher(CUDNN_CONV))
