"""The submanifold convolutions' share of their roofline in the traced
forwards: the sum over convolutions of max(FLOPs / peak, bytes / peak
bandwidth) over the device time of the kernels that run them. FLOPs are
2 pairs Cin Cout; bytes each active input and output row and the weights
once, in bfloat16."""

from perfbench.core.readers import matcher, roofline_pct

# the port's submanifold convolution kernels (B; D and E on the unfused
# path) and cuDNN's, where the unfused path hands a conv to it
CONV_KERNELS = ("halo_conv_kernel", "halo_extend_kernel",
                "halo_transpose_kernel", "fprop", "dgrad", "wgrad",
                "convolve")


def read(ctx):
    return roofline_pct(ctx, "sm_bound_s", matcher(CONV_KERNELS))
