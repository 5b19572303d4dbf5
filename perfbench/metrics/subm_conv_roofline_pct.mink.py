"""MinkUNet34C's submanifold convolutions, the 5^3 stem included, as a
share of their roofline in the traced training steps: the least time of
their forward, d_x and d_W (three times the forward's work: FLOPs 2 pairs
Cin Cout, bytes each active row and the weights once, in bfloat16;
`reference/minkunet34c.py:work`) over the device time of every
convolution kernel of the step: kernels B and C, D and E (the stem's halo
extend), and cuDNN's."""

from perfbench.core.readers import matcher, roofline_pct

CONV_KERNELS = ("halo_conv_kernel", "halo_conv_dw_kernel",
                "halo_extend_kernel", "halo_transpose_kernel", "fprop",
                "dgrad", "wgrad", "convolve")


def read(ctx):
    return roofline_pct(ctx, "sm_bound_s", matcher(CONV_KERNELS))
