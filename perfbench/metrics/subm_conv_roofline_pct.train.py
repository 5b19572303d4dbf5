"""The submanifold convolutions' share of their roofline in the traced
training steps: forward, d_x and d_W (three times the forward's work:
FLOPs 2 pairs Cin Cout, bytes each active row and the weights once, in
bfloat16), over the device time of every convolution kernel of the step,
kernel C (d_W) included."""

from perfbench.core.readers import matcher, roofline_pct

CONV_KERNELS = ("halo_conv_kernel", "halo_conv_dw_kernel",
                "halo_extend_kernel", "halo_transpose_kernel", "fprop",
                "dgrad", "wgrad", "convolve")


def read(ctx):
    return roofline_pct(ctx, "sm_bound_s", matcher(CONV_KERNELS))
