"""Device ms per MinkUNet34C training step of the kernels that are none
of: the port's CUDA library (kernels A-E and the `norm_act_*` kernels),
cuBLAS, cuDNN or NCCL (graph build and glue: sorts, scatters, casts,
masks, loss, Adam). Copies and sets are not kernels."""

from perfbench.core.readers import matcher, per_step_ms

OTHERS = (
    # the port's kernels A-E and its batch norm
    "halo_conv_kernel", "halo_conv_dw_kernel", "halo_extend_kernel",
    "halo_transpose_kernel", "link_gather_kernel", "gather_rows_kernel",
    "norm_act_",
    # cuBLAS and its CUTLASS kernels
    "gemm", "cublas", "cutlass", "xmma", "splitk", "gemv",
    # cuDNN
    "cudnn", "fprop", "dgrad", "wgrad", "convolve", "implicit",
    # NCCL
    "nccl",
    # not kernels
    "memcpy", "memset")
_other = matcher(OTHERS)


def read(ctx):
    return per_step_ms(ctx, lambda name: not _other(name))
