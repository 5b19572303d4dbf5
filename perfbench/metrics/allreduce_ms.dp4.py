"""Device ms a step of rank 0's NCCL kernels: the all-reduces of the
masked BN's sums (forward, recompute and backward), of the loss's weight
sum and the counters, and of the gradients' one flat buffer. An NCCL
kernel runs from its launch until every rank has joined it, so the time
counts the wait on the slowest rank as well as the transfer."""

from perfbench.core.readers import matcher, per_step_ms

_nccl = matcher(("nccl",))


def read(ctx):
    return per_step_ms(ctx, _nccl)
