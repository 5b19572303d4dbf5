"""Row gather between tile grids: `out[b, i] = src[b, idx[b, i]]` where
`ok[b, i]`, else 0.

Kernel A (`csrc/windowed_gather.cu`) replaces the TPU kernel
`uresnet_pytorch_tpu/ops/pallas/windowed_gather.py:gather_forward`, which
moves rows as block one-hot matmuls over windows plus an exact correction
list. Hopper has native indexed loads, so the kernel reads each row
directly and needs neither. `windowed_gather_plain` is the same function
in plain torch.
"""

from __future__ import annotations

import torch

from uresnet_pytorch_tpu_torch.ops import cuda

launches = 0   # kernel launches, for showing a run went through the kernel


def windowed_gather_plain(src: torch.Tensor, idx: torch.Tensor,
                          ok: torch.Tensor) -> torch.Tensor:
    """src (B, S, F), idx (B, N) int32, ok (B, N) bool -> (B, N, F).
    Rows whose idx lies outside [0, S) read as zeros, as in the kernel."""
    B, S, F = src.shape
    ok = ok & (idx >= 0) & (idx < S)
    rows = torch.where(ok, idx, 0).long()
    out = torch.gather(src, 1, rows[..., None].expand(B, rows.shape[1], F))
    return out.masked_fill_(~ok[..., None], 0)


def windowed_gather(src: torch.Tensor, idx: torch.Tensor,
                    ok: torch.Tensor) -> torch.Tensor:
    """The gather on `src`'s device: the plain version for a CPU tensor,
    the CUDA kernel for a CUDA tensor (raises if it cannot launch)."""
    if src.device.type == "cpu":
        return windowed_gather_plain(src, idx, ok)
    global launches
    B, S, F = src.shape
    N = idx.shape[1]
    if src.device.type != "cuda":
        raise ValueError(f"windowed_gather: unsupported device {src.device}")
    if idx.shape != (B, N) or ok.shape != (B, N):
        raise ValueError(f"windowed_gather: idx {tuple(idx.shape)} / ok "
                         f"{tuple(ok.shape)} do not match src {(B, S, F)}")
    if idx.dtype != torch.int32 or ok.dtype != torch.bool:
        raise TypeError("windowed_gather: idx must be int32 and ok bool")
    for name, t in (("src", src), ("idx", idx), ("ok", ok)):
        if t.device != src.device or not t.is_contiguous():
            raise ValueError(f"windowed_gather: {name} must be contiguous "
                             f"on {src.device}")
    out = torch.empty(B, N, F, dtype=src.dtype, device=src.device)
    row_bytes = F * src.element_size()
    if out.numel() == 0:
        return out
    # widest vector that divides the row and both base addresses
    vec = 16
    while row_bytes % vec or src.data_ptr() % vec or out.data_ptr() % vec:
        vec //= 2
    with torch.cuda.device(src.device):
        err = cuda.library().gather_rows(
            src.data_ptr(), idx.data_ptr(), ok.data_ptr(), out.data_ptr(),
            B, N, S, row_bytes, vec, torch.cuda.current_stream().cuda_stream)
    cuda.check(err, "gather_rows")
    launches += 1
    return out
