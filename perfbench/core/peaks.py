"""The card's peaks, and what `nvidia-smi` says of the card.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full power limit of 700 W): 989 TFLOP/s in
bfloat16 on the tensor cores and 3.35 TB/s of HBM3. A card set below
700 W runs slower under load, so every run prints the card's power limit
beside its shares of these peaks.
"""

from __future__ import annotations

import shutil
import subprocess

PEAK_FLOPS = 989e12       # bfloat16 tensor-core FLOP/s
PEAK_BYTES = 3.35e12      # HBM3 bytes/s


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take for this work."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


QUERY = "name,power.limit,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu"


def card_state() -> str:
    """One line per card from nvidia-smi: name, power limit, clocks and
    temperature; a note where nvidia-smi is not there."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "nvidia-smi: not found"
    res = subprocess.run([smi, f"--query-gpu={QUERY}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    return (res.stdout.strip() or res.stderr.strip()).replace("\n", " | ")
