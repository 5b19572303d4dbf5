"""The numbers that decide `correct`: what the timed path produced against
the plain reference, each held to its limit (`perfbench/limits/`).

Inference (every voxel of the sampled batches):
- `logit_rel`: the gap between the program's log-probabilities and the
  reference's, each centred over the classes (so a logit, up to the
  constant softmax drops), as an RMS over every voxel and class, over the
  RMS of the reference's centred logits;
- `event_rel_max`: the same ratio taken per event, the worst event: one
  event's answer altered or left out shows here.

Training (the first three steps, taken by the worst leaf):
- `loss_gap`: the worst step's |loss - reference| / |reference|;
- `grad_gap`: the gap between the norms of a leaf's first gradient (the
  program's from Adam's first moment after step 1) and the reference's,
  over the reference's norm of that leaf or of the median leaf, whichever
  is larger;
- `change_gap`: the same of each leaf's change over the three steps
  (parameters and BN running moments);
- `grad_gap_median`, `change_gap_median`: the median leaf's gap, steadier
  from seed to seed than the worst leaf's;
- `grad_cos_gap`: 1 - the cosine of the angle between the whole first
  gradient (every leaf kept) and the reference's: its direction, which
  the gaps of norms barely see (a norm moves with the part of the error
  along the gradient only). The float8 control fails it; the gaps of
  norms and the loss it does not move three times over.
Leaves whose reference gradient is under a thousandth of the median
leaf's move under Adam by round-off alone; they are left out of both
gradient and change (a rule on the reference's gradient, not on names).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

LOG_FLOOR = math.log(1e-30)
SMALL_GRAD = 1e-3


def _centred_logp(logp: torch.Tensor) -> torch.Tensor:
    logp = logp.clamp(min=LOG_FLOOR)
    return logp - logp.mean(-1, keepdim=True)


def infer_numbers(checked: List[Tuple[np.ndarray, np.ndarray,
                                      torch.Tensor]]) -> Dict[str, float]:
    """checked: (probabilities (B, V, C) as served, n_voxels (B,),
    reference logits of the valid voxels, events in order) per batch."""
    num = den = 0.0
    worst = 0.0
    for probs, n_voxels, ref in checked:
        ref = ref.float()
        lr = _centred_logp(torch.log_softmax(ref, -1))
        off = 0
        for b, n in enumerate(n_voxels):
            n = int(n)
            p = torch.as_tensor(probs[b, :n], device=ref.device).float()
            d = _centred_logp(torch.log(p)) - lr[off:off + n]
            e_num = float((d * d).sum())
            e_den = float((lr[off:off + n] ** 2).sum())
            worst = max(worst, math.sqrt(e_num / max(e_den, 1e-30)))
            num += e_num
            den += e_den
            off += n
        if off != len(ref):
            raise RuntimeError(f"{len(ref)} reference rows for {off} voxels")
    return {"logit_rel": math.sqrt(num / max(den, 1e-30)),
            "event_rel_max": worst}


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.float().norm()) for k, v in tree.items()}


def _cos(a: torch.Tensor, b: torch.Tensor) -> float:
    """Cosine of two tensors' angle; 0 where either is zero."""
    a, b = a.float().flatten(), b.float().flatten()
    den = float(a.norm() * b.norm())
    return float(a @ b) / den if den > 0 else 0.0


def train_numbers(prog: dict, ref: dict, init: Dict[str, torch.Tensor],
                  detail: Optional[dict] = None) -> Dict[str, float]:
    """prog and ref: {"losses": [...], "grads": {leaf: first gradient},
    "state": {leaf: after the steps}}; init: the leaves before step 1.
    `detail`, where given, takes the worst leaves (gap, name, program's
    norm, reference's norm) and the median norms."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(prog["losses"], ref["losses"]))
    g_ref = _norms(ref["grads"])
    med_g = float(np.median(list(g_ref.values())))
    kept = [k for k, v in g_ref.items() if v >= SMALL_GRAD * med_g]
    g_prog = _norms({k: prog["grads"][k] for k in kept})
    g_gaps = [abs(g_prog[k] - g_ref[k]) / max(g_ref[k], med_g)
              for k in kept]
    leaves = kept + [k for k in ref["state"] if k not in g_ref]
    dev = ref["state"][leaves[0]].device
    c_ref = {k: float((ref["state"][k] - init[k].to(dev)).norm())
             for k in leaves}
    c_prog = {k: float((prog["state"][k].to(dev).float()
                        - init[k].to(dev)).norm()) for k in leaves}
    med_c = float(np.median(list(c_ref.values())))
    c_gaps = [abs(c_prog[k] - c_ref[k]) / max(c_ref[k], med_c, 1e-30)
              for k in leaves]
    if detail is not None:
        detail["grad"] = sorted(zip(g_gaps, kept, (g_prog[k] for k in kept),
                                    (g_ref[k] for k in kept)),
                                reverse=True)[:6]
        detail["change"] = sorted(zip(c_gaps, leaves,
                                      (c_prog[k] for k in leaves),
                                      (c_ref[k] for k in leaves)),
                                  reverse=True)[:6]
        detail["medians"] = (med_g, med_c)
        detail["loss_steps"] = [abs(a - b) / max(abs(b), 1e-30) for a, b in
                                zip(prog["losses"], ref["losses"])]
    cos_gap = 1.0 - _cos(torch.cat([prog["grads"][k].to(dev).flatten()
                                    for k in kept]),
                         torch.cat([ref["grads"][k].flatten() for k in kept]))
    return {"loss_gap": loss_gap,
            "grad_gap": max(g_gaps), "change_gap": max(c_gaps),
            "grad_cos_gap": cos_gap,
            "grad_gap_median": float(np.median(g_gaps)),
            "change_gap_median": float(np.median(c_gaps))}


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, dict]]:
    """correct, and each compared number (those with a limit) beside its
    limit; a number that is missing or not finite fails."""
    shown, ok = {}, bool(limits)
    for k, lim in limits.items():
        v = numbers.get(k)
        shown[k] = {"value": v, "limit": lim}
        if v is None or not (math.isfinite(v) and v <= lim):
            ok = False
    return ok, shown
