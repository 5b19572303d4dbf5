"""Upstream SparseConvNet-convention checkpoint import, by structure.

Port of `uresnet_pytorch_tpu/utils/scn_import.py`. The upstream sparse
model is an `scn.Sequential` tree, so its state-dict keys are positional
chains (`sparseModel.3.1.0.weight`) whose exact indices depend on the
builder's nesting. The importer relies on two facts that hold for any
nesting instead:

1. state-dict order is module construction order, and SCN's UNet builder
   constructs depth-recursively: a level's blocks, the down conv, the
   inner levels, the up conv, the decoder blocks, then the BN and Linear
   head;
2. each parameterized SCN module has a signature of its own: BatchNorm
   (running moments), SubmanifoldConvolution ((3^d, Cin, Cout)),
   Convolution / Deconvolution ((2^d, Cin, Cout)), NetworkInNetwork
   ((Cin, Cout) without a bias, or (1, Cin, Cout)), the Linear head (a
   bias).

So the checkpoint's parameter groups are classified in order, the sparse
model's slots are generated in the same recursive order from the
configuration, and the two are matched one to one with shape checks; any
mismatch raises. Offsets inside a conv weight are taken in raster order
(last axis fastest), `ops/sparse_graph.kernel_offsets`'s.
`export_reference_style` writes such a state dict from a tree.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, List, Tuple

import numpy as np

from uresnet_pytorch_tpu_torch.config import URESNetConfig


def reference_slot_sequence(cfg: URESNetConfig) -> List[Dict[str, Any]]:
    """The sparse model's parameterized modules in SCN construction order:
    dicts with `kind` ('smconv', 'bn', 'updown', 'nin', 'linear') and
    `path` into the tree (the linear head also `bias_path`)."""
    planes = cfg.n_planes
    K = 3 ** cfg.data_dim
    Kd = 2 ** cfg.data_dim
    slots: List[Dict[str, Any]] = []

    def bn(path):
        slots.append({"kind": "bn", "path": path})

    def smconv(path):
        slots.append({"kind": "smconv", "path": path, "K": K})

    def updown(path):
        slots.append({"kind": "updown", "path": path, "K": Kd})

    def block(name, in_w, out_w):
        if in_w != out_w:
            slots.append({"kind": "nin",
                          "path": (name, "w_shortcut"), "K": 1})
        bn((name, "bn_a", "MaskedBatchNorm_0"))
        smconv((name, "conv_a", "w"))
        bn((name, "bn_b", "MaskedBatchNorm_0"))
        smconv((name, "conv_b", "w"))

    smconv(("stem", "w"))

    def rec(l):
        w = planes[l]
        for r in range(cfg.reps):
            block(f"enc{l}_block{r}", w, w)
        if l < cfg.uresnet_num_strides - 1:
            bn((f"down{l}_bnact", "MaskedBatchNorm_0"))
            updown((f"down{l}_w",))
            rec(l + 1)
            bn((f"up{l}_bnact", "MaskedBatchNorm_0"))
            updown((f"up{l}_w",))
            for r in range(cfg.reps):
                block(f"dec{l}_block{r}", 2 * w if r == 0 else w, w)

    rec(0)
    bn(("head_bnact", "MaskedBatchNorm_0"))
    slots.append({"kind": "linear", "path": ("head_w",),
                  "bias_path": ("head_b",)})
    return slots


def classify_groups(sd: Mapping[str, np.ndarray], data_dim: int
                    ) -> List[Dict[str, Any]]:
    """The state dict's keys grouped by module prefix (in insertion
    order), each group classified by its parameter signature."""
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        prefix, leaf = k.rsplit(".", 1) if "." in k else ("", k)
        groups.setdefault(prefix, {})[leaf] = np.asarray(v)
    out = []
    K3, K2 = 3 ** data_dim, 2 ** data_dim
    for prefix, g in groups.items():
        ent: Dict[str, Any] = {"prefix": prefix, "arrays": g}
        if "running_mean" in g:
            ent["kind"] = "bn"
        elif "weight" in g and g["weight"].ndim == 3:
            k = g["weight"].shape[0]
            if k == K3:
                ent["kind"] = "smconv"
            elif k == K2:
                ent["kind"] = "updown"
            elif k == 1:
                ent["kind"] = "nin"
            else:
                raise ValueError(
                    f"{prefix}: unexpected offset count {k} (dim={data_dim})")
        elif "weight" in g and g["weight"].ndim == 2:
            ent["kind"] = "linear" if "bias" in g else "nin"
        else:
            raise ValueError(f"{prefix}: unrecognized group {list(g)}")
        out.append(ent)
    return out


def _numpy_tree(tree: Mapping) -> Dict:
    """A copy of a nested mapping with numpy leaves."""
    return {k: _numpy_tree(v) if isinstance(v, Mapping) else np.asarray(v)
            for k, v in tree.items()}


def _get_path(tree, path: Tuple[str, ...]):
    for p in path:
        tree = tree[p]
    return tree


def import_reference_state_dict(cfg: URESNetConfig, params: Any,
                                batch_stats: Any,
                                sd: Mapping[str, np.ndarray]
                                ) -> Tuple[Dict, Dict]:
    """Copies of the (params, batch_stats) trees filled from an
    SCN-convention state dict. Raises ValueError on any count, kind or
    shape mismatch: a silent misalignment would fake parity."""
    slots = reference_slot_sequence(cfg)
    groups = classify_groups(sd, cfg.data_dim)
    if len(slots) != len(groups):
        raise ValueError(
            f"slot/group count mismatch: model expects {len(slots)} "
            f"parameterized modules {[s['kind'] for s in slots]}, "
            f"checkpoint has {len(groups)} {[g['kind'] for g in groups]}")
    new_params = _numpy_tree(params)
    new_stats = _numpy_tree(batch_stats)

    def check(tgt, arr, what):
        if tuple(tgt.shape) != tuple(arr.shape):
            raise ValueError(f"{what}: checkpoint {arr.shape} != model "
                             f"{tgt.shape}")
        return arr.astype(tgt.dtype)

    def put(path, arr, what):
        parent = _get_path(new_params, path[:-1])
        parent[path[-1]] = check(parent[path[-1]], arr, what)

    for slot, grp in zip(slots, groups):
        if slot["kind"] != grp["kind"]:
            raise ValueError(
                f"order mismatch at {grp['prefix']!r}: checkpoint has "
                f"{grp['kind']}, model expects {slot['kind']} at "
                f"{'/'.join(slot['path'])}")
        g, what = grp["arrays"], grp["prefix"]
        if slot["kind"] == "bn":
            node_p = _get_path(new_params, slot["path"])
            node_s = _get_path(new_stats, slot["path"])
            node_p["scale"] = check(node_p["scale"], g["weight"], what)
            node_p["bias"] = check(node_p["bias"], g["bias"], what)
            node_s["mean"] = check(node_s["mean"], g["running_mean"], what)
            node_s["var"] = check(node_s["var"], g["running_var"], what)
        elif slot["kind"] in ("smconv", "updown", "nin"):
            w = g["weight"]
            if slot["kind"] == "nin" and w.ndim == 2:
                w = w[None]                     # (Cin,Cout) -> (1,Cin,Cout)
            put(slot["path"], w, what)
        else:  # the Linear head: torch (out, in) -> (in, out)
            put(slot["path"], g["weight"].T, what)
            put(slot["bias_path"], g["bias"], what)
    return new_params, new_stats


def export_reference_style(cfg: URESNetConfig, params: Any, batch_stats: Any
                           ) -> Dict[str, np.ndarray]:
    """An SCN-style state dict (positional `sparseModel.N` names in
    construction order, `linear.*` for the head) from a tree."""
    sd: Dict[str, np.ndarray] = {}

    def get(tree, path):
        return np.asarray(_get_path(tree, path))

    for i, slot in enumerate(reference_slot_sequence(cfg)):
        prefix = f"sparseModel.{i}"
        if slot["kind"] == "bn":
            sd[f"{prefix}.weight"] = get(params, slot["path"] + ("scale",))
            sd[f"{prefix}.bias"] = get(params, slot["path"] + ("bias",))
            sd[f"{prefix}.running_mean"] = get(batch_stats,
                                               slot["path"] + ("mean",))
            sd[f"{prefix}.running_var"] = get(batch_stats,
                                              slot["path"] + ("var",))
            sd[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)
        elif slot["kind"] == "nin":
            sd[f"{prefix}.weight"] = get(params, slot["path"])[0]
        elif slot["kind"] in ("smconv", "updown"):
            sd[f"{prefix}.weight"] = get(params, slot["path"])
        else:
            sd["linear.weight"] = get(params, slot["path"]).T
            sd["linear.bias"] = get(params, slot["bias_path"])
    return sd
