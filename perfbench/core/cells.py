"""A cell of `BENCHMARK.json`, resolved from its name: its configuration,
its traffic mix, the limits of its comparison, and the metrics it
reports. Each of these sits in a file of its own, found by name:

    perfbench/configs/<file named by the configuration's entry>
    perfbench/traffic/<traffic>.json
    perfbench/limits/<workload>.json
    perfbench/metrics/<per-layer metric>.py
    the plain reference: the file the configuration's `reference` key
        names, or else the module of its model's name (`reference/`)

Every path is taken from the root of the checkout the cell is loaded
from, so a cell of files under another root runs from there.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"


def manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_module(path: Path, prefix: str):
    """The Python file at `path` as a module, named from `prefix` and the
    file's stem."""
    spec = importlib.util.spec_from_file_location(
        prefix + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    model: dict                 # the program's configuration fields
    config: dict                # the whole configuration file
    traffic_name: str
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]      # the end-to-end metrics this cell reports
    per_layer: List[dict]       # the per-layer metrics this cell reports
    root: Path = ROOT           # the checkout its files are found in

    @property
    def mode(self) -> str:
        return self.traffic["mode"]

    @property
    def reference(self):
        """The configuration's plain reference module (loaded anew)."""
        from perfbench import reference
        return reference.module_of(self.config, self.root)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT,
              model_overrides: Optional[dict] = None,
              traffic_overrides: Optional[dict] = None) -> Cell:
    """The cell `name` of the manifest. Overrides replace fields of the
    configuration's model or of the traffic (the CPU tests run a cell at
    a size a test can hold)."""
    man = manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    w = cells[name]
    confs = {c["name"]: c for c in man["configs"]}
    conf_file = _load_json(root / confs[w["config"]]["file"])
    model = dict(conf_file["model"], **(model_overrides or {}))
    traffic = dict(_load_json(root / "perfbench" / "traffic"
                              / f"{w['traffic']}.json"),
                   **(traffic_overrides or {}))
    limits_path = root / "perfbench" / "limits" / f"{name}.json"
    # {number: {"limit": x, "lower": reading, "upper": reading}}
    limits = ({k: float(v["limit"]) for k, v in
               _load_json(limits_path).items()}
              if limits_path.exists() else {})
    e2e = [m for m in man["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return Cell(name, int(w["chips"]), model, conf_file,
                w["traffic"], traffic, limits, e2e, per_layer, Path(root))
