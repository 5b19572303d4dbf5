"""BENCHMARK.json against the rules its readers check, and every
configuration, traffic mix, limit and per-layer metric found by name."""

import json
import re

import pytest

from perfbench.core.cells import BENCH, ROOT, load_cell, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
MAN = manifest()
WORKLOADS = [w["name"] for w in MAN["workloads"]]


def test_keys_and_sizes():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= MAN["run_seconds"] <= 51
    assert MAN["paths"] == ["perfbench"]
    assert all(LINE.match(w) for w in MAN["command"])
    assert (ROOT / MAN["command"][1]).is_file()


def test_cells_over_four_cards():
    """A cell takes 1 card or 4; at most a quarter of the cells, rounded
    down, take 4, or one where that is fewer."""
    chips = [w["chips"] for w in MAN["workloads"]]
    assert set(chips) <= {1, 4}
    assert chips.count(4) <= max(1, len(chips) // 4)


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_units_and_lines(section):
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    for e in MAN[section]:
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert LINE.match(e[k]), (e["name"], k)
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in e.get("reduced", []):
            assert NAME.match(k)


def test_end_to_end_bounds_and_sources():
    names = {m["name"] for m in MAN["end_to_end"]}
    assert "setup_s" in names
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_resolves(workload):
    cell = load_cell(workload)
    assert cell.chips in (1, 4)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert m["moves"] in names
    assert cell.limits, f"perfbench/limits/{workload}.json"


@pytest.mark.parametrize("metric", [m["name"] for m in MAN["per_layer"]])
def test_reader_found_by_name(metric):
    from perfbench.core.harness import load_reader
    assert callable(load_reader(metric))


def test_every_config_file_is_used_and_own():
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    for c in MAN["configs"]:
        with open(ROOT / c["file"]) as f:
            assert "model" in json.load(f)
    assert all((BENCH / "traffic" / f"{w['traffic']}.json").is_file()
               for w in MAN["workloads"])
