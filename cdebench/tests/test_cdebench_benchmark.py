"""BENCHMARK.json against the files of the harness, and the contract's shape."""

import json
import re

import pytest

from cdebench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture
def bench(root):
    return json.loads((root / "BENCHMARK.json").read_text())


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["cdebench"]
    assert bench["command"] == ["python3", "cdebench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)


def test_every_workload_names_files_that_exist(root, bench):
    configs = {c["name"]: c for c in bench["configs"]}
    for cell in bench["workloads"]:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert cell["config"] in configs
        assert cell["chips"] == 1
        traffic = json.loads((root / "cdebench" / "traffic" / f"{cell['traffic']}.json").read_text())
        assert (root / "cdebench" / "modes" / f"{traffic['mode']}.py").exists()
        limits = json.loads((root / "cdebench" / "workloads" / f"{cell['name']}.json").read_text())
        assert limits["limits"] and all(v is not None for v in limits["limits"].values())
    used = {cell["config"] for cell in bench["workloads"]}
    for config in bench["configs"]:
        assert config["name"] in used
        assert config["file"].startswith("cdebench/configs/")
        data = json.loads((root / config["file"]).read_text())
        assert data["name"] == config["name"] and data["reduced"] == config["reduced"] == []
        solver = data["model"]["solver"]
        assert (root / "cdebench" / "work" / f"{solver}.py").exists()
        assert (root / "cdebench" / "reference" / f"{solver}.py").exists()


def test_every_metric_has_a_reader_and_its_cells(root, bench):
    cells = {cell["name"] for cell in bench["workloads"]}
    end_to_end = {m["name"]: m for m in bench["end_to_end"]}
    assert end_to_end["setup_s"]["bound"] == 0.25 and "workloads" not in end_to_end["setup_s"]
    for metric in bench["end_to_end"]:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    for metric in bench["per_layer"]:
        name = harness.base_name(metric["name"],
                                 lambda n: (root / "cdebench" / "metrics" / f"{n}.py").exists())
        assert (root / "cdebench" / "metrics" / f"{name}.py").exists()
        assert metric["workloads"] and set(metric["workloads"]) <= cells
        moves = end_to_end[metric["moves"]]
        assert set(metric["workloads"]) <= set(moves.get("workloads", cells))
    for cell in cells:  # each cell reports setup_s, another end-to-end and a per-layer metric
        assert any(cell in m.get("workloads", cells) for m in bench["end_to_end"]
                   if m["name"] != "setup_s")
        assert any(cell in m["workloads"] for m in bench["per_layer"])


def test_names_and_units(bench):
    entries = bench["configs"] + bench["workloads"] + bench["end_to_end"] + bench["per_layer"]
    for entry in entries:
        assert NAME.match(entry["name"]), entry["name"]
    for metric in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
        if "roofline" in metric["name"] or "mfu" in metric["name"]:
            assert metric["unit"] == "%"
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for entry in bench["configs"] + bench["workloads"]:
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
