"""BENCHMARK.json and the files its cells name."""
import json
import re

import bench_helpers
import pytest
from fbench import cell as cells

BENCH = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["command"][1] == "bench/run.py"
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = ([c["name"] for c in BENCH["configs"]] + WORKLOADS
             + [m["name"] for m in metrics])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("name", WORKLOADS)
def test_cell_loads(name):
    cell = cells.load_cell(name)
    assert cell.chips == 1
    assert cell.config["runner"] == "fl_cnn"
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        # every per-layer metric moves an end-to-end metric of its cells
        assert m["moves"] in e2e
        assert callable(cells.reader(m["name"]))
    assert set(cell.limits) == {"grad_gap", "step_gap", "sgd_gap",
                                "agg_gap", "acc_gap", "life_diff"}


def test_config_files():
    for c in BENCH["configs"]:
        assert c["file"].startswith("bench/")
        cfg = json.loads((cells.ROOT / c["file"]).read_text())
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
        assert cfg["model"]["params"] == 1437226


def test_reader_of_nothing_reads_nothing():
    for m in BENCH["per_layer"]:
        assert cells.reader(m["name"])({}) is None


def test_merge():
    into = {"a": {"b": 1, "c": 2}, "d": 3}
    bench_helpers.merge(into, {"a": {"b": 5}, "e": 6})
    assert into == {"a": {"b": 5, "c": 2}, "d": 3, "e": 6}
