"""The benchmark's files found by name, and BENCHMARK.json held to the
rules its readers rely on."""
import json
import re

import pytest

from port_bench import harness
from port_bench.arch import Arch

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = harness.load_cell(cell)
    a = Arch.load(c["config"])
    assert harness.load_driver(c["driver"]).run
    assert set(c["limits"])
    assert a.layers and a.active_param_count() < a.param_count()


def test_configs_are_files_under_paths_and_used():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith("port_bench/configs/")
        raw = json.loads(open(harness.REPO / c["file"]).read())
        assert raw["name"] == c["name"] and raw["reduced"] == c["reduced"]
        assert c["name"] in used
        assert not any(k.endswith(("_dim", "_rank", "d_ff", "d_model"))
                       for k in c["reduced"])


def test_names_units_and_lines():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for entry in BENCH["configs"] + BENCH["workloads"] + BENCH["per_layer"]:
        for k in ("why", "layer", "source"):
            if k in entry:
                assert 1 <= len(entry[k]) <= 200 and "\n" not in entry[k]


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_has_a_reader_and_its_cells_report_what_it_moves(m):
    assert harness.load_metric(m["name"]).read
    moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
    for cell in m["workloads"]:
        assert cell in moved.get("workloads", CELLS)
    layers = {x["layer"] for x in BENCH["per_layer"]}
    assert m["layer"] in layers


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e = {m["name"] for m in harness.metrics_of(cell, False, BENCH)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metrics_of(cell, True, BENCH)
    bounds = {m["name"]: m["bound"] for m in BENCH["end_to_end"]}
    assert bounds["setup_s"] <= 0.25
    assert all(0.01 <= b <= 0.25 for b in bounds.values())


def test_missing_files_raise():
    with pytest.raises(KeyError):
        harness.load_cell("no-such-cell")
    with pytest.raises(FileNotFoundError):
        harness.load_metric("no_such_metric")
    with pytest.raises(FileNotFoundError):
        harness.load_driver("no_such_driver")


def test_check_budget_fits_with_24_cells():
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
