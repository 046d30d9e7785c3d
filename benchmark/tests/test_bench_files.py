"""BENCHMARK.json and the files the harness finds by name in it."""
import json
import re

import pytest

from benchmark import cell, run

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("workload", CELLS)
def test_cell_files_found_by_name(workload):
    spec = run.cell_spec(BENCH, workload)
    w = spec["workload"]
    assert spec["config"]["name"] == w["config"]
    entry = cell.entry(spec["traffic"])
    assert callable(entry.run) and callable(entry.readings)
    assert callable(cell.named("scenes", spec["config"]["scene"]).build)
    assert {"width", "sqrtspp", "rays_per_chunk", "lanes", "warmup_sqrtspp",
            "streamed"} <= set(spec["traffic"])
    compared = {"image_rel_l1", "pixels_off_share"}
    if spec["config"]["integrator"] == "photon_mapper":
        compared |= {"photons_count_gap", "photons_missing_share"}
    assert set(spec["check"]["limits"]) == compared
    assert w["chips"] == 1 and len(w["why"]) <= 200
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2 and spec["per_layer"]


@pytest.mark.parametrize("metric", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_module_found_by_name(metric):
    mod = run.load_metric(metric["name"])
    assert mod.UNIT == metric["unit"] and callable(mod.read)
    if metric in BENCH["per_layer"]:
        assert (mod.LAYER, mod.MOVES) == (metric["layer"], metric["moves"])


@pytest.mark.parametrize("config", BENCH["configs"], ids=[c["name"] for c in BENCH["configs"]])
def test_config_file_states_its_cut(config):
    j = json.loads((run.ROOT / config["file"]).read_text())
    assert j["name"] == config["name"] and j["source"] == config["source"]
    assert j["reduced"] == config["reduced"] and set(j["reduced"]) <= set(j)
    assert j["triangles"] == 2 * j["grid_n"] ** 2
    assert any(config["name"] == w["config"] for w in BENCH["workloads"])


def test_names_units_and_bounds():
    for entry in METRICS + BENCH["workloads"] + BENCH["configs"]:
        assert NAME.match(entry["name"]), entry["name"]
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] == 0.25


def test_per_layer_metrics_move_a_metric_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m.get("workloads", CELLS):
            assert w in CELLS and w in moved.get("workloads", CELLS)


@pytest.mark.parametrize("kind", ["scenes", "entries"])
def test_only_module_names_are_looked_up(kind):
    with pytest.raises(ValueError):
        cell.named(kind, "../run")
