"""BENCHMARK.json against its contract, and every file the harness finds
by a name in it."""

import importlib
import json
import re

import pytest

from conftest import PARKED, ROOT, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
M = manifest()


def chips_allowed(workloads: list) -> bool:
    """Each cell on 1 or 4 chips, and at most a quarter of the cells,
    rounded down, on 4; one always may."""
    chips = [w["chips"] for w in workloads]
    return set(chips) <= {1, 4} and \
        chips.count(4) <= max(1, len(chips) // 4)


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["command"] == ["python3", "benchmark/run.py"]
    assert M["paths"] == ["benchmark"]
    assert 1 <= M["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entries():
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in M[group]:
            assert NAME.match(e["name"]), e["name"]
            names.add((group, e["name"]))
    assert len(names) == sum(len(M[g]) for g in
                             ("configs", "workloads", "end_to_end",
                              "per_layer"))
    for e in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert e["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for e in M["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    assert "setup_s" in {e["name"] for e in M["end_to_end"]}
    e2e = {e["name"] for e in M["end_to_end"]}
    for e in M["per_layer"]:
        assert e["moves"] in e2e and "\n" not in e["layer"]


def test_every_cell_reports_what_the_contract_asks():
    cells = {w["name"] for w in M["workloads"]}
    for w in M["workloads"]:
        assert len(w["why"]) <= 200
        e2e = [e for e in M["end_to_end"] if e["name"] != "setup_s"
               and w["name"] in e.get("workloads", cells)]
        assert e2e, w["name"]
        layers = [m for m in M["per_layer"]
                  if w["name"] in m.get("workloads", cells)]
        assert layers, w["name"]
        for m in layers:
            moved = {e["name"] for e in e2e}
            assert m["moves"] in moved, (w["name"], m["name"])
    assert len({(w["config"], w["traffic"]) for w in M["workloads"]}) == \
        len(M["workloads"])
    assert chips_allowed(M["workloads"])


@pytest.mark.parametrize("chips,ok", [
    ([1, 1, 1], True),
    ([4, 1, 1], True),                  # one four-chip cell always may
    ([2, 1, 1], False),
    ([1, 1, 8], False),
    ([4, 4] + [1] * 6, True),           # 8 cells: 8 // 4 = 2
    ([4, 4, 4] + [1] * 5, False),
] + [([4, 4] + [1] * (n - 2), False) for n in range(3, 8)])
def test_chips_rule(chips, ok):
    assert chips_allowed([{"chips": c} for c in chips]) is ok


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_cell_files_found_by_name(cell):
    from benchmark import run
    _, entry, cfg, traffic = run.load_cell(cell)
    importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    assert (ROOT / "benchmark" / "limits" / f"{cell}.json").exists()
    assert cfg["name"] == entry["config"]
    conf = {c["name"]: c for c in M["configs"]}[entry["config"]]
    assert conf["file"].startswith("benchmark/")
    assert set(conf["reduced"]) <= set(cfg["reduced"])


@pytest.mark.parametrize("metric", [m["name"] for m in M["per_layer"]] + [
    n for _, _, names in PARKED.values() for n in names])
def test_metric_reader_found_by_name(metric):
    from benchmark import run
    assert callable(run.metric_reader(metric))


def test_configs_used_and_files_distinct():
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}
    files = [c["file"] for c in M["configs"]]
    assert len(set(files)) == len(files)
    for c in M["configs"]:
        json.loads((ROOT / c["file"]).read_text())


def test_check_time_fits():
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (M["run_seconds"] + 60) + cells * 180 + 1200 <= 43200
