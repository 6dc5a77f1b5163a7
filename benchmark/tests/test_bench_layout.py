"""BENCHMARK.json keeps to its contract, and every cell finds its files by
name."""

from __future__ import annotations

import json
import os
import re

import pytest

from benchmark import harness

BENCH = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])
    cmd = BENCH["command"]
    assert len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= BENCH["run_seconds"] <= 51
    n = 24
    runs = 2 + 14 * n
    assert runs * (BENCH["run_seconds"] + 60) + n * 2 * 90 + 1200 <= 43200
    assert 1 <= len(BENCH["configs"]) <= 24
    assert 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_entries_have_exactly_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_pairs_are_unique_and_configs_used():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(BENCH["workloads"]) // 4)


def test_setup_and_a_second_metric_and_a_layer_in_every_cell():
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in BENCH["end_to_end"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for cell in CELLS:
        spec = harness.cell_spec(cell, BENCH)
        names = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert spec["per_layer"]
        for m in spec["per_layer"]:
            assert m["moves"] in e2e and m["moves"] in names


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_its_files_by_name(cell):
    spec = harness.cell_spec(cell, BENCH)
    unit = harness.load_module("units", spec["unit"])
    for fn in ("setup", "run", "release", "check"):
        assert callable(getattr(unit, fn))
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)
    assert spec["limits"] and all(v > 0 for v in spec["limits"].values())


def test_config_files_lie_under_paths_and_name_their_cuts():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        data = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"]
        for k in c["reduced"]:
            assert k in data and k in data["assumed"]
            assert not k.lower().endswith(("_dim", "_rank", "dim", "size"))
