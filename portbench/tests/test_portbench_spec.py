"""``BENCHMARK.json`` and the files it names hold together: every cell's
configuration, mix, limits and per-layer readers are there, names and
units keep to their characters, and a full check fits its time."""

import importlib
import json
import os
import re

import pytest

from portbench import run

BENCH = run.load_json("BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits the allowance
    cells = 24
    total = (2 + 14 * cells) * (BENCH["run_seconds"] + 60) \
        + cells * 2 * 90 + 1200
    assert total <= 43200
    assert os.path.getsize(os.path.join(run.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


def test_names_and_units():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    spec = run.cell_spec(BENCH, cell)
    assert spec["limits"], "no limits for " + cell
    reported = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in reported and len(reported) >= 2
    assert spec["per_layer"]
    for m in spec["per_layer"]:
        assert m["moves"] in reported
        assert hasattr(run.reader(m["name"]), "read")
    importlib.import_module("portbench.runners." + spec["mix"]["runner"])


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    path = os.path.join(run.ROOT, config["file"])
    with open(path) as f:
        cfg = json.load(f)
    assert cfg["name"] == config["name"]
    assert cfg["reduced"] == config["reduced"] == []
    assert config["name"] in {w["config"] for w in BENCH["workloads"]}
