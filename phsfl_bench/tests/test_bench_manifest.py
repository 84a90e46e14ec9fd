"""BENCHMARK.json against the contract it is read by: names and units in
the allowed characters, every file it names present, every per-layer
metric moving an end-to-end metric that each of its cells reports."""

import json
import re

import pytest

from phsfl_bench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _names():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[key]:
            yield e["name"]
    for w in BENCH["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in BENCH["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_name_characters(name):
    assert NAME.match(name), name


def test_units_and_directions():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher"), m
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace"), m
        assert 0.01 <= m["bound"] <= 0.25, m
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in names


def test_names_unique():
    for key in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[key]]
        assert len(names) == len(set(names)), key
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_and_metrics(cell):
    c = harness.load_cell(cell, BENCH)
    kinds = harness.BENCH / "kinds" / f"{c.kind}.py"
    assert kinds.exists()
    assert (harness.BENCH / "reference"
            / f"{c.config['reference']}.py").exists()
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer, cell
    for m in c.per_layer:
        assert m["moves"] in e2e, (cell, m["name"])
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").exists()


def test_moves_names_an_end_to_end_metric_of_every_listed_cell():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        target = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert _reports(target, cell), (m["name"], cell)
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert all("\n" not in layer and layer for layer in layers)


def test_configs_are_used_and_files_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        data = json.loads((harness.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert set(c["reduced"]) == set(data["reduced"])


def test_run_seconds_fit_the_check():
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    assert 1200 + (2 + 14 * 24) * (rs + 60) + 24 * 180 <= 43200
