"""BENCHMARK.json against the contract's shape and characters, and every
unit of it found as a file by name; a cell added by files and an entry
alone runs."""

from __future__ import annotations

import json
import re

import pytest

from benchmark import harness
from benchmark.tests._tiny import REPO, tiny_root

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(SPEC["command"]) <= 32
    assert all(TEXT.match(w) for w in SPEC["command"])
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", SPEC["configs"] + SPEC["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_and_texts(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert TEXT.match(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in entry.get("reduced", []):
        assert NAME.match(key)


def test_names_are_unique():
    for group in (SPEC["configs"], SPEC["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


def test_entries_have_the_contract_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    layers = {}
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in e2e
        layers.setdefault(m["layer"], m["layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_unit_is_a_file_found_by_name(cell):
    c = harness.find_cell(SPEC, cell, REPO)
    assert harness.method(c.cfg, REPO)
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.reader(m["name"], REPO))
    assert {"setup_s"} < {m["name"] for m in c.end_to_end}
    assert c.per_layer


def test_config_files_state_their_source():
    for c in SPEC["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert c["file"].startswith("benchmark/")


def test_a_cell_added_by_files_and_an_entry_runs(tmp_path):
    """A new traffic mix and a new BENCHMARK.json entry (and its limits
    file) make a runnable cell; no existing file of the copy changes."""
    root = tiny_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    mix = json.loads((root / "benchmark/traffic/pertile-256-b256.json")
                     .read_text())
    mix.update(centers=[1, 2], background=[0.1, 0.3])
    (root / "benchmark/traffic/pertile-two-centres.json").write_text(
        json.dumps(mix))
    (root / "benchmark/limits/macenko-two-centres.json").write_text(
        (root / "benchmark/limits/macenko-pertile-256.json").read_text())
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append(dict(name="macenko-two-centres",
                                  config="macenko-fs2",
                                  traffic="pertile-two-centres", chips=1,
                                  why="two centres"))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    r = harness.run_cell("macenko-two-centres", 5, 1.5, False, "cpu",
                         root=root)
    assert r["correct"]
    assert set(r["metrics"]) == {"tiles_per_s", "batch_ms_p95", "setup_s"}
    assert all((p.read_bytes() == b) for p, b in before.items())
