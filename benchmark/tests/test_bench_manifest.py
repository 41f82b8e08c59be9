"""BENCHMARK.json meets the contract's rules that can be read from it."""

import copy
import json
import os

import pytest

from benchmark.harness import manifest
from benchmark.tests.helpers import ROOT


@pytest.fixture
def real():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_the_manifest_is_valid(real):
    size = os.path.getsize(os.path.join(ROOT, "BENCHMARK.json"))
    assert manifest.validate(real, ROOT, size) == []


def test_every_cell_finds_its_files(real):
    for w in real["workloads"]:
        cfg = manifest.config(real, w["config"], ROOT)
        assert cfg["name"] == w["config"] and cfg["chips"] == w["chips"] == 1
        assert manifest.traffic(w["traffic"])["op"] in ("count", "locate")
        for p in manifest.metrics_of(real, w["name"], "per_layer"):
            assert callable(manifest.load_reader(p["name"]))


def test_every_layer_metric_moves_a_metric_its_cells_report(real):
    for p in real["per_layer"]:
        for cell in p["workloads"]:
            assert manifest.reports(real, cell, p["moves"]), (p["name"], cell)


def test_config_files_state_the_configs_entry(real):
    for c in real["configs"]:
        cfg = manifest.config(real, c["name"], ROOT)
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert cfg["guarantee"] and "assumed" in cfg


@pytest.mark.parametrize("mutate, fault", [
    (lambda m: m["workloads"][0].update(name="bad name"), "bad name"),
    (lambda m: m["workloads"][0].update(name="x" * 65), "bad name"),
    (lambda m: m["end_to_end"][0].update(unit="queries per second"), "bad unit"),
    (lambda m: m["end_to_end"][0].update(unit="q" * 17), "bad unit"),
    (lambda m: m["per_layer"][0].update(moves="nothing"), "moves no end-to-end metric"),
    (lambda m: m["per_layer"][1].update(workloads=["nt-chr1.locate25"]), "does not report"),
    (lambda m: m["end_to_end"][0].update(bound=0.3), "bound"),
    (lambda m: m["end_to_end"].pop(), "setup_s"),
    (lambda m: m["workloads"][1].update(config="nt-chr1-k12-r8", traffic="locate25"), "used twice"),
    (lambda m: m["per_layer"][0].update(why="x"), "keys must be"),
    (lambda m: m["workloads"][0].update(traffic="nowhere"), "traffic file missing"),
    (lambda m: m["per_layer"][0].update(name="no_reader.locate"), "no reader"),
    (lambda m: m["configs"][0].update(why="two\nlines"), "one line"),
    (lambda m: m.update(run_seconds=52), "run_seconds"),
])
def test_validation_finds_each_fault(real, mutate, fault):
    m = copy.deepcopy(real)
    mutate(m)
    errors = manifest.validate(m, ROOT)
    assert any(fault in e for e in errors), errors
