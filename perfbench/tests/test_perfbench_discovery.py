"""A configuration, a mix, a cell and a metric added as new files (and
entries) in a copy of the benchmark are found by name and run; nothing of
the harness names them."""

import json

import pytest

import tiny
from harness.manifest import Manifest
from harness.runner import run_cell


@pytest.fixture()
def root(tmp_path):
    return tiny.make_root(tmp_path, tiny.real_manifest())


def add_cell(root, name, config, traffic, metric_src):
    home = root / "perfbench"
    model = dict(tiny.CONFIGS["tiny.w4sym"], hidden_size=512)
    (home / "configs" / f"{config}.json").write_text(json.dumps(model))
    mix = dict(tiny.MIXES["chat"], arrivals={"process": "gamma", "cv": 2.0})
    (home / "traffic" / f"{traffic}.json").write_text(json.dumps(mix))
    (home / "cells" / f"{name}.json").write_text(
        json.dumps({"rate_per_s": 5.0, "limits": {"max_logit_gap": tiny.TINY_LIMIT}}))
    (home / "metrics" / "requests_seen.py").write_text(metric_src)
    data = json.loads((root / "BENCHMARK.json").read_text())
    data["configs"].append({"name": config, "source": "toy", "why": "toy", "reduced": [],
                            "file": f"perfbench/configs/{config}.json"})
    data["workloads"].append({"name": name, "config": config, "traffic": traffic,
                              "chips": 1, "why": "toy"})
    data["end_to_end"][0]["workloads"].append(name)
    data["per_layer"].append({"name": "requests_seen", "unit": "count", "better": "higher",
                              "source": "program_counter", "layer": "engine",
                              "moves": data["end_to_end"][0]["name"], "workloads": [name]})
    (root / "BENCHMARK.json").write_text(json.dumps(data))


def test_new_files_are_found_by_name(root):
    add_cell(root, "tiny-wide.bursty", "tiny.wide", "bursty",
             "def read(run):\n    return len(run.records)\n")
    m = Manifest(root, root / "perfbench")
    assert m.config("tiny.wide")["hidden_size"] == 512
    assert m.traffic("bursty")["arrivals"]["process"] == "gamma"
    assert m.cell("tiny-wide.bursty")["rate_per_s"] == 5.0
    names = {e["name"] for e in m.metrics("tiny-wide.bursty", trace=True)}
    assert names == {"requests_seen"}
    assert "requests_seen" not in {e["name"] for e in m.metrics("tiny-w4sym.chat", True)}


def test_a_new_cell_runs(root):
    add_cell(root, "tiny-wide.bursty", "tiny.wide", "bursty",
             "def read(run):\n    return len(run.records)\n")
    m = Manifest(root, root / "perfbench")
    result, checks = run_cell(m, "tiny-wide.bursty", 2**31 + 9, 4.0, True, device="cpu",
                              t_start=0.0, log=lambda s: None)
    assert result["metrics"]["requests_seen"]["value"] > 0
    assert result["correct"], checks


def test_a_reader_that_finds_nothing_leaves_its_metric_out(root):
    add_cell(root, "tiny-wide.bursty", "tiny.wide", "bursty",
             "def read(run):\n    return None\n")
    m = Manifest(root, root / "perfbench")
    result, _ = run_cell(m, "tiny-wide.bursty", 5, 0.5, True, device="cpu", t_start=0.0,
                         log=lambda s: None)
    assert "requests_seen" not in result["metrics"]
