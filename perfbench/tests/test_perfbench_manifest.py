"""BENCHMARK.json against the benchmark's contract, and every name in it
found as a file."""

import json
import re

import pytest

import tiny
from harness.manifest import Manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
DATA = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_command():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert DATA["command"] == ["python3", "perfbench/run.py"]
    assert DATA["paths"] == ["perfbench"]
    assert 1 <= DATA["run_seconds"] <= 51 and isinstance(DATA["run_seconds"], int)
    assert len((tiny.ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


def test_configs():
    m = Manifest()
    for c in DATA["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["why"]) and one_line(c["source"])
        assert c["file"].startswith("perfbench/") and c["reduced"] == []
        model = m.config(c["name"])
        assert model["name"] == c["name"] and model["source"] == c["source"]
        assert model["reduced"] == []


def test_workloads():
    m = Manifest()
    names = {c["name"] for c in DATA["configs"]}
    pairs = set()
    for w in DATA["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and one_line(w["why"])
        assert w["config"] in names and w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        mix = m.traffic(w["traffic"])
        cell = m.cell(w["name"])
        assert "max_logit_gap" in cell["limits"]
        assert (mix["kind"] == "open_loop") == ("rate_per_s" in cell)
    assert {w["config"] for w in DATA["workloads"]} == names


def test_metrics():
    m = Manifest()
    seen = set()
    cells = {w["name"] for w in DATA["workloads"]}
    for e in DATA["end_to_end"]:
        assert set(e) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    assert "setup_s" in {e["name"] for e in DATA["end_to_end"]}
    for e in DATA["end_to_end"] + DATA["per_layer"]:
        assert NAME.match(e["name"]) and UNIT.match(e["unit"]) and e["name"] not in seen
        assert e["better"] in ("lower", "higher")
        assert set(e.get("workloads", cells)) <= cells
        seen.add(e["name"])
        assert callable(m.reader(e["name"]))
    for p in DATA["per_layer"]:
        assert set(p) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert one_line(p["layer"])
        moves = next(e for e in DATA["end_to_end"] if e["name"] == p["moves"])
        assert set(p["workloads"]) <= set(moves.get("workloads", cells))
    for w in cells:
        e2e = m.metrics(w, trace=False)
        assert "setup_s" in {e["name"] for e in e2e} and len(e2e) >= 2
        assert m.metrics(w, trace=True)


def test_mfu_and_roofline_beside_each_other():
    by_moves = {}
    for p in DATA["per_layer"]:
        by_moves.setdefault(p["moves"], set()).add(p["name"])
    for names in by_moves.values():
        if any(n.split(".")[0].endswith("_roofline") for n in names):
            assert any("mfu" in n for n in names)


@pytest.mark.parametrize("path", sorted(tiny.HOME.rglob("*")), ids=str)
def test_file_names(path):
    rel = path.relative_to(tiny.ROOT).as_posix()
    if "__pycache__" in rel or ".cache" in rel:
        return
    assert re.match(r"^[A-Za-z0-9_./-]+$", rel)
