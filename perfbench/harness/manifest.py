"""Finding a cell's parts by name.

``BENCHMARK.json`` at the checkout's root names the cells (``workloads``),
configurations and metrics; the parts live in files of their own under the
benchmark's folder, found by those names:

* a configuration: the file its entry names (``perfbench/configs/``);
* a traffic mix: ``perfbench/traffic/<traffic>.json``;
* a cell's own numbers (its fixed rate, its correctness limits):
  ``perfbench/cells/<workload>.json``;
* a metric: ``perfbench/metrics/<name>.py``, a module with
  ``read(run) -> float | None``.

A later change adds a configuration, a mix, a cell or a metric by adding
files and entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HOME = Path(__file__).resolve().parents[1]
ROOT = HOME.parent


class Manifest:
    def __init__(self, root: Path = ROOT, home: Path = HOME):
        self.root = Path(root)
        self.home = Path(home)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self._readers = {}

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        """The configuration file's content."""
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.home / "traffic" / f"{name}.json").read_text())

    def cell(self, name: str) -> dict:
        return json.loads((self.home / "cells" / f"{name}.json").read_text())

    def metrics(self, workload: str, trace: bool) -> list:
        """The entries of the metrics a run of ``workload`` reports: its
        end-to-end metrics (``--trace 0``) or its per-layer ones (``--trace
        1``). An entry without ``workloads`` holds in every cell (a
        per-layer one: in every cell that reports the metric it moves)."""
        e2e = [m for m in self.data["end_to_end"]
               if "workloads" not in m or workload in m["workloads"]]
        if not trace:
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.data["per_layer"]
                if workload in m.get("workloads", ()) or
                ("workloads" not in m and m["moves"] in moved)]

    def reader(self, name: str):
        """The ``read`` function of ``metrics/<name>.py``."""
        if name not in self._readers:
            path = self.home / "metrics" / f"{name}.py"
            mod_name = "perfbench_metric_" + name.replace(".", "_").replace("-", "_")
            spec = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._readers[name] = mod.read
        return self._readers[name]
