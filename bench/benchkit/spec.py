"""The benchmark's data, found by name: `BENCHMARK.json` at the root of the
checkout, and under the benchmark's folder a file for each configuration
(`configs/<config>.json`, named by the configuration's `file`), each model
family (`families/<family>.py`, named by the configuration's `family`) and
its plain reference (`reference/<reference>.py`, named by its `reference`),
each traffic mix (`traffic/<traffic>.json`) and the driver of its `kind`
(`benchkit/<kind>.py`, a function `run(ctx)`), each cell's limits
(`cells/<cell>.json`) and each metric's reader (`metrics/<metric>.py`, a
function `read(record)`). Adding a cell, a configuration of another family,
a kind of traffic or a metric adds files and entries; no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class Spec:
    def __init__(self, root: Path = ROOT, bench_dir: Path = BENCH_DIR):
        self.root, self.dir = Path(root), Path(bench_dir)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{[w['name'] for w in self.data['workloads']]}")

    def config(self, name: str) -> dict:
        entry = next(c for c in self.data["configs"] if c["name"] == name)
        cfg = json.loads((self.root / entry["file"]).read_text())
        return {**cfg, "name": name}

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> dict:
        return json.loads((self.dir / "cells" / f"{cell}.json").read_text())

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The cell's end-to-end metrics (`trace` False) or per-layer ones (True):
        each entry whose `workloads` lists the cell, or that has no such list."""
        group = self.data["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        return _load(self.dir / "metrics" / f"{metric}.py", f"bench_metric_{metric}").read

    def family(self, name: str):
        """The family module a configuration names (`families/<name>.py`)."""
        return _load(self.dir / "families" / f"{name}.py", f"bench_family_{name}")

    def driver(self, kind: str):
        """The driver of a kind of traffic (`benchkit/<kind>.py`)."""
        return importlib.import_module(f"benchkit.{kind}")

    def reference(self, name: str):
        """The plain reference module a configuration names (`reference/<name>.py`)."""
        return _load(self.dir / "reference" / f"{name}.py", f"bench_reference_{name}")


def _load(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
