"""Where the benchmark finds what a cell names: everything by name, from
``BENCHMARK.json`` at the checkout's root and files of their own under
``regbench/``, so that a new configuration, traffic mix, entry, metric or
cell is a new file and a new entry, with no edit to a file that is there.

- a configuration: the ``file`` that its entry in ``BENCHMARK.json`` names;
- a traffic mix: ``regbench/traffic/<traffic>.json``, whose ``entry`` names
- the entry that drives the program: ``regbench/entries/<entry>.py``;
- the limits of a cell's correctness check: ``regbench/limits/<cell>.json``;
- a per-layer metric's reader: ``regbench/metrics/<metric>.py``, whose
  ``read(record)`` returns the number or None.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]


class Layout:
    def __init__(self, root: Path | str | None = None):
        self.root = Path(root) if root is not None else PKG.parent
        self.pkg = self.root / PKG.name
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.pkg / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> dict:
        return json.loads((self.pkg / "limits" / f"{cell}.json").read_text())

    def _module(self, kind: str, name: str):
        path = self.pkg / kind / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"regbench_{kind}_{name}", path)
        if spec is None or not path.is_file():
            raise KeyError(f"no {kind[:-1]} file {path}")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def entry(self, name: str):
        return self._module("entries", name)

    def reader(self, metric: str):
        return self._module("metrics", metric).read

    def end_to_end(self, cell: str) -> list[dict]:
        return [m for m in self.bench["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list[dict]:
        """The per-layer metrics a cell reports: those that list it, and those
        without a list whose end-to-end metric the cell reports."""
        reported = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.bench["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in reported)]
