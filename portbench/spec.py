"""The benchmark's parts, found by name.

``BENCHMARK.json`` at the root names the cells, configurations and metrics.
Each part lives in a file of its own under the benchmark's folder, so a
later change adds a part by adding a file and an entry:

- a configuration: the JSON file its entry names (``file``);
- a traffic mix: ``traffic/<mix>.json``, parameters for ``generator.py``;
- an entry of the program that mixes drive: ``entries/<entry>.py``, with
  the reference's base quantities, a call's inputs, the program's build
  and solve, the reference's solve and the sizes the roofline counts take;
- the limits of the comparison that decides ``correct``:
  ``limits/<cell>.json``;
- a metric: ``metrics/<metric>.py``, whose ``read(run)`` returns the value
  or None where the run holds nothing for it to read.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = "portbench"


class Spec:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench = self.root / BENCH
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())

    def _entry(self, kind: str, name: str) -> dict:
        for item in self.doc[kind]:
            if item["name"] == name:
                return item
        raise KeyError(f"BENCHMARK.json has no {kind} entry {name!r}")

    def workload(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> dict:
        entry = self._entry("configs", name)
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench / "traffic" / f"{name}.json")
                          .read_text())

    def limits(self, workload: str) -> dict:
        return json.loads((self.bench / "limits" / f"{workload}.json")
                          .read_text())

    def metrics(self, workload: str, trace: bool) -> list:
        """The metric entries a run of ``workload`` reports: the end-to-end
        ones without a trace, the per-layer ones with it. An entry without
        ``workloads`` holds for every cell that reports the metric it
        moves."""
        e2e = [m for m in self.doc["end_to_end"]
               if workload in m.get("workloads", [workload])]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.doc["per_layer"]
                if workload in m.get("workloads", [workload])
                and m["moves"] in names]

    def _module(self, folder: str, name: str):
        path = self.bench / folder / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"{BENCH}_{folder}_{name.replace('.', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    def reader(self, metric: str):
        """The module ``metrics/<metric>.py``."""
        return self._module("metrics", metric)

    def entry(self, name: str):
        """The module ``entries/<name>.py``."""
        return self._module("entries", name)

    def path(self, relative: str) -> Path:
        return self.root / relative
