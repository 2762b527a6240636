"""``BENCHMARK.json`` and the files it names, found by name.

A cell is one entry of ``workloads``: its configuration is
``benchmark/configs/<config>.json``, its traffic mix
``benchmark/traffic/<traffic>.json`` and its limits
``benchmark/checks/<cell>.json``; the configuration's ``system`` names the
module ``benchmark/systems/<system>.py`` and its reference
``benchmark/reference/<system>.py``; each metric is read by
``benchmark/metrics/<metric>.py``. Adding any of them adds files and
entries and edits none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass


def load_module(path: str, name: str):
    """Import the Python file ``path`` under the module name ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list
    per_layer: list

    def system(self):
        return importlib.import_module(f"benchmark.systems.{self.config['system']}")

    def reference(self):
        return importlib.import_module(f"benchmark.reference.{self.config['system']}")


class Benchmark:
    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.spec = json.load(f)

    def _json(self, *parts) -> dict:
        with open(os.path.join(self.root, "benchmark", *parts)) as f:
            return json.load(f)

    def workloads(self):
        return [w["name"] for w in self.spec["workloads"]]

    def cell(self, name: str) -> Cell:
        w = next((w for w in self.spec["workloads"] if w["name"] == name), None)
        if w is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        cfg_entry = next(c for c in self.spec["configs"] if c["name"] == w["config"])
        with open(os.path.join(self.root, cfg_entry["file"])) as f:
            config = json.load(f)

        def applies(m):
            return name in m.get("workloads", [name])

        return Cell(
            name=name, config=config, traffic=self._json("traffic", f"{w['traffic']}.json"),
            limits=self._json("checks", f"{name}.json"), chips=w["chips"],
            end_to_end=[m for m in self.spec["end_to_end"] if applies(m)],
            per_layer=[m for m in self.spec["per_layer"] if applies(m)],
        )

    def reader(self, metric: str):
        """The reader of ``metric``: ``benchmark/metrics/<metric>.py``'s ``read``."""
        path = os.path.join(self.root, "benchmark", "metrics", f"{metric}.py")
        return load_module(path, "benchmark.metrics." + metric.replace(".", "_")).read
