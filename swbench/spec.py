"""Finding a cell's parts by name.

``BENCHMARK.json`` (beside this package, at the checkout's root) names
each cell's configuration and traffic mix; the harness reads

- ``configs/<config>.json``: the deployment (its database, its search
  settings, which driver serves it, its guarantees);
- ``traffic/<mix>.json``: the mix's parameters, for workload.make;
- ``layer_metrics/<metric>.py``: one reader per per-layer metric, a
  ``read(rec)`` that returns a number or None;
- ``drivers/<driver>.py``: how the deployment is brought up and driven
  (``batch``: back-to-back searches; ``server``: the TCP server);

so a later change adds a cell, a mix or a metric as new files and a
``BENCHMARK.json`` entry, without editing any file that is there.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _load(path: Path, name: str):
    """Import one file as module ``name``."""
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    sys.modules[name] = mod
    mod_spec.loader.exec_module(mod)
    return mod


class Spec:
    """The benchmark's files under ``base`` (the swbench directory) and
    the ``BENCHMARK.json`` beside it."""

    def __init__(self, base: Path = HERE):
        self.base = Path(base)
        with open(self.base.parent / "BENCHMARK.json") as fh:
            self.bench = json.load(fh)

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        with open(self.base / "configs" / f"{name}.json") as fh:
            return json.load(fh)

    def traffic(self, name: str) -> dict:
        with open(self.base / "traffic" / f"{name}.json") as fh:
            return json.load(fh)

    def reader(self, metric: str):
        return _load(self.base / "layer_metrics" / f"{metric}.py",
                     f"swbench_metric_{metric.replace('.', '_')}").read

    def driver(self, name: str):
        if self.base == HERE:
            return importlib.import_module(f"swbench.drivers.{name}")
        return _load(self.base / "drivers" / f"{name}.py",
                     f"swbench_driver_{name}")

    def metrics_of(self, cell: str, traced: bool) -> list:
        """The metric entries a run of ``cell`` reports: its end-to-end
        ones (trace 0) or its per-layer ones (trace 1). An entry with a
        ``workloads`` key applies to those cells; a per-layer one without
        it applies where its ``moves`` metric does."""
        e2e = [m for m in self.bench["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if not traced:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in names)]
