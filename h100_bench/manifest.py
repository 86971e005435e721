"""The benchmark's files, found by the names in ``BENCHMARK.json``.

- ``configs/<config>.json``: the model configuration as it is run (the
  port's config sections ``audio``, ``model``, ``training``, ``inference``,
  with ``model_type``), its source, ``reduced``, ``assumed`` and ``why``;
- ``traffic/<traffic>.json``: a mix for the one generator, ``traffic.py``;
- ``workloads/<cell>.json``: the limits of the numbers that decide the
  cell's ``correct``;
- ``metrics/<metric>.py``: one reader per metric, ``read(run)``, returning
  the number or None where it finds nothing to read;
- ``models/<model_type>.py``: the yardstick of a model type (checkpoint
  layout, FLOP and byte counts, the reference forward);
- ``kernels/<family>.json``: kernel names of one family of the program's
  hand-written kernels, and its launch counter.

A cell, a configuration, a mix or a metric is added by adding files.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """Everything the harness reads for one cell."""

    def __init__(self, name: str, root: str = ROOT):
        self.bench = _json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
        self.name = name
        self.workload = cells[name]
        self.chips = int(self.workload["chips"])
        cfg_entry = next(c for c in self.bench["configs"] if c["name"] == self.workload["config"])
        self.config_file = _json(os.path.join(root, cfg_entry["file"]))
        self.traffic = _json(os.path.join(HERE, "traffic", self.workload["traffic"] + ".json"))
        self.limits = _json(os.path.join(HERE, "workloads", name + ".json"))["limits"]
        self.model_type = self.config_file["model_type"]
        self.model_mod = importlib.import_module(f"h100_bench.models.{self.model_type}")

    @property
    def config(self) -> dict:
        """The port's config sections."""
        return {k: self.config_file[k] for k in ("audio", "model", "training", "inference")
                if k in self.config_file}

    def metrics(self, trace: bool) -> list:
        """[(metric entry, reader)] this cell reports in a run of this kind."""
        out = []
        for m in self.bench["per_layer" if trace else "end_to_end"]:
            if "workloads" in m and self.name not in m["workloads"]:
                continue
            path = os.path.join(HERE, "metrics", m["name"] + ".py")
            spec = importlib.util.spec_from_file_location("h100_bench_metric", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            out.append((m, mod.read))
        return out
