"""A benchmark cell, assembled from files found by name.

``BENCHMARK.json`` (at the checkout's root) names the cell, its
configuration and the metrics; everything else comes from files named
after them, so a later cell, configuration or metric is added as files
and entries alone:

- ``gxbench/workloads/<cell>.json``: the job (topology, batch, sync,
  compressor, optimizer, data, the limits of the correctness check);
- the configuration's ``file`` (``gxbench/configs/<config>.json``): the
  model's sizes, its ``family`` and the arithmetic its peak is taken in;
- ``gxbench/families/<family>.py`` and ``gxbench/reference/<family>.py``:
  how the program's model is built, and the plain reference;
- ``gxbench/counts/<config>.py``: the model's operations from shapes;
- ``gxbench/metrics/<metric>.py``: one reader a metric, end-to-end or
  per-layer.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass
from types import ModuleType
from typing import List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_file(path: str) -> ModuleType:
    """A module from a file path (names may hold dots)."""
    name = "gxbench_file_" + os.path.relpath(path, ROOT).replace(
        os.sep, "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    entry: dict
    workload: dict
    config: dict
    family: ModuleType
    reference: ModuleType
    counts: ModuleType
    end_to_end: List[dict]
    per_layer: List[dict]
    here: str

    def reader(self, metric: str) -> ModuleType:
        return load_file(os.path.join(self.here, "metrics", metric + ".py"))


def load_cell(name: str, root: str = ROOT, here: str = HERE) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``; a workload file that
    ``BENCHMARK.json`` does not name (a cell kept for later) is assembled
    from its file and ``configs/<config>.json`` alone, under the metrics
    that name no cells."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    path = os.path.join(here, "workloads", name + ".json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries and not os.path.isfile(path):
        raise SystemExit(f"gxbench: no workload {name!r} in BENCHMARK.json "
                         f"or {os.path.relpath(path, root)}")
    workload = _json(path)
    entry = entries[0] if entries else {
        k: workload[k] for k in ("name", "config", "traffic", "chips", "why")}
    for key in ("config", "traffic", "chips"):
        if workload[key] != entry[key]:
            raise ValueError(f"{name}: {key} {workload[key]!r} in its file, "
                             f"{entry[key]!r} in BENCHMARK.json")
    files = {c["name"]: c["file"] for c in bench["configs"]}
    config = _json(os.path.join(root, files[entry["config"]])
                   if entry["config"] in files else
                   os.path.join(here, "configs", entry["config"] + ".json"))
    family = config["family"]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moves = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moves)]
    return Cell(name=name, entry=entry, workload=workload, config=config,
                family=importlib.import_module(f"gxbench.families.{family}"),
                reference=importlib.import_module(
                    f"gxbench.reference.{family}"),
                counts=load_file(os.path.join(here, "counts",
                                              entry["config"] + ".py")),
                end_to_end=e2e, per_layer=per_layer, here=here)
