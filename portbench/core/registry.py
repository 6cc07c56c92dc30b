"""Find a cell's parts by the names in ``BENCHMARK.json``.

Every part a later change may add sits in a file of its own, found by name:

- ``portbench/configs/<config>.json``: the configuration as it is run; its
  ``reference`` names the plain reference beside it, a ``.py`` file in
  ``portbench/configs/``;
- ``portbench/traffic/<traffic>.json``: the mix's parameters; its ``driver``
  names the generator in ``portbench/drivers/<driver>.py`` that reads them;
- ``portbench/metrics/<metric>.py``: a per-layer metric's reader, a
  ``read(run)`` that returns a number or ``None`` when it finds nothing;
- ``portbench/limits/<cell>.json``: the limit of each number the cell's
  check compares, with the readings it was set from.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Any, Dict, List

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PORTBENCH)


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """Import the file at ``path`` as a module named ``name`` (names may hold
    dots, so the import machinery's dotted lookup is not used)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]  # this cell's end-to-end metrics
    per_layer: List[Dict[str, Any]]  # this cell's per-layer metrics
    limits: Dict[str, float]  # number compared -> its limit


def _reports(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, bench: Dict[str, Any] = None, root: str = PORTBENCH) -> Cell:
    """The cell called ``name`` with its configuration, traffic and metrics."""
    bench = bench if bench is not None else load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[name]
    config = load_json(os.path.join(root, "configs", w["config"] + ".json"))
    traffic = load_json(os.path.join(root, "traffic", w["traffic"] + ".json"))
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name) and m["moves"] in e2e_names]
    limits = {k: float(v["limit"]) for k, v in load_json(os.path.join(root, "limits", name + ".json")).items()}
    return Cell(name, int(w["chips"]), w["config"], w["traffic"], config, traffic, e2e, per_layer, limits)


def driver(cell: Cell, root: str = PORTBENCH):
    kind = cell.traffic["driver"]
    return load_module(os.path.join(root, "drivers", kind + ".py"), "portbench_driver_" + kind)


def reference(cell: Cell, root: str = PORTBENCH):
    path = os.path.join(root, "configs", cell.config["reference"])
    return load_module(path, "portbench_reference_" + cell.config_name)


def metric_reader(name: str, root: str = PORTBENCH):
    return load_module(os.path.join(root, "metrics", name + ".py"), "portbench_metric_" + name)
