"""What a run is: the cell, its configuration, its traffic and its limits,
found by the names in ``BENCHMARK.json``; and the loader of the per-name
modules (a metric's reader, a model's reference and counts).

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own under ``portbench/``:

- ``BENCHMARK.json``'s ``configs[].file`` (``portbench/configs/<name>.json``);
- ``portbench/traffic/<traffic>.json``: the cell's batch, data sizes and
  the model's input geometry;
- ``portbench/limits/<cell>.json``: the limit of each number that decides
  ``correct``;
- ``portbench/metrics/<metric>.py``: one reader, ``read(ctx)``;
- ``portbench/reference/<model>.py`` and ``portbench/counts/<model>.py``.

So a later cell, configuration or metric is added as files and entries,
and no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Cell:
    """One entry of ``workloads`` with what it names, loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict] = field(default_factory=list)

    @property
    def model(self) -> str:
        return self.config["model"]


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def bench_spec(root: str = ROOT) -> dict:
    return _read_json(os.path.join(root, "BENCHMARK.json"))


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` under ``root``; raises
    ``KeyError`` for a name it does not hold."""
    spec = bench_spec(root)
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"({', '.join(sorted(work))})")
    w = work[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _read_json(os.path.join(root, configs[w["config"]]["file"]))
    bench = os.path.join(root, os.path.basename(BENCH_DIR))
    traffic = _read_json(os.path.join(bench, "traffic",
                                      f"{w['traffic']}.json"))
    limits = _read_json(os.path.join(bench, "limits", f"{name}.json"))
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits,
                end_to_end=[m for m in spec["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in spec["per_layer"]
                           if _reports(m, name)])


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (a metric's name holds
    dots, so it is loaded by its path, not imported by name)."""
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{path}: no {kind} module {name!r}")
    mod_name = f"portbench_{kind}_{name}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def peaks() -> dict:
    """The frozen table of the card's published peaks."""
    return _read_json(os.path.join(BENCH_DIR, "counts", "peaks.json"))
