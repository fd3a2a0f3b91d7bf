"""Resolves a cell of BENCHMARK.json to its files: the configuration,
the traffic mix, the comparison limits and the metric readers, each found
by name."""

from __future__ import annotations

import importlib
import json
import os
from typing import Dict

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def _load(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, manifest_path: str = None) -> Dict:
    """{'cell', 'config', 'traffic', 'limits', 'end_to_end', 'per_layer'}:
    the cell's entry, its configuration and traffic files, its limits, and
    the metrics of the manifest that this cell reports."""
    manifest = _load(manifest_path or os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no cell {workload!r} in BENCHMARK.json; cells: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = _load(os.path.join(ROOT, configs[cell["config"]]["file"]))

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return {
        "cell": cell,
        "config": config,
        "traffic": _load(os.path.join(BENCH, "traffic", cell["traffic"] + ".json")),
        "limits": _load(os.path.join(BENCH, "limits", workload + ".json")),
        "end_to_end": mine(manifest["end_to_end"]),
        "per_layer": mine(manifest["per_layer"]),
    }


def reader(metric: str):
    """The `read(run)` function of metrics/<metric>.py ('.' in a metric's
    name is '_' in its file's)."""
    return importlib.import_module("h100_bench.metrics." + metric.replace(".", "_")).read
