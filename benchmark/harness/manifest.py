"""BENCHMARK.json and the files it names: each configuration's file, each
traffic mix's file (`benchmark/traffic/<traffic>.json`), each per-layer
metric's reader (`benchmark/metrics/<metric>.py`) and each cell's limits of
`correct` (`benchmark/limits/<workload>.json`), all found by name."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, List


class Manifest:
    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.data = json.load(f)

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r}; have {[w['name'] for w in self.data['workloads']]}")

    def config_file(self, config: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == config:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no config {config!r}")

    def traffic(self, traffic: str) -> dict:
        with open(os.path.join(self.root, "benchmark", "traffic", traffic + ".json")) as f:
            return json.load(f)

    def end_to_end(self, workload: str) -> List[dict]:
        return [m for m in self.data["end_to_end"] if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> List[dict]:
        return [m for m in self.data["per_layer"] if workload in m.get("workloads", [workload])]

    def reader(self, metric: str) -> Callable[[dict], object]:
        """`read(run)` of `benchmark/metrics/<metric>.py`."""
        path = os.path.join(self.root, "benchmark", "metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location("benchmark_metric_" + metric.replace(".", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read
