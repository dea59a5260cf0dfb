"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix;
``configs[i].file`` is the configuration, ``benchmark/traffic/<mix>.json``
the mix, ``benchmark/metrics/<metric>.py`` each per-layer metric's reader.
Later cells and metrics are files and entries; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


class ManifestError(ValueError):
    pass


def _need(cond, msg):
    if not cond:
        raise ManifestError(msg)


class Manifest:
    def __init__(self, root: str, path: str | None = None):
        self.root = root
        self.bench_dir = os.path.join(root, "benchmark")
        with open(path or os.path.join(root, "BENCHMARK.json")) as f:
            self.data = json.load(f)
        d = self.data
        for key in ("configs", "workloads", "end_to_end", "per_layer"):
            for e in d[key]:
                _need(NAME.match(e["name"]), f"bad name {e['name']!r}")
        for m in d["end_to_end"] + d["per_layer"]:
            _need(UNIT.match(m["unit"]), f"bad unit {m['unit']!r}")
        self.configs = {c["name"]: c for c in d["configs"]}
        self.workloads = {w["name"]: w for w in d["workloads"]}
        self.metrics = {m["name"]: m for m in d["end_to_end"]
                        + d["per_layer"]}

    def workload(self, name: str) -> dict:
        _need(name in self.workloads,
              f"no workload {name!r} in the manifest")
        return self.workloads[name]

    def config(self, name: str) -> dict:
        _need(name in self.configs, f"no configuration {name!r}")
        with open(os.path.join(self.root, self.configs[name]["file"])) as f:
            cfg = json.load(f)
        cfg["name"] = name
        return cfg

    def traffic(self, name: str) -> dict:
        _need(NAME.match(name), f"bad traffic name {name!r}")
        path = os.path.join(self.bench_dir, "traffic", name + ".json")
        _need(os.path.exists(path), f"no traffic file for {name!r}")
        with open(path) as f:
            t = json.load(f)
        t["name"] = name
        return t

    def metric_names(self, workload: str, kind: str) -> list:
        """The metrics of ``kind`` ("end_to_end" or "per_layer") that the
        cell reports: those without ``workloads`` and those listing it."""
        return [m["name"] for m in self.data[kind]
                if "workloads" not in m or workload in m["workloads"]]

    def reader(self, metric: str):
        """The metric's reader module; its ``UNIT`` must be the
        manifest's."""
        _need(metric in self.metrics, f"no metric {metric!r}")
        path = os.path.join(self.bench_dir, "metrics", metric + ".py")
        _need(os.path.exists(path), f"no reader for {metric!r}")
        spec = importlib.util.spec_from_file_location(
            "bench_metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _need(getattr(mod, "UNIT", None) == self.metrics[metric]["unit"],
              f"reader of {metric!r} gives {getattr(mod, 'UNIT', None)!r}, "
              f"the manifest {self.metrics[metric]['unit']!r}")
        return mod
