"""Finds what a workload needs by the names that BENCHMARK.json gives.

Everything that belongs to one configuration, traffic mix, per-layer metric
or kernel lives in files of its own under the benchmark's folder, so that a
cell, a configuration or a metric is added as new files and entries only:

    configs/<config>.json          the configuration as it is run
    traffic/<traffic>.json         the traffic mix's parameters
    limits/<workload>.json         the numbers `correct` compares, each with
                                   its limit and the readings it came from
    entries/<entry>.py             the adapter to the program's entry point
                                   (named by the configuration's "entry")
    metrics/<metric>.py            a per-layer metric's reader: read(ctx)
    kernels/<kernel>.py            a kernel's name in the trace and its
                                   bytes and operations at a shape
"""

from __future__ import annotations

import importlib.util
import json
import os


class Registry:
    """BENCHMARK.json and the benchmark's files under one checkout root."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.dir = os.path.join(self.root, "benchmark")
        with open(os.path.join(self.root, "BENCHMARK.json")) as f:
            self.bench = json.load(f)

    def _json(self, *parts) -> dict:
        with open(os.path.join(self.dir, *parts)) as f:
            return json.load(f)

    def _module(self, kind: str, name: str):
        path = os.path.join(self.dir, kind, name + ".py")
        spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                rel = os.path.relpath(os.path.join(self.root, c["file"]), self.dir)
                return self._json(rel)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name + ".json")

    def limits(self, workload: str) -> dict:
        return self._json("limits", workload + ".json")

    def entry(self, name: str):
        return self._module("entries", name)

    def kernel(self, name: str):
        return self._module("kernels", name)

    def metric_reader(self, name: str):
        return self._module("metrics", name).read

    def end_to_end(self, workload: str) -> list:
        """The end-to-end metrics this workload reports."""
        return [m for m in self.bench["end_to_end"]
                if "workloads" not in m or workload in m["workloads"]]

    def per_layer(self, workload: str) -> list:
        """The per-layer metrics this workload reports: those that list it,
        and those without a list that move an end-to-end metric it reports."""
        e2e = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.bench["per_layer"]
                if (workload in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]
